"""Optimizer and learning-rate schedule of the reference recipe (port of
vidar_tpu/train/optim.py:22-147), and the layer-wise decay optimizer of
InternImage-style backbones.

Reference recipe (vidar_1_8_nusc_3future.py:379-396): AdamW, lr 2e-4,
weight decay 0.01, ``img_backbone`` lr x 0.1, gradient clipping to a global
L2 norm of 35, cosine annealing to lr x 1e-3 after a 500-step linear warmup
from lr / 3.

The update is optax's chain, step for step: clip by the global norm
(``g * 35 / norm`` above 35: optax's form, not ``clip_grad_norm_``'s
``norm + 1e-6``), Adam moments with bias correction, the decayed weights
added to the update, then the scheduled rate. The parameters are labelled
by name as the JAX package's ``label_fn`` labels their paths
(vidar_tpu/train/optim.py:57-66): ``backbone`` wherever the name holds
``img_backbone`` (UniAD's ``track.img_backbone`` too), ``frozen`` (no
update) where a module on the path is named ``bn*`` or ``downsample_bn``.
The frozen BatchNorms are buffers in the port, so they are in no group;
the one parameter that rule freezes is UniAD's occupancy-head
``bn_skip_proj`` GroupNorm, which the JAX package freezes by its name. A
parameter without a gradient counts as a zero
gradient, as in JAX: the stem and stage-1 weights under ``frozen_stages``
still decay (vidar_tpu/train/optim.py:57-66 labels them ``backbone``).
"""

from __future__ import annotations

import math
import re
from typing import Callable

import torch

from ..device import resolve_device


def cosine_annealing_schedule(base_lr: float, total_steps: int,
                              warmup_iters: int = 500,
                              warmup_ratio: float = 1.0 / 3,
                              min_lr_ratio: float = 1e-3) -> Callable:
    """mmcv's CosineAnnealingLrUpdaterHook with linear warmup: step -> lr."""
    min_lr = base_lr * min_lr_ratio

    def schedule(step: int) -> float:
        warm_frac = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
        warm_lr = base_lr * (warmup_ratio + (1 - warmup_ratio) * warm_frac)
        prog = min(max(step / max(total_steps, 1), 0.0), 1.0)
        cos_lr = min_lr + (base_lr - min_lr) * 0.5 * (1 + math.cos(math.pi *
                                                                   prog))
        return min(warm_lr, cos_lr) if step < warmup_iters else cos_lr

    return schedule


class AdamW(torch.optim.Optimizer):
    """optax's ``chain(clip_by_global_norm, scale_by_adam,
    add_decayed_weights, scale_by_learning_rate(schedule * lr_mult))``.

    Each param group carries ``lr_mult``; ``schedule`` maps the step count
    (0 at the first update) to the base rate. ``step()`` returns the global
    gradient norm before clipping."""

    def __init__(self, param_groups, schedule: Callable, *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01, grad_clip_norm: float = 35.0):
        super().__init__(param_groups, dict(lr_mult=1.0))
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        params = [p for grp in self.param_groups for p in grp['params']]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
        # optax: g / norm * max_norm when norm >= max_norm
        clip = torch.where(norm < self.grad_clip_norm,
                           torch.ones_like(norm),
                           self.grad_clip_norm / norm)
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        i = 0
        for grp in self.param_groups:
            for p in grp['params']:
                g = grads[i] * clip.to(grads[i].device)
                i += 1
                st = self.state[p]
                if not st:
                    st['mu'] = torch.zeros_like(p)
                    st['nu'] = torch.zeros_like(p)
                mu, nu = st['mu'], st['nu']
                mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
                upd.add_(p, alpha=self.weight_decay)
                p.add_(upd, alpha=-lr * grp['lr_mult'])
        return norm


def make_optimizer(model: torch.nn.Module, *, base_lr: float = 2e-4,
                   weight_decay: float = 0.01, backbone_lr_mult: float = 0.1,
                   grad_clip_norm: float = 35.0, total_steps: int = 100_000,
                   warmup_iters: int = 500, device='cuda') -> AdamW:
    """AdamW over ``model``'s parameters in three groups, ``main``,
    ``backbone`` (lr x ``backbone_lr_mult``) and ``frozen`` (no update),
    labelled as the module docstring says. The
    parameters must lie on ``device`` (the card unless the caller asks for
    the CPU)."""
    device = resolve_device(device)
    main, backbone, frozen = [], [], []
    for name, p in model.named_parameters():
        if p.device.type != device.type:
            raise ValueError(f'make_optimizer: {name} is on {p.device}, '
                             f'not {device}')
        path = name.split('.')[:-1]
        if any(m.startswith('bn') or m == 'downsample_bn' for m in path):
            frozen.append(p)
        elif 'img_backbone' in name:
            backbone.append(p)
        else:
            main.append(p)
    sched = cosine_annealing_schedule(base_lr, total_steps, warmup_iters)
    groups = [dict(params=main, lr_mult=1.0),
              dict(params=backbone, lr_mult=backbone_lr_mult)]
    if frozen:
        # its gradients count in the clipped norm, as in optax
        groups.append(dict(params=frozen, lr_mult=0.0))
    return AdamW(groups, sched, weight_decay=weight_decay,
                 grad_clip_norm=grad_clip_norm)


def layer_decay_lr_mult(path: str, *, depths, decay_rate: float) -> float:
    """InternImage/Swin layer-wise lr decay (vidar_tpu/train/optim.py:
    87-110, reference custom_layer_decay_optimizer_constructor.py:18-105):
    the stem and patch embedding get layer 0, block j of stage i layer
    1 + sum(depths[:i]) + j, anything else (the head) the last layer; the
    multiplier is decay_rate ** (num_layers - layer_id - 1). ``path`` is a
    parameter's name, dotted or slashed."""
    path = path.replace('.', '/')
    num_layers = sum(depths) + 2
    layer_id = num_layers - 1
    if 'patch_embed' in path or 'stem' in path:
        layer_id = 0
    elif 'levels_' in path or '/levels/' in path:
        m = re.search(r'levels[_/](\d+).*?blocks[_/](\d+)', path)
        if m:
            stage, blk = int(m.group(1)), int(m.group(2))
            layer_id = 1 + sum(depths[:stage]) + blk
        else:
            m = re.search(r'levels[_/](\d+)', path)
            if m:
                layer_id = sum(depths[:int(m.group(1)) + 1])
    return decay_rate ** (num_layers - layer_id - 1)


def make_layer_decay_optimizer(model: torch.nn.Module, *,
                               base_lr: float = 2e-4,
                               weight_decay: float = 0.05,
                               depths=(4, 4, 18, 4),
                               decay_rate: float = 0.94,
                               grad_clip_norm: float = 35.0,
                               total_steps: int = 100_000,
                               warmup_iters: int = 500,
                               device='cuda') -> AdamW:
    """AdamW with per-depth lr decay for InternImage-style backbones
    (vidar_tpu/train/optim.py:113-147): one group per multiplier,
    ``layer_decay_lr_mult`` of the name for a parameter under
    ``img_backbone``, 1.0 for any other; the global-norm clip before the
    update; no frozen group. The parameters must lie on ``device`` (the
    card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    groups = {}
    for name, p in model.named_parameters():
        if p.device.type != device.type:
            raise ValueError(f'make_layer_decay_optimizer: {name} is on '
                             f'{p.device}, not {device}')
        mult = (round(layer_decay_lr_mult(name, depths=depths,
                                          decay_rate=decay_rate), 12)
                if 'img_backbone' in name else 1.0)
        groups.setdefault(mult, []).append(p)
    sched = cosine_annealing_schedule(base_lr, total_steps, warmup_iters)
    return AdamW([dict(params=ps, lr_mult=m) for m, ps in groups.items()],
                 sched, weight_decay=weight_decay,
                 grad_clip_norm=grad_clip_norm)
