"""The train steps (port of ``make_train_step`` and
``make_det_train_step``, vidar_tpu/train/step.py:62-157).

``TrainStep``, the pre-training step: one call runs the train forward of
``ViDAR`` (grid mask, frozen history, the current frame with gradient, the
gated rollout, the ray CE and dense chamfer losses), the backward pass and
the clipped AdamW update, and returns the step's metrics. ``DetTrainStep``,
the fine-tune step: the train forward of ``BEVFormer``, its
Hungarian-matched focal + L1 loss, the backward pass and the update.
``UniADTrainStep``, UniAD's end-to-end step (``make_uniad_train_step``,
step.py:160-223): the clip forward when the targets carry the clip fields,
else the single frame, the weighted multi-task loss, the backward pass and
the update.

Across processes (``vidar_tpu_torch.parallel``) each rank steps on its
local slice of the global batch, and the step computes what JAX's step
computes on the global batch: the losses divide by normalisers summed over
the ranks in the forward, so the gradients are SUMMED over the ranks after
the backward (a mean, as DistributedDataParallel takes, would divide them
by the world size once more), and so are the reported losses."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..device import resolve_device
from ..models.encoder import sca_overflow_count
from ..parallel.mesh import all_reduce_sum_, global_max, global_sum
from ..parallel.multihost import world_size


class _Step:
    """What both steps share: the model, its optimizer, the generator of
    its random draws, and the backward pass and update of a loss dict."""

    def __init__(self, model, optimizer, *,
                 generator: Optional[torch.Generator] = None, device='cuda'):
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.generator = generator

    def backward(self, total: torch.Tensor) -> None:
        """The step's backward pass (a method, so a profiler can time it)."""
        total.backward()

    def _sum_gradients(self) -> None:
        """Sum every parameter's gradient over the ranks, in place. A
        ``None`` gradient counts as zeros and stays ``None`` only where it
        is ``None`` on every rank, so every rank reduces the same list in
        the same order (no hang where a gated-off future leaves some
        parameters without a gradient)."""
        params = [p for grp in self.optimizer.param_groups
                  for p in grp['params']]
        has = global_sum(torch.tensor([p.grad is not None for p in params],
                                      dtype=torch.float32,
                                      device=self.device))
        live = [p for p, h in zip(params, has.tolist()) if h > 0]
        for p in live:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_sum_([p.grad for p in live])

    def _update(self, losses, total=None) -> Dict[str, float]:
        """Backward of ``total`` (the sum of ``losses`` where not given),
        the gradients summed over the ranks, and the clipped update ->
        every loss and ``loss`` (summed over the ranks: the global batch's)
        and ``grad_norm`` (of the summed gradients) as Python numbers."""
        if total is None:
            total = sum(losses.values())
        self.backward(total)
        values = dict(losses, loss=total)
        if world_size() > 1:
            self._sum_gradients()
            stacked = global_sum(torch.stack(
                [v.detach().float() for v in values.values()]))
            values = dict(zip(values, stacked.unbind()))
        grad_norm = self.optimizer.step()
        metrics = {k: float(v.detach()) for k, v in values.items()}
        metrics['grad_norm'] = float(grad_norm)
        return metrics


class TrainStep(_Step):
    """``step(batch) -> metrics``: every loss, ``loss`` (their sum),
    ``grad_norm`` (the global norm before clipping, as
    ``optax.global_norm(grads)``) and ``sca_overflow`` (visible queries the
    SCA capacity dropped anywhere in the batch, every rank's), as Python
    numbers.

    ``supervise_all_future`` False supervises one future frame, drawn from
    ``generator``, and rolls the others out without gradient (reference
    vidar.py:336-338). ``generator`` also draws the grid mask and the Gumbel
    noise of the dense loss, as the JAX step does (vidar_tpu/train/step.py:
    79-96). Dropout draws from PyTorch's default generator.

    ``gate_generator``, where given, draws the gate instead: JAX draws one
    gate for the global batch, so across processes it is seeded alike on
    every rank while ``generator`` is seeded per rank."""

    def __init__(self, model, optimizer, *, supervise_all_future: bool = True,
                 generator: Optional[torch.Generator] = None,
                 gate_generator: Optional[torch.Generator] = None,
                 device='cuda'):
        super().__init__(model, optimizer, generator=generator, device=device)
        self.supervise_all_future = supervise_all_future
        self.gate_generator = (generator if gate_generator is None
                               else gate_generator)

    def frame_gate(self):
        """The [num_future] 0/1 gate of the supervised rollout frames."""
        num_future = self.model.future_pred_frame_num
        if self.supervise_all_future or num_future == 0:
            return [1.0] * max(num_future, 1)
        gen = self.gate_generator
        gdev = gen.device if gen is not None else 'cpu'
        pick = int(torch.randint(0, num_future, (), generator=gen,
                                 device=gdev))
        return [float(i == pick) for i in range(num_future)]

    def __call__(self, batch) -> Dict[str, float]:
        m = self.model
        batch = batch.to(self.device)
        m.train()
        self.optimizer.zero_grad(set_to_none=True)
        losses = m(batch, generator=self.generator,
                   gumbel_generator=self.generator,
                   train_frame_gate=self.frame_gate())
        metrics = self._update(losses)
        # the worst (frame, camera) of the global batch, as in JAX
        metrics['sca_overflow'] = int(global_max(sca_overflow_count(
            batch.lidar2img, tuple(batch.images.shape[3:5]), m.bev_h,
            m.bev_w, m.pc_range, m.sca_capacity_ratio)))
        return metrics


class DetTrainStep(_Step):
    """``step(det_batch) -> metrics``: every loss of every decoder layer,
    ``loss`` (their sum) and ``grad_norm`` (the global norm before
    clipping), as Python numbers. ``generator`` draws the grid mask;
    dropout draws from PyTorch's default generator."""

    def __call__(self, batch) -> Dict[str, float]:
        m = self.model
        batch = batch.to(self.device)
        m.train()
        self.optimizer.zero_grad(set_to_none=True)
        preds = m(batch.frames, train=True, generator=self.generator)
        return self._update(m.loss(preds, batch.gt_bboxes, batch.gt_labels,
                                   batch.num_valid_gt))


class UniADTrainStep(_Step):
    """``step((frames, targets, command)) -> metrics``: every per-task
    loss, ``loss`` (their ``task_loss_weight``-weighted sum) and
    ``grad_norm``, as Python numbers. Targets with the clip fields
    (``track_boxes`` et al.) train the clip through ``UniAD.clip_forward``;
    without them the single frame. Dropout draws from PyTorch's default
    generator, and the step draws nothing else (UniAD has no grid mask or
    Gumbel noise), so it takes no generator. Across processes the UniAD
    losses divide by normalisers summed over the ranks (``uniad.loss``,
    ``UniAD.clip_forward``) and ``_update`` sums the gradients and the
    losses, as for the other steps."""

    def __init__(self, model, optimizer, *,
                 task_loss_weight: Optional[dict] = None, device='cuda'):
        super().__init__(model, optimizer, device=device)
        self.task_loss_weight = task_loss_weight

    def __call__(self, batch) -> Dict[str, float]:
        from ..uniad.clip_matcher import FrameGT
        from ..uniad.loss import uniad_clip_loss, uniad_loss
        m = self.model
        frames, targets, command = (x.to(self.device) for x in batch)
        m.train()
        self.optimizer.zero_grad(set_to_none=True)
        if targets.track_boxes is not None:
            gt = FrameGT(boxes=targets.track_boxes,
                         labels=targets.track_labels, ids=targets.track_ids,
                         num_valid=targets.track_num)
            track_losses, out, matched = m.clip_forward(
                frames, gt, targets.l2g_r, targets.l2g_t, targets.timestamp,
                command, deterministic=False, with_masks=True)
            total, losses = uniad_clip_loss(
                track_losses, out, targets, matched,
                task_loss_weight=self.task_loss_weight)
        else:
            bs = command.shape[0]
            _, prev_bev = m.init_stream(bs, self.device)
            out = m(frames, None, prev_bev,
                    torch.zeros(bs, dtype=torch.bool, device=self.device),
                    command, deterministic=False, with_masks=True)
            total, losses = uniad_loss(out, targets,
                                       task_loss_weight=self.task_loss_weight)
        return self._update(losses, total)
