"""Checkpoints of the port (the torch form of vidar_tpu/core/checkpoint.py),
and the import of the reference's ``.pth`` files.

A checkpoint is a directory:

* ``model.pt``: the model's state dict (parameters and buffers), on the CPU;
* ``optimizer.pt``: the optimizer's state dict (Adam moments, parameter
  groups) and its update count, which is the schedule's position;
* ``meta.json``: the train step.

``save_checkpoint`` writes one (the optimizer is optional: an EMA or a
converted weight set has none); ``load_checkpoint`` restores all of it for
``--resume-from``; ``load_params_partial`` copies every tensor whose name
and shape the model shares (mmcv's ``load_state_dict(strict=False)``), for
pre-train -> fine-tune and for the test CLI.

``import_torch_checkpoint`` grafts a reference ``.pth`` (the FCOS3D
backbone init ``r101_dcn_fcos3d_pretrain.pth``, a full ViDAR or a fine-tune
checkpoint) into a model: the port's copy of the JAX package's numpy key
mapping (vidar_tpu/core/checkpoint.py:93-446) gives the flax-layout tree,
``convert.state_dict_from_jax`` the port's names and layouts, and every
tensor whose name and shape the model has is copied.

Key mapping rules (reference state dict -> flax layout):
  * Linear: weight [out, in] -> kernel [in, out]; bias unchanged.
  * Conv2d: weight [out, in, kh, kw] -> kernel [kh, kw, in, out].
  * Frozen BN (weight, bias, running_mean, running_var) -> (scale, bias):
    scale = gamma / sqrt(var + eps); bias = beta - mean * scale.
  * DCNv2: conv_offset like Conv2d; the weight [out, in, 3, 3] -> a
    [9 * in, out] matrix, tap-major (ky, kx).
  * Module lists ``layers.N.*`` -> ``layers_N/*``, attentions, norms and
    ffns alike; nn.MultiheadAttention's ``in_proj`` splits into q, k, v.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.multihost import barrier, is_main

MODEL_FILE = 'model.pt'
OPTIMIZER_FILE = 'optimizer.pt'
META_FILE = 'meta.json'


def _check_dir(path: str) -> None:
    if path.endswith('.pth'):
        raise ValueError(
            f'{path}: a reference .pth is not a checkpoint directory; '
            f'import it with import_torch_checkpoint')
    if not os.path.isfile(os.path.join(path, MODEL_FILE)):
        raise FileNotFoundError(f'{path}: no {MODEL_FILE} (not a checkpoint '
                                f'directory of vidar_tpu_torch)')


def save_checkpoint(path: str, state: Mapping) -> None:
    """Write ``state`` to the directory ``path`` (replaced whole):
    ``state['model']`` a module or a state dict, ``state['optimizer']`` the
    port's ``AdamW`` or None, ``state['step']`` an int. Across processes
    every rank calls it: rank 0 writes (the replicas are equal), and every
    rank returns once the directory is complete."""
    if is_main():
        _write_checkpoint(path, state)
    barrier()


def _write_checkpoint(path: str, state: Mapping) -> None:
    model = state['model']
    sd = model.state_dict() if hasattr(model, 'state_dict') else model
    tmp = f'{os.path.abspath(path)}.tmp{os.getpid()}'
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({k: v.detach().cpu() for k, v in sd.items()},
               os.path.join(tmp, MODEL_FILE))
    opt = state.get('optimizer')
    if opt is not None:
        torch.save({'state_dict': opt.state_dict(), 'count': opt.count},
                   os.path.join(tmp, OPTIMIZER_FILE))
    with open(os.path.join(tmp, META_FILE), 'w') as f:
        json.dump({'step': int(state.get('step', 0))}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer=None) -> int:
    """Restore ``model`` (strict), and ``optimizer``'s moments and schedule
    position where given, from the directory ``path`` -> the train step."""
    _check_dir(path)
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(os.path.join(path, MODEL_FILE),
                                     map_location=device), strict=True)
    if optimizer is not None:
        opt = torch.load(os.path.join(path, OPTIMIZER_FILE),
                         map_location=device)
        optimizer.load_state_dict(opt['state_dict'])
        optimizer.count = int(opt['count'])
    with open(os.path.join(path, META_FILE)) as f:
        return int(json.load(f)['step'])


def load_params_partial(path: str, model: torch.nn.Module
                        ) -> Tuple[int, int]:
    """Copy into ``model`` every tensor of the checkpoint at ``path`` whose
    name and shape the model's state dict shares; the rest of the model
    keeps its values -> (tensors loaded, tensors kept)."""
    _check_dir(path)
    src: Dict[str, torch.Tensor] = torch.load(
        os.path.join(path, MODEL_FILE), map_location='cpu')
    loaded = kept = 0
    with torch.no_grad():
        for name, t in model.state_dict().items():
            s: Optional[torch.Tensor] = src.get(name)
            if s is not None and tuple(s.shape) == tuple(t.shape):
                t.copy_(s.to(t.dtype))
                loaded += 1
            else:
                kept += 1
    return loaded, kept


# ------------------------------------------------------------ torch import
# The numpy mapping below is the JAX package's (vidar_tpu/core/checkpoint.py:
# 93-446), kept here so that the port imports nothing of it.

BN_EPS = 1e-5


def _fold_bn(sd: Mapping[str, np.ndarray], prefix: str):
    gamma = np.asarray(sd[f'{prefix}.weight'], np.float32)
    beta = np.asarray(sd[f'{prefix}.bias'], np.float32)
    mean = np.asarray(sd[f'{prefix}.running_mean'], np.float32)
    var = np.asarray(sd[f'{prefix}.running_var'], np.float32)
    scale = gamma / np.sqrt(var + BN_EPS)
    bias = beta - mean * scale
    return scale, bias


def _conv_w(sd, key):
    # [out, in, kh, kw] -> [kh, kw, in, out]
    return np.asarray(sd[key], np.float32).transpose(2, 3, 1, 0)


def _dcn_w(sd, key):
    # [out, in, 3, 3] -> [(ky kx in), out], tap-major as DeformConv2d takes
    w = np.asarray(sd[key], np.float32).transpose(2, 3, 1, 0)
    return w.reshape(-1, w.shape[-1])


def _linear_w(sd, key):
    return np.asarray(sd[key], np.float32).T


def import_torch_backbone(sd: Mapping[str, np.ndarray], depth: int = 101,
                          stage_with_dcn=(False, False, True, True),
                          prefix: str = 'img_backbone.') -> Dict[str, Any]:
    """A torch ResNet state dict -> the ResNet's flax-layout tree."""
    from ..models.resnet import ARCH_SETTINGS
    p: Dict[str, Any] = {'conv1': {'kernel': _conv_w(sd, f'{prefix}conv1.'
                                                         f'weight')}}
    s, b = _fold_bn(sd, f'{prefix}bn1')
    p['bn1'] = {'scale': s, 'bias': b}
    for stage, num_blocks in enumerate(ARCH_SETTINGS[depth]):
        for i in range(num_blocks):
            src = f'{prefix}layer{stage + 1}.{i}'
            blk: Dict[str, Any] = {
                'conv1': {'kernel': _conv_w(sd, f'{src}.conv1.weight')}}
            if stage_with_dcn[stage]:
                blk['conv2'] = {
                    'kernel': _dcn_w(sd, f'{src}.conv2.weight'),
                    'conv_offset': {
                        'kernel': _conv_w(sd,
                                          f'{src}.conv2.conv_offset.weight'),
                        'bias': np.asarray(
                            sd[f'{src}.conv2.conv_offset.bias'], np.float32),
                    },
                }
            else:
                blk['conv2'] = {'kernel': _conv_w(sd, f'{src}.conv2.weight')}
            blk['conv3'] = {'kernel': _conv_w(sd, f'{src}.conv3.weight')}
            for bn in ('bn1', 'bn2', 'bn3'):
                s, b = _fold_bn(sd, f'{src}.{bn}')
                blk[bn] = {'scale': s, 'bias': b}
            if f'{src}.downsample.0.weight' in sd:
                blk['downsample_conv'] = {
                    'kernel': _conv_w(sd, f'{src}.downsample.0.weight')}
                s, b = _fold_bn(sd, f'{src}.downsample.1')
                blk['downsample_bn'] = {'scale': s, 'bias': b}
            p[f'layer{stage + 1}_{i}'] = blk
    return p


def _map_linear(sd, src, dst: Dict[str, Any], key: str = 'linear'):
    if f'{src}.weight' not in sd:
        return
    dst[key] = {'kernel': _linear_w(sd, f'{src}.weight'),
                'bias': np.asarray(sd[f'{src}.bias'], np.float32)}


def _map_dense(sd, src, dst: Dict[str, Any], name: str):
    if f'{src}.weight' in sd:
        dst[name] = {'kernel': _linear_w(sd, f'{src}.weight'),
                     'bias': np.asarray(sd[f'{src}.bias'], np.float32)}


def _map_ln(sd, src, dst: Dict[str, Any], name: str):
    if f'{src}.weight' in sd:
        dst[name] = {'scale': np.asarray(sd[f'{src}.weight'], np.float32),
                     'bias': np.asarray(sd[f'{src}.bias'], np.float32)}


def _map_can_bus_mlp(sd, src) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    _map_linear(sd, f'{src}.0', out.setdefault('fc0', {}))
    _map_linear(sd, f'{src}.2', out.setdefault('fc1', {}))
    _map_ln(sd, f'{src}.norm', out, 'norm')
    return out


def _map_ffn(sd, src) -> Dict[str, Any]:
    # mmcv FFN: layers.0.0 = fc1, layers.1 = fc2
    out: Dict[str, Any] = {}
    _map_linear(sd, f'{src}.layers.0.0', out.setdefault('fc1', {}))
    _map_linear(sd, f'{src}.layers.1', out.setdefault('fc2', {}))
    return out


def _map_deform_proj(sd, src) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name in ('sampling_offsets', 'attention_weights', 'value_proj'):
        _map_dense(sd, f'{src}.{name}', out, name)
    return out


def _map_latent_render(sd, src) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    # assumes num_pred_fcs=0, as the JAX import does (vidar_tpu/core/
    # checkpoint.py:210): unsup_raymarching_head.0 is the occupancy Linear;
    # a model with occ_fc{i} / occ_ln{i} keeps them from its init
    _map_linear(sd, f'{src}.unsup_raymarching_head.0',
                out.setdefault('occ_head', {}))
    _map_linear(sd, f'{src}.lora_a', out.setdefault('lora_a', {}))
    _map_linear(sd, f'{src}.lora_b', out.setdefault('lora_b', {}))
    return out


def _map_norms_ffn(sd, src, out: Dict[str, Any], with_latent: bool):
    for i in range(3):
        _map_ln(sd, f'{src}.norms.{i}', out, f'norms_{i}')
    out['ffns_0'] = _map_ffn(sd, f'{src}.ffns.0')
    if with_latent and f'{src}.latent_render.lora_a.weight' in sd:
        out['latent_render'] = _map_latent_render(sd, f'{src}.latent_render')


def _map_encoder_layer(sd, src, with_latent: bool) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    tsa = {'proj': _map_deform_proj(sd, f'{src}.attentions.0')}
    _map_dense(sd, f'{src}.attentions.0.output_proj', tsa, 'output_proj')
    out['attentions_0'] = tsa
    sca = {'deformable_attention': _map_deform_proj(
        sd, f'{src}.attentions.1.deformable_attention')}
    _map_dense(sd, f'{src}.attentions.1.output_proj', sca, 'output_proj')
    out['attentions_1'] = sca
    _map_norms_ffn(sd, src, out, with_latent)
    return out


def _map_decoder_layer(sd, src, with_latent: bool) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for ai in (0, 1):
        attn = {'proj': _map_deform_proj(sd, f'{src}.attentions.{ai}')}
        _map_dense(sd, f'{src}.attentions.{ai}.output_proj', attn,
                   'output_proj')
        out[f'attentions_{ai}'] = attn
    _map_norms_ffn(sd, src, out, with_latent)
    return out


def _map_pos_encoding(sd, src) -> Dict[str, Any]:
    if f'{src}.row_embed.weight' not in sd:
        return {}
    return {'row_embed': np.asarray(sd[f'{src}.row_embed.weight'],
                                    np.float32),
            'col_embed': np.asarray(sd[f'{src}.col_embed.weight'],
                                    np.float32)}


def _map_fpn(sd, prefix='img_neck.') -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for kind in ('lateral_convs', 'fpn_convs'):
        i = 0
        while f'{prefix}{kind}.{i}.conv.weight' in sd:
            out[f'{kind}_{i}'] = {
                'kernel': _conv_w(sd, f'{prefix}{kind}.{i}.conv.weight'),
                'bias': np.asarray(sd[f'{prefix}{kind}.{i}.conv.bias'],
                                   np.float32)}
            i += 1
    return out


def _map_mha(sd, src, num_heads: int = 8) -> Dict[str, Any]:
    """torch nn.MultiheadAttention -> flax MultiHeadDotProductAttention:
    in_proj_weight [3C, C] splits into q, k, v kernels [C, heads,
    head_dim]; the out kernel is [heads, head_dim, C]."""
    if f'{src}.attn.in_proj_weight' not in sd:
        return {}
    w = np.asarray(sd[f'{src}.attn.in_proj_weight'], np.float32)
    b = np.asarray(sd[f'{src}.attn.in_proj_bias'], np.float32)
    c = w.shape[1]
    hd = c // num_heads
    out: Dict[str, Any] = {}
    for i, name in enumerate(('query', 'key', 'value')):
        out[name] = {
            'kernel': w[i * c:(i + 1) * c].T.reshape(c, num_heads, hd),
            'bias': b[i * c:(i + 1) * c].reshape(num_heads, hd)}
    ow = np.asarray(sd[f'{src}.attn.out_proj.weight'], np.float32)
    ob = np.asarray(sd[f'{src}.attn.out_proj.bias'], np.float32)
    out['out'] = {'kernel': ow.T.reshape(num_heads, hd, c), 'bias': ob}
    return out


def _map_det_decoder_layer(sd, src) -> Dict[str, Any]:
    """A DetectionTransformerDecoder layer: MHA self-attention, then
    CustomMSDeformableAttention cross-attention."""
    out: Dict[str, Any] = {}
    mha = _map_mha(sd, f'{src}.attentions.0')
    if mha:
        out['self_attn'] = mha
    cross: Dict[str, Any] = {'proj': _map_deform_proj(
        sd, f'{src}.attentions.1')}
    _map_dense(sd, f'{src}.attentions.1.output_proj', cross, 'output_proj')
    out['cross_attn'] = cross
    _map_norms_ffn(sd, src, out, with_latent=False)
    return out


def map_det_head_state_dict(sd: Mapping[str, np.ndarray], *,
                            num_decoder_layers: int = 6,
                            num_reg_fcs: int = 2,
                            prefix: str = 'pts_bbox_head.'
                            ) -> Dict[str, Any]:
    """The fine-tune ``BEVFormerHead`` (a DETR head) -> the
    ``pts_bbox_head_det`` subtree: cls branch = [Linear, LN, ReLU] x
    num_reg_fcs + Linear; reg branch = [Linear, ReLU] x num_reg_fcs +
    Linear."""
    out: Dict[str, Any] = {}
    if f'{prefix}query_embedding.weight' not in sd:
        return out
    out['query_embedding'] = np.asarray(
        sd[f'{prefix}query_embedding.weight'], np.float32)
    _map_dense(sd, f'{prefix}transformer.reference_points', out,
               'reference_points')
    for lid in range(num_decoder_layers):
        layer = _map_det_decoder_layer(
            sd, f'{prefix}transformer.decoder.layers.{lid}')
        if layer:
            out[f'layers_{lid}'] = layer
        # cls Sequential: Linear at 3k, LN at 3k + 1; the last at 3n
        for i in range(num_reg_fcs):
            _map_linear(sd, f'{prefix}cls_branches.{lid}.{3 * i}',
                        out.setdefault(f'cls_branches_{lid}_fc{i}', {}))
            _map_ln(sd, f'{prefix}cls_branches.{lid}.{3 * i + 1}', out,
                    f'cls_branches_{lid}_ln{i}')
        _map_linear(sd, f'{prefix}cls_branches.{lid}.{3 * num_reg_fcs}',
                    out.setdefault(f'cls_branches_{lid}_out', {}))
        # reg Sequential: Linear at 2k; the last at 2n
        for i in range(num_reg_fcs):
            _map_linear(sd, f'{prefix}reg_branches.{lid}.{2 * i}',
                        out.setdefault(f'reg_branches_{lid}_fc{i}', {}))
        _map_linear(sd, f'{prefix}reg_branches.{lid}.{2 * num_reg_fcs}',
                    out.setdefault(f'reg_branches_{lid}_out', {}))
    return {k: v for k, v in out.items()
            if not (isinstance(v, dict) and not v)}


class RecordingDict(dict):
    """A state dict that records which keys were read: ``unconsumed()``
    lists the reference tensors no mapping rule touched."""

    def __init__(self, data):
        super().__init__(data)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)

    def unconsumed(self, ignore_suffixes=('num_batches_tracked',)):
        return sorted(k for k in self if k not in self.read and
                      not any(k.endswith(s) for s in ignore_suffixes))


def map_vidar_state_dict(sd: Mapping[str, np.ndarray], *,
                         depth: int = 101,
                         stage_with_dcn=(False, False, True, True),
                         encoder_layers: int = 6,
                         decoder_layers: int = 3) -> Dict[str, Any]:
    """A reference ViDAR (or fine-tune) state dict -> the flax-layout tree
    (nested dicts of numpy arrays)."""
    out: Dict[str, Any] = {}
    if any(k.startswith('img_backbone.') for k in sd):
        out['img_backbone'] = import_torch_backbone(
            sd, depth=depth, stage_with_dcn=stage_with_dcn)
    if any(k.startswith('img_neck.') for k in sd):
        out['img_neck'] = _map_fpn(sd)

    if 'pts_bbox_head.bev_embedding.weight' in sd:
        head: Dict[str, Any] = {
            'bev_embedding': np.asarray(
                sd['pts_bbox_head.bev_embedding.weight'], np.float32),
            'positional_encoding': _map_pos_encoding(
                sd, 'pts_bbox_head.positional_encoding'),
        }
        tr: Dict[str, Any] = {}
        if 'pts_bbox_head.transformer.level_embeds' in sd:
            tr['level_embeds'] = np.asarray(
                sd['pts_bbox_head.transformer.level_embeds'], np.float32)
            tr['cams_embeds'] = np.asarray(
                sd['pts_bbox_head.transformer.cams_embeds'], np.float32)
        tr['can_bus_mlp'] = _map_can_bus_mlp(
            sd, 'pts_bbox_head.transformer.can_bus_mlp')
        tr['encoder'] = {
            f'layers_{lid}': _map_encoder_layer(
                sd, f'pts_bbox_head.transformer.encoder.layers.{lid}',
                with_latent=True)
            for lid in range(encoder_layers)}
        head['transformer'] = tr
        out['pts_bbox_head'] = head

    if 'future_pred_head.bev_embedding.weight' in sd:
        fh: Dict[str, Any] = {
            'bev_embedding': np.asarray(
                sd['future_pred_head.bev_embedding.weight'], np.float32),
            'prev_frame_embedding': np.asarray(
                sd['future_pred_head.prev_frame_embedding'], np.float32),
            'positional_encoding': _map_pos_encoding(
                sd, 'future_pred_head.positional_encoding'),
            'can_bus_mlp': _map_can_bus_mlp(
                sd, 'future_pred_head.can_bus_mlp'),
        }
        fh['transformer'] = {
            f'layers_{lid}': _map_decoder_layer(
                sd, f'future_pred_head.transformer.decoder.layers.{lid}',
                with_latent=True)
            for lid in range(decoder_layers)}
        for lvl in range(decoder_layers):
            _map_linear(sd, f'future_pred_head.bev_pred_head.{lvl}.0',
                        fh.setdefault(f'bev_pred_head_{lvl}_out', {}))
        out['future_pred_head'] = fh

    det = map_det_head_state_dict(sd)
    if det:
        out['pts_bbox_head_det'] = det
    if 'pts_bbox_head' in out:
        # the fine-tune model names its encoder head pts_bbox_head_bev (the
        # reference shares one pts_bbox_head module; the graft skips
        # whichever alias the model lacks)
        out['pts_bbox_head_bev'] = out['pts_bbox_head']
    return out


class TorchImport(NamedTuple):
    """What ``import_torch_checkpoint`` did: the model's tensors it set,
    those whose shape differed from the reference's, and the reference
    tensors no mapping rule read."""
    matched: List[str]
    shape_mismatch: List[str]
    unmapped: List[str]

    def summary(self) -> str:
        return (f'{len(self.matched)} tensors grafted, '
                f'{len(self.shape_mismatch)} shape mismatches, '
                f'{len(self.unmapped)} reference tensors unmapped')


def import_torch_checkpoint(pth_path: str, model: torch.nn.Module, *,
                            depth: int = 101,
                            stage_with_dcn=(False, False, True, True),
                            report: bool = True) -> TorchImport:
    """Graft a reference ``.pth`` into ``model`` (in place): each mapped
    tensor whose name and shape the model's state dict has is copied; the
    rest of the model keeps its values. A file whose keys start with
    ``backbone.`` and none with ``img_backbone.`` (the FCOS3D init) is read
    as the image backbone. ``depth`` and ``stage_with_dcn`` name the
    reference backbone, as the JAX package's CLIs pass them (R101, DCN in
    stages 3-4). Prints the three counts where ``report``."""
    from ..convert import state_dict_from_jax
    ckpt = torch.load(pth_path, map_location='cpu', weights_only=False)
    sd = ckpt.get('state_dict', ckpt)
    sd = {k: v.numpy() if hasattr(v, 'numpy') else v for k, v in sd.items()}
    if not any(k.startswith('img_backbone.') for k in sd) and any(
            k.startswith('backbone.') for k in sd):
        sd = {('img_backbone.' + k[len('backbone.'):]
               if k.startswith('backbone.') else k): v for k, v in sd.items()}
    sd = RecordingDict(sd)
    mapped = state_dict_from_jax(map_vidar_state_dict(
        sd, depth=depth, stage_with_dcn=stage_with_dcn))
    matched, mismatch = [], []
    target = model.state_dict()
    with torch.no_grad():
        for name, t in mapped.items():
            dst = target.get(name)
            if dst is None:
                continue
            if tuple(dst.shape) == tuple(t.shape):
                dst.copy_(t.to(dst.dtype))
                matched.append(name)
            else:
                mismatch.append(name)
                if report:
                    print(f'shape mismatch at {name}: {tuple(dst.shape)} vs '
                          f'{tuple(t.shape)}')
    result = TorchImport(matched, mismatch, sd.unconsumed())
    if report:
        print(f'torch import {pth_path}: {result.summary()}', flush=True)
        for k in result.unmapped[:20]:
            print(f'  unmapped: {k}')
    return result
