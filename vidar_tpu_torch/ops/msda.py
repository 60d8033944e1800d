"""Multi-scale deformable attention (port of vidar_tpu/ops/msda.py).

``msdeform_attn`` is the one primitive under temporal self-attention,
spatial cross-attention and the future decoder. On a CUDA tensor it
launches the hand-written kernel K1 (``csrc/msda.cu``); on a CPU tensor it
runs ``msdeform_attn_plain``, the same function in plain PyTorch.

Semantics are mmcv's ``multi_scale_deformable_attn``: sampling locations in
[0, 1], bilinear sampling with ``align_corners=False`` and zero padding,
the attention weights already softmaxed over levels x points.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ._build import KernelCounter, check, load_library, stream_of
from .gather import bilinear_corners

KERNEL = KernelCounter(
    'msda_forward', source='vidar_tpu_torch/csrc/msda.cu',
    replaces='vidar_tpu/ops/msda_pallas.py:223 (msda_gather_fused), '
             ':356 (msda_gather_fused16)')

_level_tables = {}


def _msda_block(value, spatial_shapes, loc, weights):
    b, qb, heads, _, p, _ = loc.shape
    dim = value.shape[-1]
    out = torch.zeros(b, heads, qb, dim, dtype=torch.float32,
                      device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].permute(0, 2, 1, 3).reshape(
            b * heads, h * w, dim)
        start += h * w
        lo = loc[:, :, :, lvl].float()                  # [b, qb, heads, p, 2]
        x = (lo[..., 0] * w - 0.5).permute(0, 2, 1, 3).reshape(b * heads, -1)
        y = (lo[..., 1] * h - 0.5).permute(0, 2, 1, 3).reshape(b * heads, -1)
        samp = None
        for idx, wgt in bilinear_corners(x, y, h, w):
            g = torch.gather(v, 1, idx[..., None].expand(-1, -1, dim))
            term = g.float() * wgt[..., None]
            samp = term if samp is None else samp + term
        samp = samp.reshape(b, heads, qb, p, dim)
        aw = weights[:, :, :, lvl].float().permute(0, 2, 1, 3)
        out = out + (samp * aw[..., None]).sum(3)
    return out.permute(0, 2, 1, 3).reshape(b, qb, heads * dim)


def msdeform_attn_plain(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor,
                        query_chunk: int = 4096) -> torch.Tensor:
    """Plain PyTorch version of K1: value [B, V, heads, dim], locations
    [B, Q, heads, L, P, 2], weights [B, Q, heads, L, P] -> [B, Q,
    heads*dim] f32. Queries go in chunks to bound the gathered corners."""
    q = sampling_locations.shape[1]
    outs = [_msda_block(value, spatial_shapes,
                        sampling_locations[:, q0:q0 + query_chunk],
                        attention_weights[:, q0:q0 + query_chunk])
            for q0 in range(0, q, query_chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _tables(spatial_shapes, device):
    key = (tuple(spatial_shapes), str(device))
    if key not in _level_tables:
        shapes = torch.tensor(spatial_shapes, dtype=torch.int32)
        starts = torch.zeros(len(spatial_shapes), dtype=torch.int32)
        starts[1:] = torch.cumsum(shapes[:, 0] * shapes[:, 1], 0)[:-1]
        _level_tables[key] = (shapes.to(device), starts.to(device))
    return _level_tables[key]


def msda_forward_cuda(value: torch.Tensor,
                      spatial_shapes: Sequence[Tuple[int, int]],
                      loc: torch.Tensor, weights: torch.Tensor
                      ) -> torch.Tensor:
    """Launch K1. value [B, V, heads, dim<=32] bf16 or f32, loc
    [B, Q, heads, L, P, 2] f32, weights [B, Q, heads, L, P] f32, all
    contiguous on one CUDA device -> [B, Q, heads*dim] f32."""
    if not (value.is_cuda and loc.device == value.device ==
            weights.device):
        raise ValueError('msda_forward: all inputs must be on one CUDA device')
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'msda_forward: value dtype {value.dtype}')
    if loc.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError('msda_forward: loc and weights must be float32')
    if value.dim() != 4 or loc.dim() != 6 or weights.dim() != 5:
        raise ValueError('msda_forward: bad ranks')
    b, v_len, heads, dim = value.shape
    _, q, _, num_levels, p, _ = loc.shape
    if (loc.shape != (b, q, heads, num_levels, p, 2) or
            weights.shape != loc.shape[:5] or dim > 32 or
            len(spatial_shapes) != num_levels or
            sum(h * w for h, w in spatial_shapes) != v_len):
        raise ValueError(
            f'msda_forward: shapes value {tuple(value.shape)}, loc '
            f'{tuple(loc.shape)}, weights {tuple(weights.shape)}, levels '
            f'{list(spatial_shapes)}')
    if not (value.is_contiguous() and loc.is_contiguous() and
            weights.is_contiguous()):
        raise ValueError('msda_forward: inputs must be contiguous')
    shapes_t, starts_t = _tables(spatial_shapes, value.device)
    out = torch.empty(b, q, heads * dim, dtype=torch.float32,
                      device=value.device)
    lib = load_library()
    with torch.cuda.device(value.device):
        rc = lib.msda_forward(
            value.data_ptr(), int(value.dtype == torch.bfloat16),
            shapes_t.data_ptr(), starts_t.data_ptr(), loc.data_ptr(),
            weights.data_ptr(), out.data_ptr(), b, v_len, q, heads, dim,
            num_levels, p, stream_of(value))
    check(rc, 'msda_forward')
    KERNEL.launched(value=value, spatial_shapes=list(spatial_shapes),
                    loc=loc, weights=weights)
    return out


def msdeform_attn(value: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  sampling_locations: torch.Tensor,
                  attention_weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention -> [B, Q, heads*dim] f32: K1 for
    CUDA tensors, the plain version for CPU tensors."""
    if value.device.type == 'cpu':
        return msdeform_attn_plain(value, spatial_shapes, sampling_locations,
                                   attention_weights)
    return msda_forward_cuda(value.contiguous(), spatial_shapes,
                             sampling_locations.float().contiguous(),
                             attention_weights.float().contiguous())
