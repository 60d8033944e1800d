"""DCNv3, InternImage's deformable convolution v3 (port of
vidar_tpu/ops/dcnv3.py; reference backbones/ops_dcnv3/).

Each of G groups samples K = kh * kw points per output pixel at learned
offsets, with modulation masks softmaxed over the K points of the group,
and sums its channels:

  out[b, p, g] = sum_k softmax(mask)[b, p, g, k] * bilinear(x_g, p0_k + off_k)

with zero-padded bilinear sampling at pixel coordinates (pixel centres at
integers). That is one-level multi-scale deformable attention with G heads
and K points at ``loc = (pixel + 0.5) / size``, so on a CUDA tensor
``dcnv3_core`` runs ``dcnv3_core_msda``: the hand-written K1 forward and K5
backward of ``ops/msda.py``. On a CPU tensor it runs ``dcnv3_core_plain``,
the JAX formula as a direct gather. Both routes take every stride,
dilation and border: bilinear sampling with zero padding is continuous, so
the two agree to the f32 rounding of the (pixel + 0.5) / size round trip.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .gather import bilinear_corners
from .msda import msdeform_attn


def _sample_points(offset, mask, kernel, stride, dilation, groups):
    """-> (sx, sy [B, Ho*Wo, G, K] pixel coordinates, softmaxed masks
    [B, Ho*Wo, G, K]), all f32."""
    b, ho, wo, _ = offset.shape
    kh, kw = kernel
    k = kh * kw
    dev = offset.device
    off = offset.reshape(b, ho, wo, groups, k, 2).float()
    m = torch.softmax(mask.reshape(b, ho, wo, groups, k).float(), dim=-1)
    ys = torch.arange(ho, dtype=torch.float32, device=dev) * stride[0]
    xs = torch.arange(wo, dtype=torch.float32, device=dev) * stride[1]
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    dh, dw = dilation
    ky, kx = torch.meshgrid(
        torch.arange(kh, dtype=torch.float32, device=dev) * dh -
        dh * (kh // 2),
        torch.arange(kw, dtype=torch.float32, device=dev) * dw -
        dw * (kw // 2), indexing='ij')
    base_y = gy[None, :, :, None, None] + ky.reshape(-1)
    base_x = gx[None, :, :, None, None] + kx.reshape(-1)
    shape = (b, ho * wo, groups, k)
    return ((base_x + off[..., 1]).reshape(shape),
            (base_y + off[..., 0]).reshape(shape), m.reshape(shape))


def dcnv3_core_plain(x: torch.Tensor, offset: torch.Tensor,
                     mask: torch.Tensor, kernel: Tuple[int, int] = (3, 3),
                     stride: Tuple[int, int] = (1, 1),
                     dilation: Tuple[int, int] = (1, 1), groups: int = 1,
                     chunk: int = 8192) -> torch.Tensor:
    """The JAX formula in plain PyTorch: x [B, H, W, C] (C = groups * gc),
    offset [B, Ho, Wo, G*K*2] as (dy, dx) per group and point, mask [B,
    Ho, Wo, G*K] logits -> [B, Ho, Wo, C] f32. Output pixels go in chunks
    of ``chunk`` to bound the gathered corners."""
    b, h, w, c = x.shape
    _, ho, wo, _ = offset.shape
    gc = c // groups
    sx, sy, m = _sample_points(offset, mask, kernel, stride, dilation,
                               groups)
    k = sx.shape[-1]
    # [B*G, H*W, gc]: one table per (image, group)
    table = x.reshape(b, h * w, groups, gc).permute(0, 2, 1, 3).reshape(
        b * groups, h * w, gc)
    outs = []
    for p0 in range(0, ho * wo, chunk):
        def part(t):
            return t[:, p0:p0 + chunk].permute(0, 2, 1, 3).reshape(
                b * groups, -1)
        samp = None
        for idx, wgt in bilinear_corners(part(sx), part(sy), h, w):
            term = torch.gather(table, 1, idx[..., None].expand(
                -1, -1, gc)).float() * wgt[..., None]
            samp = term if samp is None else samp + term
        n = samp.shape[1] // k
        samp = samp.reshape(b, groups, n, k, gc)
        mw = m[:, p0:p0 + chunk].permute(0, 2, 1, 3)          # [B, G, n, K]
        outs.append((samp * mw[..., None]).sum(3).permute(0, 2, 1, 3))
    return torch.cat(outs, 1).reshape(b, ho, wo, c)


def dcnv3_core_msda(x: torch.Tensor, offset: torch.Tensor,
                    mask: torch.Tensor, kernel: Tuple[int, int] = (3, 3),
                    stride: Tuple[int, int] = (1, 1),
                    dilation: Tuple[int, int] = (1, 1),
                    groups: int = 1) -> torch.Tensor:
    """The same function through ``msdeform_attn`` (K1 forward and K5
    backward on a CUDA tensor, its plain version on a CPU one): one level
    of shape (H, W), ``groups`` heads, K points at ``((x + 0.5) / W,
    (y + 0.5) / H)``, the softmaxed masks as the weights -> [B, Ho, Wo, C]
    f32."""
    b, h, w, c = x.shape
    _, ho, wo, _ = offset.shape
    sx, sy, m = _sample_points(offset, mask, kernel, stride, dilation,
                               groups)
    loc = torch.stack([(sx + 0.5) / w, (sy + 0.5) / h], -1)[:, :, :, None]
    value = x.reshape(b, h * w, groups, c // groups)
    out = msdeform_attn(value, [(h, w)], loc, m[:, :, :, None])
    return out.reshape(b, ho, wo, c)


def dcnv3_core(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
               kernel: Tuple[int, int] = (3, 3),
               stride: Tuple[int, int] = (1, 1),
               dilation: Tuple[int, int] = (1, 1),
               groups: int = 1) -> torch.Tensor:
    """DCNv3's sampling and aggregation core -> [B, Ho, Wo, C] f32: the
    msda route (K1/K5) for CUDA tensors, the plain version for CPU
    tensors."""
    fn = dcnv3_core_plain if x.device.type == 'cpu' else dcnv3_core_msda
    return fn(x, offset, mask, kernel=kernel, stride=stride,
              dilation=dilation, groups=groups)
