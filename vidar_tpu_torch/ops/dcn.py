"""Modulated 3x3 deformable convolution, DCNv2 forward (port of the fused
``dcn_conv16`` of vidar_tpu/ops/dcn_pallas.py).

``dcn_conv(x, sx, sy, mask, weight)`` samples x [B, H, W, C] bilinearly at
the per-tap pixel coordinates sx/sy [B, Q, 9] (zeros off the map), scales by
the modulation mask, rounds the taps to x's dtype and contracts them with
the conv weight [9*C, CO] (rows ordered (ky, kx, cin)) in f32 -> [B, Q, CO]
f32. On CUDA tensors it launches K2 (``csrc/dcn_conv.cu``, bf16 only); on
CPU tensors it runs ``dcn_conv_plain``.
"""

from __future__ import annotations

import torch

from ._build import KernelCounter, check, load_library, stream_of
from .gather import bilinear_corners

KERNEL = KernelCounter(
    'dcn_conv_forward', source='vidar_tpu_torch/csrc/dcn_conv.cu',
    replaces='vidar_tpu/ops/dcn_pallas.py:652 (dcn16_conv_gather)')

TAPS = 9


def dcn_conv_plain(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                   mask: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2, one image at a time (the [Q, 9*C] tap
    matrix of one image is the largest temporary)."""
    b, h, w, c = x.shape
    _, q, s = sx.shape
    wf = weight.float()
    outs = []
    for i in range(b):
        flat = x[i].reshape(h * w, c)
        taps = None
        for idx, wgt in bilinear_corners(sx[i].reshape(-1).float(),
                                         sy[i].reshape(-1).float(), h, w):
            wm = wgt * mask[i].reshape(-1).float()
            term = flat[idx].float() * wm[:, None]
            taps = term if taps is None else taps + term
        taps = taps.to(x.dtype).float().reshape(q, s * c)
        outs.append(taps @ wf)
    return torch.stack(outs)


def dcn_conv_cuda(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                  mask: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Launch K2. x [B, H, W, C] bf16 (C % 32 == 0), sx/sy/mask [B, Q, 9]
    f32, weight [9*C, CO] bf16 (CO % 128 == 0), all contiguous on one CUDA
    device -> [B, Q, CO] f32."""
    dev = x.device
    if not (x.is_cuda and sx.device == sy.device == mask.device ==
            weight.device == dev):
        raise ValueError('dcn_conv_forward: all inputs must be on one CUDA '
                         'device')
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError('dcn_conv_forward: x and weight must be bfloat16')
    if not all(t.dtype == torch.float32 for t in (sx, sy, mask)):
        raise TypeError('dcn_conv_forward: sx, sy, mask must be float32')
    if x.dim() != 4 or sx.dim() != 3:
        raise ValueError('dcn_conv_forward: bad ranks')
    b, h, w, c = x.shape
    _, q, s = sx.shape
    co = weight.shape[-1]
    if (s != TAPS or sx.shape[0] != b or sy.shape != sx.shape or
            mask.shape != sx.shape or weight.shape != (TAPS * c, co) or
            c % 32 or co % 128):
        raise ValueError(
            f'dcn_conv_forward: shapes x {tuple(x.shape)}, taps '
            f'{tuple(sx.shape)}, weight {tuple(weight.shape)}')
    if not all(t.is_contiguous() for t in (x, sx, sy, mask, weight)):
        raise ValueError('dcn_conv_forward: inputs must be contiguous')
    out = torch.empty(b, q, co, dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.dcn_conv_forward(
            x.data_ptr(), sx.data_ptr(), sy.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), out.data_ptr(), b, h, w, c, q, co,
            stream_of(x))
    check(rc, 'dcn_conv_forward')
    KERNEL.launched(x=x, sx=sx, sy=sy, mask=mask, weight=weight)
    return out


def dcn_conv(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
             mask: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Fused modulated deformable conv -> [B, Q, CO] f32: K2 for CUDA
    tensors, the plain version for CPU tensors."""
    if x.device.type == 'cpu':
        return dcn_conv_plain(x, sx, sy, mask, weight)
    return dcn_conv_cuda(x.contiguous(), sx.float().contiguous(),
                         sy.float().contiguous(), mask.float().contiguous(),
                         weight.contiguous())
