"""Modulated 3x3 deformable convolution, DCNv2 forward (port of the fused
``dcn_conv16`` of vidar_tpu/ops/dcn_pallas.py).

``dcn_conv(x, sx, sy, mask, weight)`` samples x [B, H, W, C] bilinearly at
the per-tap pixel coordinates sx/sy [B, Q, 9] (zeros off the map), scales by
the modulation mask, rounds the taps to x's dtype and contracts them with
the conv weight [9*C, CO] (rows ordered (ky, kx, cin)) in f32 -> [B, Q, CO]
f32. Its forward is K2 (``csrc/dcn_conv.cu``, bf16 only) on CUDA tensors and
``dcn_conv_plain`` on CPU tensors. Its backward, ``dcn_conv_backward``, is
the same chunked PyTorch on both: the JAX package computes it in XLA, not
Pallas (``_dcn_conv16_vbwd``, vidar_tpu/ops/dcn_pallas.py:743-842), so its
matrix products go to ``torch.matmul`` and its table scatter to
``index_add_``.
"""

from __future__ import annotations

import torch

from ._build import KernelCounter, check, load_library, stream_of
from .gather import bilinear_corners

KERNEL = KernelCounter(
    'dcn_conv_forward', source='vidar_tpu_torch/csrc/dcn_conv.cu',
    replaces='vidar_tpu/ops/dcn_pallas.py:652 (dcn16_conv_gather)')

TAPS = 9
BACKWARD_CHUNK = 2048  # queries per step of the backward


def _corners(sx, sy, h: int, w: int):
    """Per corner (y0x0, y0x1, y1x0, y1x1) of pixel coords sx/sy [n]: the
    clamped flat index, the bilinear weight and the on-map mask, plus the
    fractions (wx0, wx1, wy0, wy1)."""
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx1 = sx - x0
    wy1 = sy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    ix0 = x0.to(torch.int64)
    iy0 = y0.to(torch.int64)
    out = []
    for dy, wy in ((0, wy0), (1, wy1)):
        for dx, wx in ((0, wx0), (1, wx1)):
            iy, ix = iy0 + dy, ix0 + dx
            ok = ((iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)).float()
            idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
            out.append((idx, wy * wx * ok, ok))
    return out, (wx0, wx1, wy0, wy1)


def dcn_conv_backward(x, sx, sy, mask, weight, g, chunk=BACKWARD_CHUNK):
    """Gradients of ``dcn_conv`` against (x, sx, sy, mask, weight), given g
    [B, Q, CO]: the adjoints of ``_dcn_conv16_vbwd``, query chunk by query
    chunk. ``d weight`` comes from the taps rounded to x's dtype, as the
    forward uses them (dcn_pallas.py:806-809); ``d mask`` from the taps
    before the mask; a corner off the map neither reads nor receives, so
    ``d sx``/``d sy`` vanish where the sample misses the map
    (:834-840). Sums in f32; dx and d weight are returned in their
    inputs' dtypes."""
    b, h, w, c = x.shape
    _, q, s = sx.shape
    wf = weight.float()
    dx = torch.zeros(b, h * w, c, dtype=torch.float32, device=x.device)
    dw = torch.zeros(wf.shape, dtype=torch.float32, device=x.device)
    dsx = torch.empty(b, q, s, dtype=torch.float32, device=x.device)
    dsy = torch.empty_like(dsx)
    dmask = torch.empty_like(dsx)
    for i in range(b):
        flat = x[i].reshape(h * w, c)
        for q0 in range(0, q, chunk):
            q1 = min(q, q0 + chunk)
            n = (q1 - q0) * s
            gc = g[i, q0:q1].float()                            # [qc, CO]
            dt = (gc @ wf.t()).reshape(n, c)        # d taps, (q, tap) rows
            m = mask[i, q0:q1].reshape(n).float()
            corners, (wx0, wx1, wy0, wy1) = _corners(
                sx[i, q0:q1].reshape(n).float(),
                sy[i, q0:q1].reshape(n).float(), h, w)
            vals = [flat.index_select(0, idx).float() * ok[:, None]
                    for idx, _, ok in corners]
            samp = sum(v * cw[:, None] for v, (_, cw, _) in zip(vals, corners))
            dmask[i, q0:q1] = (dt * samp).sum(-1).reshape(q1 - q0, s)
            dout_e = dt * m[:, None]
            dcw = [(v * dout_e).sum(-1) for v in vals]
            for idx, cw, _ in corners:
                dx[i].index_add_(0, idx, cw[:, None] * dout_e)
            dsx[i, q0:q1] = (wy0 * (dcw[1] - dcw[0]) +
                             wy1 * (dcw[3] - dcw[2])).reshape(q1 - q0, s)
            dsy[i, q0:q1] = (wx0 * (dcw[2] - dcw[0]) +
                             wx1 * (dcw[3] - dcw[1])).reshape(q1 - q0, s)
            taps = (samp * m[:, None]).to(x.dtype).float()
            dw += taps.reshape(q1 - q0, s * c).t() @ gc
    return (dx.reshape(b, h, w, c).to(x.dtype), dsx, dsy, dmask,
            dw.to(weight.dtype))


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


class _DCNConv(torch.autograd.Function):
    """K2 (CUDA) or the plain version (CPU) forward; the chunked PyTorch
    backward on both."""

    @staticmethod
    def forward(ctx, x, sx, sy, mask, weight):
        ctx.save_for_backward(x, sx, sy, mask, weight)
        if x.device.type == 'cpu':
            return dcn_conv_plain(x, sx, sy, mask, weight)
        return dcn_conv_cuda(x, sx, sy, mask, weight)

    @staticmethod
    def backward(ctx, g):
        return dcn_conv_backward(*ctx.saved_tensors, g)


def dcn_conv(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
             mask: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Fused modulated deformable conv -> [B, Q, CO] f32: K2 for CUDA
    tensors, the plain version for CPU tensors; ``dcn_conv_backward`` for
    the gradient on both."""
    return _DCNConv.apply(x.contiguous(), sx.float().contiguous(),
                          sy.float().contiguous(), mask.float().contiguous(),
                          weight.contiguous())
