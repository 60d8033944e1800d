"""Modulated 3x3 deformable convolution, DCNv2 (port of the DCN ops of
vidar_tpu/ops/dcn_pallas.py), in three forms that share one adjoint:

* ``dcn_conv(x, sx, sy, mask, weight)``, the fused bf16 form: samples x
  [B, H, W, C] bilinearly at the per-tap pixel coordinates sx/sy [B, Q, 9]
  (zeros off the map), scales by the modulation mask, rounds the taps to x's
  dtype and contracts them with the conv weight [9*C, CO] (rows ordered
  (ky, kx, cin)) in f32 -> [B, Q, CO] f32. Its forward is K2
  (``csrc/dcn_conv.cu``, bf16 only) on CUDA tensors and ``dcn_conv_plain``
  on CPU tensors; it replaces ``dcn16_conv_gather``.
* ``dcn_sample(x, sx, sy, mask)``, the f32 form: the masked taps alone,
  [B, Q, 9, C] f32, the conv product left to the caller. Its forward is K9
  (``csrc/dcn_gather.cu``) on CUDA tensors and ``dcn_sample_plain`` on CPU
  tensors; it replaces ``dcn_gather``.
* ``dcn_sample16(x, sx, sy, mask)``, the bf16 taps for a shape the fused
  form does not take (``fused_dcn_fits``): K2's taps, rounded to bf16,
  [B, Q, 9*C] with channels in natural order, the conv product left to the
  caller. Its forward is K10 (``csrc/dcn_gather16.cu``) on CUDA tensors and
  ``dcn_sample16_plain`` on CPU tensors; it replaces ``dcn16_gather``.

The backwards are the same chunked PyTorch on both devices: the JAX package
computes them in XLA, not Pallas (``_dcn_conv16_vbwd``, dcn_pallas.py:743-842;
``jax.vjp`` of ``_dcn_sample_ref``, :232-235; ``_dcn_sample16_vbwd``, :455),
so their matrix products go to ``torch.matmul`` and their table scatter to
``index_add_``.
"""

from __future__ import annotations

import torch

from ._build import (KernelCounter, check, load_library, on_device,
                     stream_of)
from .gather import bilinear_corners

KERNEL = KernelCounter(
    'dcn_conv_forward', source='vidar_tpu_torch/csrc/dcn_conv.cu',
    replaces='vidar_tpu/ops/dcn_pallas.py:652 (dcn16_conv_gather)')
SAMPLE = KernelCounter(
    'dcn_sample_forward', source='vidar_tpu_torch/csrc/dcn_gather.cu',
    replaces='vidar_tpu/ops/dcn_pallas.py:96 (dcn_gather)')
SAMPLE16 = KernelCounter(
    'dcn_sample16_forward', source='vidar_tpu_torch/csrc/dcn_gather16.cu',
    replaces='vidar_tpu/ops/dcn_pallas.py:336 (dcn16_gather)')

TAPS = 9
BACKWARD_CHUNK = 2048  # queries per step of the backward


def fused_dcn_fits(c: int, co: int) -> bool:
    """Whether K2 takes a bf16 deformable conv of C input and CO output
    channels: C % 32 == 0 and CO % 128 == 0, the JAX module's split, which
    K2's 64-channel K slices (the last one padded) and 128- or 256-channel
    output tiles cover. Any other bf16 shape samples its taps with
    ``dcn_sample16`` (K10) and multiplies outside, as the JAX module does
    where ``dcn_conv16_available`` fails (vidar_tpu/models/resnet.py:
    120-132)."""
    return c % 32 == 0 and co % 128 == 0


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


def _chunked_backward(x, sx, sy, mask, d_taps, on_taps=None,
                      chunk=BACKWARD_CHUNK):
    """The adjoint of the masked bilinear taps, query chunk by query chunk
    over each image. ``d_taps(i, q0, q1)`` gives the gradient [n, C] f32 of
    the n = (q1 - q0) * 9 taps of image i, rows (q, tap); ``on_taps(i, q0,
    q1, taps)``, when given, sees those taps [n, C] f32 as the forward made
    them. ``d mask`` comes from the taps before the mask; a corner off the
    map neither reads nor receives, so ``d sx``/``d sy`` vanish where the
    sample misses the map (dcn_pallas.py:834-840). Sums in f32; returns (dx
    in x's dtype, dsx, dsy, dmask)."""
    b, h, w, c = x.shape
    _, q, s = sx.shape
    dx = torch.zeros(b, h * w, c, dtype=torch.float32, device=x.device)
    dsx = torch.empty(b, q, s, dtype=torch.float32, device=x.device)
    dsy = torch.empty_like(dsx)
    dmask = torch.empty_like(dsx)
    for i in range(b):
        flat = x[i].reshape(h * w, c)
        for q0 in range(0, q, chunk):
            q1 = min(q, q0 + chunk)
            n = (q1 - q0) * s
            dt = d_taps(i, q0, q1)
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
            if on_taps is not None:
                on_taps(i, q0, q1, samp * m[:, None])
    return dx.reshape(b, h, w, c).to(x.dtype), dsx, dsy, dmask


def dcn_conv_backward(x, sx, sy, mask, weight, g, chunk=BACKWARD_CHUNK):
    """Gradients of ``dcn_conv`` against (x, sx, sy, mask, weight), given g
    [B, Q, CO]: the adjoints of ``_dcn_conv16_vbwd``. ``d weight`` comes
    from the taps rounded to x's dtype, as the forward uses them
    (dcn_pallas.py:806-809), and is returned in the weight's dtype."""
    c = x.shape[-1]
    wf = weight.float()
    dw = torch.zeros(wf.shape, dtype=torch.float32, device=x.device)

    def weight_grad(i, q0, q1, taps):
        taps = taps.to(x.dtype).float().reshape(q1 - q0, TAPS * c)
        dw.add_(taps.t() @ g[i, q0:q1].float())

    grads = _chunked_backward(
        x, sx, sy, mask,
        lambda i, q0, q1: (g[i, q0:q1].float() @ wf.t()).reshape(-1, c),
        weight_grad, chunk)
    return grads + (dw.to(weight.dtype),)


def dcn_sample_backward(x, sx, sy, mask, g, chunk=BACKWARD_CHUNK):
    """Gradients of ``dcn_sample`` against (x, sx, sy, mask), given g
    [B, Q, 9, C]: the adjoint of ``_dcn_sample_ref``, which is what
    ``jax.vjp`` takes for ``dcn_sample``'s backward (dcn_pallas.py:
    232-235)."""
    c = x.shape[-1]
    return _chunked_backward(
        x, sx, sy, mask, lambda i, q0, q1: g[i, q0:q1].reshape(-1, c).float(),
        chunk=chunk)


def _taps16_plain(x, sx, sy, mask, i):
    """The taps of image i as K2 and K10 make them: per corner the weight
    (bilinear x mask) first, the corners summed in f32 in the order (y0 x0,
    y0 x1, y1 x0, y1 x1), as ``dcn16_gather`` folds them (dcn_pallas.py:
    311-321), then rounded to x's dtype -> [Q, 9*C]."""
    _, h, w, c = x.shape
    q = sx.shape[1]
    flat = x[i].reshape(h * w, c)
    taps = None
    for idx, wgt in bilinear_corners(sx[i].reshape(-1).float(),
                                     sy[i].reshape(-1).float(), h, w):
        wm = wgt * mask[i].reshape(-1).float()
        term = flat[idx].float() * wm[:, None]
        taps = term if taps is None else taps + term
    return taps.to(x.dtype).reshape(q, TAPS * c)


def dcn_conv_plain(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                   mask: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2, one image at a time (the [Q, 9*C] tap
    matrix of one image is the largest temporary)."""
    wf = weight.float()
    return torch.stack([_taps16_plain(x, sx, sy, mask, i).float() @ wf
                        for i in range(x.shape[0])])


def dcn_conv_cuda(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                  mask: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Launch K2. x [B, H, W, C] bf16 (C % 32 == 0), sx/sy/mask [B, Q, 9]
    f32, weight [9*C, CO] bf16 (CO % 128 == 0), all contiguous on one CUDA
    device, x and weight on 16-byte boundaries -> [B, Q, CO] f32."""
    dev = x.device
    if not (x.is_cuda and sx.device == sy.device == mask.device ==
            weight.device == dev):
        raise ValueError('dcn_conv_forward: all inputs must be on one CUDA '
                         'device')
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError(
            f'dcn_conv_forward: x and weight must be bfloat16, not '
            f'{x.dtype} and {weight.dtype}; an f32 deformable conv samples '
            f'its taps with dcn_sample (K9) and multiplies them by the '
            f'weight outside (models.resnet.DeformConv2d)')
    if not all(t.dtype == torch.float32 for t in (sx, sy, mask)):
        raise TypeError('dcn_conv_forward: sx, sy, mask must be float32')
    if x.dim() != 4 or sx.dim() != 3:
        raise ValueError('dcn_conv_forward: bad ranks')
    b, h, w, c = x.shape
    _, q, s = sx.shape
    co = weight.shape[-1]
    if (s != TAPS or sx.shape[0] != b or sy.shape != sx.shape or
            mask.shape != sx.shape or weight.shape != (TAPS * c, co)):
        raise ValueError(
            f'dcn_conv_forward: shapes x {tuple(x.shape)}, taps '
            f'{tuple(sx.shape)}, weight {tuple(weight.shape)}')
    if not fused_dcn_fits(c, co):
        raise ValueError(
            f'dcn_conv_forward: takes C % 32 == 0 and CO % 128 == 0, not C '
            f'{c}, CO {co}; such a deformable conv samples its taps with '
            f'dcn_sample16 (K10) and multiplies them by the weight outside '
            f'(models.resnet.DeformConv2d)')
    if not all(t.is_contiguous() for t in (x, sx, sy, mask, weight)):
        raise ValueError('dcn_conv_forward: inputs must be contiguous')
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError('dcn_conv_forward: x and weight must start on a '
                         '16-byte boundary (K2 reads their rows in 16-byte '
                         'chunks)')
    out = torch.empty(b, q, co, dtype=torch.float32, device=dev)
    lib = load_library()
    with on_device(dev):
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


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, copied into a fresh tensor if it starts off a 16-byte
    boundary (a view with an odd storage offset)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def dcn_conv(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
             mask: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Fused modulated deformable conv -> [B, Q, CO] f32: K2 for CUDA
    tensors, the plain version for CPU tensors; ``dcn_conv_backward`` for
    the gradient on both. K2 reads x and the weight in 16-byte chunks, so a
    view of either off a 16-byte boundary is copied first."""
    return _DCNConv.apply(_aligned16(x), sx.float().contiguous(),
                          sy.float().contiguous(), mask.float().contiguous(),
                          _aligned16(weight))


def dcn_sample_plain(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K9, one image at a time: the taps [B, Q, 9,
    C] f32, each the bilinear sample of x in f32 (corners summed in the
    order (y0 x0, y0 x1, y1 x0, y1 x1)) times the mask, as
    ``_dcn_sample_ref`` (dcn_pallas.py:155-168)."""
    b, h, w, c = x.shape
    _, q, s = sx.shape
    out = torch.empty(b, q, s, c, dtype=torch.float32, device=x.device)
    for i in range(b):
        flat = x[i].reshape(h * w, c)
        taps = None
        for idx, wgt in bilinear_corners(sx[i].reshape(-1).float(),
                                         sy[i].reshape(-1).float(), h, w):
            term = flat[idx].float() * wgt[:, None]
            taps = term if taps is None else taps + term
        out[i] = (taps * mask[i].reshape(-1, 1).float()).reshape(q, s, c)
    return out


# dcn_sample_route's codes
SAMPLE_ROUTES = {1: 'staged', 0: 'scalar'}


def dcn_sample_route(x: torch.Tensor, q: int) -> str:
    """Which K9 kernel ``dcn_sample_cuda`` runs for x [B, H, W, C] and Q
    output pixels: 'staged' (2 x 16-pixel tiles from a window of x in shared
    memory, where Q = H*W, as in the ResNet DCN, C % 4 == 0 and x lies on a
    16-byte boundary) or 'scalar' (any other call). The wrapper's output is
    a fresh, aligned allocation (0 stands for its address)."""
    _, h, w, c = x.shape
    return SAMPLE_ROUTES[load_library().dcn_sample_route(
        x.data_ptr(), 0, h, w, c, q)]


def dcn_sample_cuda(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Launch K9. x [B, H, W, C] f32 (any C and alignment: see
    ``dcn_sample_route``), sx/sy/mask [B, Q, 9] f32, all contiguous on one
    CUDA device -> [B, Q, 9, C] f32."""
    dev = x.device
    if not (x.is_cuda and sx.device == sy.device == mask.device == dev):
        raise ValueError('dcn_sample_forward: all inputs must be on one CUDA '
                         'device')
    if not all(t.dtype == torch.float32 for t in (x, sx, sy, mask)):
        raise TypeError('dcn_sample_forward: x, sx, sy, mask must be float32 '
                        '(a bf16 deformable conv runs dcn_conv, K2)')
    if x.dim() != 4 or sx.dim() != 3:
        raise ValueError('dcn_sample_forward: bad ranks')
    b, h, w, c = x.shape
    _, q, s = sx.shape
    if (s != TAPS or sx.shape[0] != b or sy.shape != sx.shape or
            mask.shape != sx.shape):
        raise ValueError(f'dcn_sample_forward: shapes x {tuple(x.shape)}, '
                         f'taps {tuple(sx.shape)}')
    if not all(t.is_contiguous() for t in (x, sx, sy, mask)):
        raise ValueError('dcn_sample_forward: inputs must be contiguous')
    out = torch.empty(b, q, s, c, dtype=torch.float32, device=dev)
    lib = load_library()
    with on_device(dev):
        rc = lib.dcn_sample_forward(
            x.data_ptr(), sx.data_ptr(), sy.data_ptr(), mask.data_ptr(),
            out.data_ptr(), b, h, w, c, q, stream_of(x))
    check(rc, 'dcn_sample_forward')
    SAMPLE.launched(x=x, sx=sx, sy=sy, mask=mask)
    return out


class _DCNSample(torch.autograd.Function):
    """K9 (CUDA) or the plain version (CPU) forward; the chunked PyTorch
    backward on both."""

    @staticmethod
    def forward(ctx, x, sx, sy, mask):
        ctx.save_for_backward(x, sx, sy, mask)
        if x.device.type == 'cpu':
            return dcn_sample_plain(x, sx, sy, mask)
        return dcn_sample_cuda(x, sx, sy, mask)

    @staticmethod
    def backward(ctx, g):
        return dcn_sample_backward(*ctx.saved_tensors, g)


def dcn_sample(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Modulated deformable-conv taps -> [B, Q, 9, C] f32: K9 for CUDA
    tensors, the plain version for CPU tensors; ``dcn_sample_backward`` for
    the gradient on both."""
    return _DCNSample.apply(x.contiguous(), sx.float().contiguous(),
                            sy.float().contiguous(),
                            mask.float().contiguous())


def dcn_sample16_plain(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K10, one image at a time: K2's taps [B, Q,
    9*C] in x's dtype, channels in natural order (``dcn16_gather`` emits
    them evens || odds, ``dcn16_channel_perm``, dcn_pallas.py:390)."""
    return torch.stack([_taps16_plain(x, sx, sy, mask, i)
                        for i in range(x.shape[0])])


# dcn_sample16_route's codes
SAMPLE16_ROUTES = {2: 'staged', 1: 'vector', 0: 'scalar'}


def dcn_sample16_route(x: torch.Tensor, q: int) -> str:
    """Which K10 kernel ``dcn_sample16_cuda`` runs for x [B, H, W, C] and Q
    output pixels: 'staged' (8 x 8-pixel tiles from a window of x in shared
    memory, where Q = H*W, as in the ResNet DCN), 'vector' (the first
    design, 8 channels a thread, for another Q), both where C % 8 == 0 and x
    lies on a 16-byte boundary, or 'scalar' (any other call). The wrapper's
    output is a fresh, aligned allocation (0 stands for its address)."""
    _, h, w, c = x.shape
    return SAMPLE16_ROUTES[load_library().dcn_sample16_route(
        x.data_ptr(), 0, h, w, c, q)]


def dcn_sample16_cuda(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Launch K10. x [B, H, W, C] bf16 (any C and alignment: see
    ``dcn_sample16_route``), sx/sy/mask [B, Q, 9] f32, all contiguous on one
    CUDA device -> [B, Q, 9*C] bf16."""
    dev = x.device
    if not (x.is_cuda and sx.device == sy.device == mask.device == dev):
        raise ValueError('dcn_sample16_forward: all inputs must be on one '
                         'CUDA device')
    if x.dtype != torch.bfloat16:
        raise TypeError(f'dcn_sample16_forward: x must be bfloat16, not '
                        f'{x.dtype} (an f32 deformable conv runs dcn_sample, '
                        f'K9)')
    if not all(t.dtype == torch.float32 for t in (sx, sy, mask)):
        raise TypeError('dcn_sample16_forward: sx, sy, mask must be float32')
    if x.dim() != 4 or sx.dim() != 3:
        raise ValueError('dcn_sample16_forward: bad ranks')
    b, h, w, c = x.shape
    _, q, s = sx.shape
    if (s != TAPS or sx.shape[0] != b or sy.shape != sx.shape or
            mask.shape != sx.shape):
        raise ValueError(f'dcn_sample16_forward: shapes x {tuple(x.shape)}, '
                         f'taps {tuple(sx.shape)}')
    if not all(t.is_contiguous() for t in (x, sx, sy, mask)):
        raise ValueError('dcn_sample16_forward: inputs must be contiguous')
    out = torch.empty(b, q, s * c, dtype=torch.bfloat16, device=dev)
    lib = load_library()
    with on_device(dev):
        rc = lib.dcn_sample16_forward(
            x.data_ptr(), sx.data_ptr(), sy.data_ptr(), mask.data_ptr(),
            out.data_ptr(), b, h, w, c, q, stream_of(x))
    check(rc, 'dcn_sample16_forward')
    SAMPLE16.launched(x=x, sx=sx, sy=sy, mask=mask)
    return out


class _DCNSample16(torch.autograd.Function):
    """K10 (CUDA) or the plain version (CPU) forward; the chunked PyTorch
    backward on both, the adjoint of the taps before their rounding, as
    ``_dcn_sample16_vbwd`` (dcn_pallas.py:455) takes it."""

    @staticmethod
    def forward(ctx, x, sx, sy, mask):
        ctx.save_for_backward(x, sx, sy, mask)
        if x.device.type == 'cpu':
            return dcn_sample16_plain(x, sx, sy, mask)
        return dcn_sample16_cuda(x, sx, sy, mask)

    @staticmethod
    def backward(ctx, g):
        x, sx, sy, mask = ctx.saved_tensors
        b, q = sx.shape[:2]
        return dcn_sample_backward(x, sx, sy, mask,
                                   g.reshape(b, q, TAPS, x.shape[-1]))


def dcn_sample16(x: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Modulated deformable-conv taps of a bf16 map -> [B, Q, 9*C] in x's
    dtype: K10 for CUDA tensors, the plain version for CPU tensors;
    ``dcn_sample_backward`` for the gradient on both."""
    return _DCNSample16.apply(x.contiguous(), sx.float().contiguous(),
                              sy.float().contiguous(),
                              mask.float().contiguous())
