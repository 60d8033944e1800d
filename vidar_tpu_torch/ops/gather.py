"""Bilinear gathers with zero padding (port of vidar_tpu/ops/gather.py).

The JAX package packs the four corners of every pixel into one table row
because TPU gathers are row-rate bound. PyTorch gathers the four corners
directly; the results are the same: a corner off the map weighs nothing, and
a sample whose top-left corner lies outside [-1, h-1] x [-1, w-1] is zero.
"""

from __future__ import annotations

import torch


def bilinear_corners(x_pix: torch.Tensor, y_pix: torch.Tensor, h: int,
                     w: int):
    """Corner pixel indices and weights for pixel-space coordinates.

    Returns a list of four ``(index, weight)`` pairs, corners in the order
    (y0, x0), (y0, x1), (y1, x0), (y1, x1): ``index`` is the flat pixel
    index ``iy * w + ix`` (clamped into the map) and ``weight`` the f32
    bilinear weight, zero for a corner off the map.
    """
    x0 = torch.floor(x_pix)
    y0 = torch.floor(y_pix)
    wx1 = x_pix - x0
    wy1 = y_pix - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    ix0 = x0.to(torch.int64)
    iy0 = y0.to(torch.int64)
    out = []
    for dy, wy in ((0, wy0), (1, wy1)):
        for dx, wx in ((0, wx0), (1, wx1)):
            iy = iy0 + dy
            ix = ix0 + dx
            ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
            out.append((idx, (wy * wx) * ok.to(wx.dtype)))
    return out


def bilinear_sample(feat: torch.Tensor, x_pix: torch.Tensor,
                    y_pix: torch.Tensor) -> torch.Tensor:
    """Sample ``feat`` [B, H, W, C] at pixel coords ``x_pix``/``y_pix``
    [B, N] (pixel centres at integers). Returns [B, N, C] f32."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    out = None
    for idx, wgt in bilinear_corners(x_pix.float(), y_pix.float(), h, w):
        g = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c)).float()
        term = g * wgt[..., None]
        out = term if out is None else out + term
    return out
