"""BEV-plane rotation, nearest mode (port of vidar_tpu/ops/rotate.py:23,
torchvision ``rotate`` parity). Positive angles rotate the content
counter-clockwise in the x-right / y-down image frame."""

from __future__ import annotations

import torch


def rotate_bev(feat: torch.Tensor, angle_deg: torch.Tensor,
               center) -> torch.Tensor:
    """Rotate [B, H, W, C] maps by per-batch angles [B] (degrees) about the
    pixel ``center`` (cx, cy): nearest source pixel, zeros where the source
    falls off the map."""
    b, h, w, c = feat.shape
    cx, cy = center
    a = torch.deg2rad(angle_deg.float()).reshape(b, 1, 1)
    cos, sin = torch.cos(a), torch.sin(a)
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=feat.device),
        torch.arange(w, dtype=torch.float32, device=feat.device),
        indexing='ij')
    dx = (xs - cx)[None]
    dy = (ys - cy)[None]
    sx = cos * dx + sin * dy + cx
    sy = -sin * dx + cos * dy + cy
    ix = torch.floor(sx).to(torch.int64)
    iy = torch.floor(sy).to(torch.int64)
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    flat = feat.reshape(b, h * w, c)
    out = torch.gather(flat, 1, idx.reshape(b, h * w, 1).expand(-1, -1, c))
    out = out * valid.reshape(b, h * w, 1).to(feat.dtype)
    return out.reshape(b, h, w, c)
