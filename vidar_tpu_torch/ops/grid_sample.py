"""``F.grid_sample`` semantics on channels-last maps (port of
vidar_tpu/ops/grid_sample.py): bilinear, zero padding,
``align_corners=False``; grids carry (x, y) in [-1, 1] in the last dim."""

from __future__ import annotations

import torch

from .gather import bilinear_sample


def unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """align_corners=False: x_pix = ((x + 1) * size - 1) / 2."""
    return ((coord + 1.0) * size - 1.0) * 0.5


def grid_sample_2d(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """feat [B, H, W, C], grid [B, N, 2] -> [B, N, C] f32."""
    _, h, w, _ = feat.shape
    x = unnormalize(grid[..., 0].float(), w)
    y = unnormalize(grid[..., 1].float(), h)
    return bilinear_sample(feat, x, y)
