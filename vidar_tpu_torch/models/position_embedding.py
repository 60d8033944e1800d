"""The sine positional embedding (port of
vidar_tpu/models/position_embedding.py): DETR's ``SinePositionalEncoding``
over an all-valid mask, which the UniAD panoptic, planning and dispatch
code put on the BEV grid."""

from __future__ import annotations

import math

import torch


def sine_positional_encoding(h: int, w: int, num_feats: int = 128,
                             temperature: float = 10000.0,
                             normalize: bool = True,
                             scale: float = 2 * math.pi,
                             device=None) -> torch.Tensor:
    """-> [H, W, 2 * num_feats] f32: the (y, x) sine/cosine embedding."""
    y = torch.arange(1, h + 1, dtype=torch.float32,
                     device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32,
                     device=device)[None, :].expand(h, w)
    if normalize:
        eps = 1e-6
        y = y / (y[-1:, :] + eps) * scale
        x = x / (x[:, -1:] + eps) * scale
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * (dim_t // 2) / num_feats)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        -1).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        -1).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], -1)
