"""Masked chamfer distance (port of vidar_tpu/ops/chamfer.py:22-101), plain
PyTorch: the JAX package computes it in XLA, not Pallas.

The nearest neighbour is found tile by tile with the matmul expansion
|x|^2 + |y|^2 - 2 x.y of the clouds centred on the valid destination
points (which cuts the expansion's cancellation), without gradient; the
distance at the chosen neighbour is then recomputed exactly, and the
gradient flows through that recomputation only (chamfer.py:63-67).
"""

from __future__ import annotations

import torch

BIG = 1e10  # distance of a point with no valid neighbour


def _pairwise_min(src, dst, dst_mask, tile: int):
    """(min squared distance [N], index [N]) from each src point to the
    valid dst points; BIG (no gradient) where dst has none."""
    m = dst.shape[0]
    valid = dst_mask.float()
    center = (dst * valid[:, None]).sum(0) / valid.sum().clamp(min=1.0)
    src = src - center
    dst = dst - center
    with torch.no_grad():
        src_sq = (src * src).sum(-1)
        best_d = torch.full_like(src_sq, BIG)
        best_i = torch.zeros(src.shape[0], dtype=torch.int64,
                             device=src.device)
        for t0 in range(0, m, tile):
            dst_t = dst[t0:t0 + tile]
            d = (src_sq[:, None] + (dst_t * dst_t).sum(-1)[None, :] -
                 2.0 * (src @ dst_t.t()))
            d = torch.where(dst_mask[None, t0:t0 + tile], d,
                            torch.full_like(d, BIG))
            tile_best, tile_arg = d.min(dim=1)
            take = tile_best < best_d
            best_d = torch.where(take, tile_best, best_d)
            best_i = torch.where(take, tile_arg + t0, best_i)
    exact = ((src - dst[best_i]) ** 2).sum(-1)
    return torch.where(best_d >= BIG, best_d, exact), best_i


def nearest_neighbor_sq(src, dst, src_mask, dst_mask, tile: int = 2048):
    """Per-src-point nearest squared distance and index into dst, all
    unbatched: src [N, 3], dst [M, 3], masks [N]/[M] bool. Invalid src rows
    give distance 0 and index 0."""
    d, i = _pairwise_min(src.float(), dst.float(), dst_mask, tile)
    return (torch.where(src_mask, d, torch.zeros_like(d)),
            torch.where(src_mask, i, torch.zeros_like(i)))


def chamfer_distance_masked(src, dst, src_mask, dst_mask, tile: int = 2048):
    """Bidirectional chamfer with padding masks -> (loss_src, loss_dst,
    idx_src, idx_dst): the masked means of the per-point nearest squared
    distances, as mmdet3d's ``chamfer_distance(criterion_mode='l2',
    reduction='mean')``."""
    d_src, i_src = nearest_neighbor_sq(src, dst, src_mask, dst_mask, tile)
    d_dst, i_dst = nearest_neighbor_sq(dst, src, dst_mask, src_mask, tile)
    n_src = src_mask.float().sum().clamp(min=1.0)
    n_dst = dst_mask.float().sum().clamp(min=1.0)
    return d_src.sum() / n_src, d_dst.sum() / n_dst, i_src, i_dst
