"""Deformable attention modules (port of vidar_tpu/models/attention.py),
eval path only. All three reduce to ``ops.msda.msdeform_attn``:

* ``TemporalSelfAttention``: BEV self-attention over the 2-slot queue
  [prev BEV, current query], the queue folded into the batch and averaged.
* ``SpatialCrossAttention``: per-camera image cross-attention over the
  queries each camera sees, compacted to a static capacity with the same
  stable visible-first order as the JAX package (``sca_compaction``), then
  normalised by the per-query camera count. A capacity of all queries
  gives the JAX package's dense-masked form.
* ``PredictionMSDeformableAttention``: the future decoder's attention.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.msda import msdeform_attn
from .layers import Dense


class _DeformProj(nn.Module):
    """The three learned projections of a deformable attention block."""

    def __init__(self, embed_dims: int, num_heads: int, num_levels: int,
                 num_points: int, query_dims: int = None, num_queue: int = 1,
                 dtype=None, device=None):
        super().__init__()
        n = num_queue * num_heads * num_levels * num_points
        qd = query_dims or embed_dims
        kw = dict(dtype=dtype, device=device)
        self.sampling_offsets = Dense(qd, n * 2, **kw)
        self.attention_weights = Dense(qd, n, **kw)
        self.value_proj = Dense(embed_dims, embed_dims, **kw)


def _softmax_weights(proj, query, shape, lp):
    """Attention weights softmaxed in f32 over the trailing (levels,
    points) pair of ``shape``."""
    w = proj.attention_weights(query).reshape(*shape[:-2], lp)
    return torch.softmax(w.float(), dim=-1).reshape(shape)


class TemporalSelfAttention(nn.Module):
    """BEV temporal self-attention with a 2-slot value queue."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 num_bev_queue: int = 2, dtype=None, device=None):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        self.num_bev_queue = num_bev_queue
        self.proj = _DeformProj(embed_dims, num_heads, num_levels,
                                num_points, query_dims=2 * embed_dims,
                                num_queue=num_bev_queue, dtype=dtype,
                                device=device)
        self.output_proj = Dense(embed_dims, embed_dims, dtype=dtype,
                                 device=device)

    def forward(self, query, value, ref_2d_pair, bev_h: int, bev_w: int,
                query_pos):
        """query [bs, N, C]; value [bs, 2, N, C], the (previous, current)
        queue; ref_2d_pair [bs, 2, N, 1, 2]; query_pos [bs, N, C]."""
        bs, len_bev, _ = query.shape
        identity = query
        query = query + query_pos
        h, lv, p, nq = (self.num_heads, self.num_levels, self.num_points,
                        self.num_bev_queue)
        query_cat = torch.cat([value[:, 0], query], dim=-1)
        offsets = self.proj.sampling_offsets(query_cat).reshape(
            bs, len_bev, h, nq, lv, p, 2)
        weights = _softmax_weights(self.proj, query_cat,
                                   (bs, len_bev, h, nq, lv, p), lv * p)
        value_p = self.proj.value_proj(value).reshape(
            bs * nq, len_bev, h, self.embed_dims // h)
        # fold the queue into the batch: [bs*2, N, heads, levels, points]
        offsets = offsets.permute(0, 3, 1, 2, 4, 5, 6).reshape(
            bs * nq, len_bev, h, lv, p, 2)
        weights = weights.permute(0, 3, 1, 2, 4, 5).reshape(
            bs * nq, len_bev, h, lv, p)
        ref = ref_2d_pair.reshape(bs * nq, len_bev, 1, lv, 1, 2)
        normalizer = torch.tensor([bev_w, bev_h], dtype=torch.float32,
                                  device=query.device)
        loc = ref + offsets / normalizer
        out = msdeform_attn(value_p, [(bev_h, bev_w)], loc, weights)
        out = out.reshape(bs, nq, len_bev, self.embed_dims).mean(dim=1)
        return self.output_proj(out.to(query.dtype)) + identity


def _deform_offsets_weights(proj, query, h: int, lv: int, p: int):
    bs, num_query, _ = query.shape
    offsets = proj.sampling_offsets(query).reshape(bs, num_query, h, lv, p, 2)
    weights = _softmax_weights(proj, query, (bs, num_query, h, lv, p),
                               lv * p)
    return offsets, weights


def _stable_partition_indices(visible: torch.Tensor) -> torch.Tensor:
    """[..., N] bool -> [..., N] int64 query indices, visible first, each
    group in its original order (an O(N) cumsum partition + one scatter)."""
    shape = visible.shape
    n = shape[-1]
    vis = visible.reshape(-1, n)
    vi = vis.to(torch.int64)
    rank_vis = torch.cumsum(vi, -1) - 1
    rank_inv = torch.cumsum(1 - vi, -1) - 1
    n_vis = vi.sum(-1, keepdim=True)
    dest = torch.where(vis, rank_vis, n_vis + rank_inv)
    src = torch.arange(n, device=visible.device).expand_as(dest)
    out = torch.zeros_like(src).scatter_(1, dest, src)
    return out.reshape(shape)


def _z_anchor_locations(offsets, reference_points_cam, spatial_shapes):
    """Fold per-level-normalised offsets around per-Z-anchor references."""
    bs, num_query, h, lv, p, _ = offsets.shape
    normalizer = torch.tensor([[w_, h_] for (h_, w_) in spatial_shapes],
                              dtype=torch.float32, device=offsets.device)
    offsets = offsets / normalizer[None, None, None, :, None, :]
    num_z = reference_points_cam.shape[2]
    offsets = offsets.reshape(bs, num_query, h, lv, p // num_z, num_z, 2)
    ref = reference_points_cam[:, :, None, None, None, :, :]
    return (ref + offsets).reshape(bs, num_query, h, lv, p, 2)


def sca_compaction(reference_points_cam, bev_mask, cap: int):
    """Per-frame compaction plan of SpatialCrossAttention (geometry only).

    reference_points_cam [cams, bs, Q, D, 2], bev_mask [cams, bs, Q, D].
    Returns (sel [bs, cams, cap], sel_valid [bs, cams, cap], ref_c
    [bs*cams, cap, D, 2], visible [bs, cams, Q], overflow [bs, cams],
    inv_sel [bs, cams, Q]: slot of query q in the compacted set, or ``cap``
    when q was not selected).
    """
    visible = bev_mask.any(dim=-1).permute(1, 0, 2)
    ref = reference_points_cam.permute(1, 0, 2, 3, 4)
    bs, num_cams, num_query = visible.shape
    d = ref.shape[3]
    overflow = (visible.sum(dim=2) - cap).clamp(min=0)
    sel = _stable_partition_indices(visible)[:, :, :cap]
    sel_valid = torch.gather(visible, 2, sel)
    ref_c = torch.gather(ref, 2, sel[..., None, None].expand(-1, -1, -1, d, 2))
    ref_c = ref_c.reshape(bs * num_cams, cap, d, 2)
    slots = torch.arange(cap, device=sel.device).expand_as(sel)
    pos = torch.where(sel_valid, slots, torch.full_like(slots, cap))
    inv_sel = torch.full((bs, num_cams, num_query), cap, dtype=torch.int64,
                         device=sel.device).scatter_(2, sel, pos)
    return sel, sel_valid, ref_c, visible, overflow, inv_sel


class SpatialCrossAttention(nn.Module):
    """Per-camera deformable image cross-attention with visibility."""

    def __init__(self, embed_dims: int = 256, num_cams: int = 6,
                 deform_num_heads: int = 8, deform_num_levels: int = 4,
                 deform_num_points: int = 8, dtype=None, device=None):
        super().__init__()
        self.embed_dims = embed_dims
        self.heads, self.levels, self.points = (deform_num_heads,
                                                deform_num_levels,
                                                deform_num_points)
        self.dtype = dtype
        self.deformable_attention = _DeformProj(
            embed_dims, deform_num_heads, deform_num_levels,
            deform_num_points, dtype=dtype, device=device)
        self.output_proj = Dense(embed_dims, embed_dims, dtype=dtype,
                                 device=device)

    def forward(self, query, value, spatial_shapes: Sequence[Tuple[int, int]],
                compact):
        """query [bs, Q, C]; value [bs, cams, V, C]; compact: the frame's
        ``sca_compaction`` plan."""
        bs, num_query, c = query.shape
        num_cams = value.shape[1]
        identity = query
        proj = self.deformable_attention
        h, lv, p = self.heads, self.levels, self.points
        value_p = proj.value_proj(value).reshape(
            bs * num_cams, value.shape[2], h, c // h)
        sel, _, ref_c, visible, _, inv_sel = compact
        cap = sel.shape[-1]
        q_c = torch.gather(query[:, None].expand(-1, num_cams, -1, -1), 2,
                           sel[..., None].expand(-1, -1, -1, c))
        q_c = q_c.reshape(bs * num_cams, cap, c)
        offsets, weights = _deform_offsets_weights(proj, q_c, h, lv, p)
        loc = _z_anchor_locations(offsets, ref_c, spatial_shapes)
        cam_out = msdeform_attn(value_p, list(spatial_shapes), loc, weights)
        cam_out = cam_out.reshape(bs, num_cams, cap, c)
        if self.dtype is not None and self.dtype != cam_out.dtype:
            cam_out = cam_out.to(self.dtype)
        # scatter back as a gather; row ``cap`` is the zero sentinel
        cam_out_p = torch.cat([cam_out, cam_out.new_zeros(bs, num_cams, 1, c)],
                              dim=2)
        cam_out = torch.gather(cam_out_p, 2,
                               inv_sel[..., None].expand(-1, -1, -1, c))
        slots = cam_out.sum(dim=1)
        count = visible.float().sum(dim=1).clamp(min=1.0)
        slots = slots / count[..., None].to(slots.dtype)
        return self.output_proj(slots.to(query.dtype)) + identity


class PredictionMSDeformableAttention(nn.Module):
    """Deformable attention of the future decoder (num_levels = memory
    frames for cross-attention, 1 for self-attention)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4, dtype=None,
                 device=None):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        self.proj = _DeformProj(embed_dims, num_heads, num_levels,
                                num_points, dtype=dtype, device=device)
        self.output_proj = Dense(embed_dims, embed_dims, dtype=dtype,
                                 device=device)

    def forward(self, query, value, reference_points,
                spatial_shapes: Sequence[Tuple[int, int]], query_pos):
        """query [bs, Q, C]; value [bs, V, C] or None (self-attention);
        reference_points [bs, Q, num_levels, 2] in [0, 1]; query_pos
        [bs, Q, C]."""
        bs, num_query, _ = query.shape
        if value is None:
            value = query
        identity = query
        query = query + query_pos
        h, lv, p = self.num_heads, self.num_levels, self.num_points
        offsets = self.proj.sampling_offsets(query).reshape(
            bs, num_query, h, lv, p, 2)
        weights = _softmax_weights(self.proj, query,
                                   (bs, num_query, h, lv, p), lv * p)
        value_p = self.proj.value_proj(value).reshape(
            bs, value.shape[1], h, self.embed_dims // h)
        normalizer = torch.tensor([[w_, h_] for (h_, w_) in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        loc = (reference_points[:, :, None, :, None, :] +
               offsets / normalizer[None, None, None, :, None, :])
        out = msdeform_attn(value_p, list(spatial_shapes), loc, weights)
        return self.output_proj(out.to(query.dtype)) + identity
