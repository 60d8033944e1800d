"""BEVFormer spatiotemporal encoder (port of vidar_tpu/models/encoder.py):
TSA -> LN -> SCA -> LN -> [latent rendering] -> FFN -> LN per layer, with
the TSA queue's current slot refreshed after the latent-render layers."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from .attention import (SpatialCrossAttention, TemporalSelfAttention,
                        sca_compaction)
from .latent_rendering import LatentRendering
from .layers import FFN, LayerNorm

NUM_POINTS_IN_PILLAR = 4  # Z anchors per BEV pillar


def reference_points_3d(bev_h: int, bev_w: int, z_range: float,
                        num_points_in_pillar: int) -> np.ndarray:
    """Pillar reference points, [D, H*W, 3] normalised to [0, 1]."""
    d = num_points_in_pillar
    zs = np.linspace(0.5, z_range - 0.5, d, dtype=np.float32) / z_range
    xs = (np.arange(bev_w, dtype=np.float32) + 0.5) / bev_w
    ys = (np.arange(bev_h, dtype=np.float32) + 0.5) / bev_h
    gx, gy = np.meshgrid(xs, ys)
    gx = gx.reshape(-1)
    gy = gy.reshape(-1)
    return np.stack([
        np.broadcast_to(gx[None], (d, bev_h * bev_w)),
        np.broadcast_to(gy[None], (d, bev_h * bev_w)),
        np.broadcast_to(zs[:, None], (d, bev_h * bev_w)),
    ], axis=-1)


def reference_points_2d(bev_h: int, bev_w: int) -> np.ndarray:
    """BEV-plane reference points [H*W, 2] in [0, 1]."""
    ys = (np.arange(bev_h, dtype=np.float32) + 0.5) / bev_h
    xs = (np.arange(bev_w, dtype=np.float32) + 0.5) / bev_w
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def point_sampling(ref_3d: torch.Tensor, pc_range: Sequence[float],
                   lidar2img: torch.Tensor, img_hw: Tuple[int, int]):
    """Project pillar points into every camera, in f32.

    ref_3d [D, N, 3] in [0, 1]; lidar2img [bs, cams, 4, 4]. Returns
    ref_cam [cams, bs, N, D, 2] in [0, 1] and bev_mask [cams, bs, N, D].
    """
    pc = pc_range
    ref = ref_3d.float()
    xyz = torch.stack([
        ref[..., 0] * (pc[3] - pc[0]) + pc[0],
        ref[..., 1] * (pc[4] - pc[1]) + pc[1],
        ref[..., 2] * (pc[5] - pc[2]) + pc[2],
    ], dim=-1)
    homo = torch.cat([xyz, torch.ones_like(xyz[..., :1])], -1)
    proj = torch.einsum('bcij,dnj->bcdni', lidar2img.float(), homo)
    eps = 1e-5
    z = proj[..., 2:3]
    mask = z > eps
    xy = proj[..., 0:2] / torch.clamp(z, min=eps)
    h, w = img_hw
    x = xy[..., 0] / w
    y = xy[..., 1] / h
    mask = mask[..., 0] & (y > 0.0) & (y < 1.0) & (x > 0.0) & (x < 1.0)
    ref_cam = torch.stack([x, y], -1).permute(1, 0, 3, 2, 4)
    bev_mask = mask.permute(1, 0, 3, 2)
    return ref_cam, bev_mask


def sca_overflow_count(lidar2img: torch.Tensor, img_hw: Tuple[int, int],
                       bev_h: int, bev_w: int, pc_range: Sequence[float],
                       capacity_ratio: float,
                       num_points_in_pillar: int = NUM_POINTS_IN_PILLAR
                       ) -> torch.Tensor:
    """The visible queries the SCA's static capacity drops, worst case over
    every (frame, camera) of lidar2img [..., cams, 4, 4]: max(visible - cap,
    0) as an int32 scalar, 0 for a ratio outside (0, 1)
    (vidar_tpu/models/encoder.py:105-132)."""
    if not 0 < capacity_ratio < 1:
        return torch.zeros((), dtype=torch.int32, device=lidar2img.device)
    cap = int(bev_h * bev_w * capacity_ratio)
    ref_3d = torch.from_numpy(reference_points_3d(
        bev_h, bev_w, pc_range[5] - pc_range[2], num_points_in_pillar)).to(
            lidar2img.device)
    l2i = lidar2img.reshape((-1,) + tuple(lidar2img.shape[-3:]))
    _, bev_mask = point_sampling(ref_3d, pc_range, l2i, img_hw)
    vis = bev_mask.any(dim=-1).sum(dim=2)            # [cams, bs*frames]
    return torch.clamp(vis.max() - cap, min=0).to(torch.int32)


class BEVFormerLayer(nn.Module):
    """TSA -> LN -> SCA -> LN -> [latent render] -> FFN -> LN."""

    def __init__(self, embed_dims: int = 256, feedforward_channels: int = 512,
                 num_cams: int = 6, sca_num_levels: int = 4,
                 with_latent_render: bool = False,
                 latent_render_cfg: Optional[dict] = None, bev_h: int = 200,
                 bev_w: int = 200, dtype=None, device=None):
        super().__init__()
        self.bev_h, self.bev_w = bev_h, bev_w
        kw = dict(dtype=dtype, device=device)
        self.attentions_0 = TemporalSelfAttention(embed_dims=embed_dims, **kw)
        self.norms_0 = LayerNorm(embed_dims, device)
        self.attentions_1 = SpatialCrossAttention(
            embed_dims=embed_dims, num_cams=num_cams,
            deform_num_levels=sca_num_levels, **kw)
        self.norms_1 = LayerNorm(embed_dims, device)
        self.latent_render = (LatentRendering(**(latent_render_cfg or {}),
                                              **kw)
                              if with_latent_render else None)
        self.ffns_0 = FFN(feedforward_channels, embed_dims, **kw)
        self.norms_2 = LayerNorm(embed_dims, device)

    def forward(self, query, value_pair, ref_2d_pair, cam_value, bev_pos,
                spatial_shapes, sca_compact):
        bs = query.shape[0]
        query = self.attentions_0(query, value_pair, ref_2d_pair, self.bev_h,
                                  self.bev_w, bev_pos)
        query = self.norms_0(query)
        query = self.attentions_1(query, cam_value, spatial_shapes,
                                  sca_compact)
        query = self.norms_1(query)
        if self.latent_render is not None:
            query = self.latent_render(
                query.reshape(bs, self.bev_h, self.bev_w, -1))
            query = query.reshape(bs, self.bev_h * self.bev_w, -1)
        query = self.ffns_0(query)
        return self.norms_2(query)


class BEVFormerEncoder(nn.Module):
    """Encoder layers with latent rendering at ``latent_render_lids``."""

    def __init__(self, num_layers: int = 6, embed_dims: int = 256,
                 num_cams: int = 6,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 bev_h: int = 200,
                 bev_w: int = 200, feedforward_channels: int = 512,
                 sca_num_levels: int = 4, sca_capacity_ratio: float = 0.5,
                 latent_render_lids: Tuple[int, ...] = (2,),
                 latent_render_cfg: Optional[dict] = None, dtype=None,
                 device=None):
        super().__init__()
        self.num_layers = num_layers
        self.pc_range = tuple(pc_range)
        self.bev_h, self.bev_w = bev_h, bev_w
        self.sca_capacity_ratio = sca_capacity_ratio
        self.latent_render_lids = tuple(latent_render_lids)
        for lid in range(num_layers):
            self.add_module(f'layers_{lid}', BEVFormerLayer(
                embed_dims=embed_dims,
                feedforward_channels=feedforward_channels,
                num_cams=num_cams, sca_num_levels=sca_num_levels,
                with_latent_render=lid in self.latent_render_lids,
                latent_render_cfg=latent_render_cfg, bev_h=bev_h,
                bev_w=bev_w, dtype=dtype, device=device))

    def forward(self, bev_query, cam_value, spatial_shapes, bev_pos,
                lidar2img, img_hw, prev_bev, prev_bev_exists, shift):
        """bev_query [bs, N, C]; cam_value [bs, cams, V, C]; bev_pos
        [bs, N, C]; lidar2img [bs, cams, 4, 4]; prev_bev [bs, N, C] (ignored
        where ~prev_bev_exists [bs]); shift [bs, 2] in BEV grid fractions."""
        bs, n, _ = bev_query.shape
        dev = bev_query.device
        z_range = self.pc_range[5] - self.pc_range[2]
        ref_3d = torch.from_numpy(reference_points_3d(
            self.bev_h, self.bev_w, z_range, NUM_POINTS_IN_PILLAR)).to(dev)
        ref_2d = torch.from_numpy(reference_points_2d(
            self.bev_h, self.bev_w)).to(dev)[None].expand(bs, n, 2)
        ref_cam, bev_mask = point_sampling(ref_3d, self.pc_range, lidar2img,
                                           img_hw)
        exists = prev_bev_exists.reshape(bs, 1, 1)
        exists4 = prev_bev_exists.reshape(bs, 1, 1, 1)
        ref_prev = torch.where(exists, ref_2d + shift[:, None, :], ref_2d)
        # [bs, 2, N, 1, 2]: slot 0 = prev refs (shifted), slot 1 = current
        ref_pair = torch.stack([ref_prev, ref_2d], dim=1)[:, :, :, None, :]
        prev_slot = torch.where(exists, prev_bev, bev_query)
        value_pair = torch.stack([prev_slot, bev_query], dim=1)

        # the SCA plan is geometry only: built once per frame; a ratio
        # outside (0, 1) keeps every query
        cap = (int(n * self.sca_capacity_ratio)
               if 0 < self.sca_capacity_ratio < 1 else n)
        sca_compact = sca_compaction(ref_cam, bev_mask, cap)
        query = bev_query
        for lid in range(self.num_layers):
            # without a previous BEV, TSA sees [query, query] of this layer
            layer_value_pair = torch.where(
                exists4, value_pair, torch.stack([query, query], dim=1))
            query = getattr(self, f'layers_{lid}')(
                query, layer_value_pair, ref_pair, cam_value, bev_pos,
                spatial_shapes, sca_compact)
            if lid in self.latent_render_lids:
                value_pair = torch.where(
                    exists4, torch.stack([value_pair[:, 0], query], dim=1),
                    value_pair)
        return query
