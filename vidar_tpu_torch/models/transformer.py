"""Perception transformer and encoder-only BEV head (port of
vidar_tpu/models/transformer.py): learned BEV queries plus the can-bus
embedding, the previous BEV rotated by the yaw delta, camera and level
embeddings on the flattened image features, then the encoder."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.rotate import rotate_bev
from .encoder import BEVFormerEncoder
from .layers import MLP, LearnedPositionalEncoding

# the reference rotates the previous BEV about pixel (100, 100), whatever
# the BEV size (transformer.py:136-151 of the reference)
ROTATE_CENTER = (100, 100)


class PerceptionTransformer(nn.Module):

    def __init__(self, embed_dims: int = 256, num_feature_levels: int = 4,
                 num_cams: int = 6, bev_h: int = 200, bev_w: int = 200,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 encoder_num_layers: int = 6,
                 latent_render_lids: Tuple[int, ...] = (2,),
                 latent_render_cfg: Optional[dict] = None,
                 sca_capacity_ratio: float = 0.5, dtype=None, device=None):
        super().__init__()
        self.bev_h, self.bev_w = bev_h, bev_w
        self.level_embeds = nn.Parameter(torch.empty(
            num_feature_levels, embed_dims, device=device))
        self.cams_embeds = nn.Parameter(torch.empty(num_cams, embed_dims,
                                                    device=device))
        self.can_bus_mlp = MLP(18, (embed_dims // 2, embed_dims), dtype=dtype,
                               device=device)
        self.encoder = BEVFormerEncoder(
            num_layers=encoder_num_layers, embed_dims=embed_dims,
            num_cams=num_cams, pc_range=pc_range, bev_h=bev_h, bev_w=bev_w,
            feedforward_channels=embed_dims * 2,
            sca_num_levels=num_feature_levels,
            sca_capacity_ratio=sca_capacity_ratio,
            latent_render_lids=latent_render_lids,
            latent_render_cfg=latent_render_cfg, dtype=dtype, device=device)

    def get_bev_features(self, mlvl_feats, bev_queries, bev_pos, can_bus,
                         shift, rotate_angle, lidar2img, img_hw, prev_bev,
                         prev_bev_exists):
        """mlvl_feats: list of [bs, cams, h, w, C]; bev_queries [N, C];
        bev_pos [bs, N, C]; can_bus [bs, 18]; shift [bs, 2]; rotate_angle
        [bs] (deg); lidar2img [bs, cams, 4, 4]; prev_bev [bs, N, C];
        prev_bev_exists [bs] bool -> [bs, N, C] f32."""
        bs = mlvl_feats[0].shape[0]
        bev_queries = bev_queries[None].expand(bs, *bev_queries.shape)
        pb = prev_bev.reshape(bs, self.bev_h, self.bev_w, -1)
        pb = rotate_bev(pb, rotate_angle, center=ROTATE_CENTER)
        prev_bev = pb.reshape(bs, self.bev_h * self.bev_w, -1)
        can_bus_emb = self.can_bus_mlp(can_bus.to(bev_queries.dtype))
        bev_queries = bev_queries + can_bus_emb[:, None, :]

        feats, spatial_shapes = [], []
        for lvl, feat in enumerate(mlvl_feats):
            b, cams, h, w, c = feat.shape
            f = feat.reshape(b, cams, h * w, c)
            f = f + self.cams_embeds[None, :, None, :].to(f.dtype)
            f = f + self.level_embeds[None, None, None, lvl].to(f.dtype)
            feats.append(f)
            spatial_shapes.append((h, w))
        cam_value = torch.cat(feats, dim=2)
        return self.encoder(bev_queries, cam_value, tuple(spatial_shapes),
                            bev_pos, lidar2img, img_hw, prev_bev,
                            prev_bev_exists, shift)


class BEVEncoderHead(nn.Module):
    """Owns the learned BEV queries and positional encoding."""

    def __init__(self, embed_dims: int = 256, bev_h: int = 200,
                 bev_w: int = 200,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 num_cams: int = 6, num_feature_levels: int = 4,
                 latent_render_lids: Tuple[int, ...] = (2,),
                 latent_render_cfg: Optional[dict] = None,
                 encoder_num_layers: int = 6, sca_capacity_ratio: float = 0.5,
                 dtype=None, device=None):
        super().__init__()
        self.bev_h, self.bev_w = bev_h, bev_w
        self.bev_embedding = nn.Parameter(torch.empty(
            bev_h * bev_w, embed_dims, device=device))
        self.positional_encoding = LearnedPositionalEncoding(
            embed_dims // 2, bev_h, bev_w, device=device)
        self.transformer = PerceptionTransformer(
            embed_dims=embed_dims, num_feature_levels=num_feature_levels,
            num_cams=num_cams, bev_h=bev_h, bev_w=bev_w, pc_range=pc_range,
            encoder_num_layers=encoder_num_layers,
            latent_render_lids=latent_render_lids,
            latent_render_cfg=latent_render_cfg,
            sca_capacity_ratio=sca_capacity_ratio, dtype=dtype,
            device=device)

    def forward(self, mlvl_feats, can_bus, shift, rotate_angle, lidar2img,
                img_hw, prev_bev, prev_bev_exists):
        bs = mlvl_feats[0].shape[0]
        bev_pos = self.positional_encoding(bs).reshape(
            bs, self.bev_h * self.bev_w, -1)
        return self.transformer.get_bev_features(
            mlvl_feats, self.bev_embedding, bev_pos, can_bus, shift,
            rotate_angle, lidar2img, img_hw, prev_bev, prev_bev_exists)
