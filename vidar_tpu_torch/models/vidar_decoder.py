"""Future-prediction decoder (port of vidar_tpu/models/vidar_decoder.py):
per layer, deformable self-attention at the target-frame coordinates, then
deformable cross-attention over the memory frames at the history-aligned
coordinates (one level per frame), FFN, each followed by LayerNorm. The
released configs use no latent rendering in the decoder."""

from __future__ import annotations

import torch
import torch.nn as nn

from .attention import PredictionMSDeformableAttention
from .layers import FFN, LayerNorm


class PredictionTransformerLayer(nn.Module):

    def __init__(self, embed_dims: int = 256, feedforward_channels: int = 512,
                 num_memory_frames: int = 1, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attentions_0 = PredictionMSDeformableAttention(
            embed_dims=embed_dims, num_levels=1, **kw)
        self.norms_0 = LayerNorm(embed_dims, device)
        self.attentions_1 = PredictionMSDeformableAttention(
            embed_dims=embed_dims, num_levels=num_memory_frames, **kw)
        self.norms_1 = LayerNorm(embed_dims, device)
        self.ffns_0 = FFN(feedforward_channels, embed_dims, **kw)
        self.norms_2 = LayerNorm(embed_dims, device)

    def forward(self, query, prev_feats, tgt_points, ref_points, bev_pos,
                bev_h: int, bev_w: int):
        """query [bs, N, C]; prev_feats [bs, F, N, C]; tgt_points
        [bs, N, 2]; ref_points [bs, N, F, 2]; bev_pos [bs, N, C]."""
        bs, n, c = query.shape
        f = prev_feats.shape[1]
        query = self.attentions_0(query, None, tgt_points[:, :, None, :],
                                  ((bev_h, bev_w),), query_pos=bev_pos)
        query = self.norms_0(query)
        memory = prev_feats.reshape(bs, f * n, c)
        query = self.attentions_1(query, memory, ref_points,
                                  tuple((bev_h, bev_w) for _ in range(f)),
                                  query_pos=bev_pos)
        query = self.norms_1(query)
        query = self.ffns_0(query)
        return self.norms_2(query)


class PredictionDecoder(nn.Module):
    """Stack of layers returning every layer's output [layers, bs, N, C]."""

    def __init__(self, num_layers: int = 3, embed_dims: int = 256,
                 feedforward_channels: int = 512, num_memory_frames: int = 1,
                 dtype=None, device=None):
        super().__init__()
        self.num_layers = num_layers
        for lid in range(num_layers):
            self.add_module(f'layers_{lid}', PredictionTransformerLayer(
                embed_dims, feedforward_channels, num_memory_frames,
                dtype=dtype, device=device))

    def forward(self, bev_query, prev_feats, tgt_points, ref_points, bev_pos,
                bev_h: int, bev_w: int):
        out = []
        query = bev_query
        for lid in range(self.num_layers):
            query = getattr(self, f'layers_{lid}')(
                query, prev_feats, tgt_points, ref_points, bev_pos, bev_h,
                bev_w)
            out.append(query)
        return torch.stack(out)
