"""ViDAR future-prediction head (port of the eval methods of
vidar_tpu/models/vidar_head.py): decoder-input assembly and one
autoregressive step (``predict_next``), the per-layer multi-frame heads
(``forward_head``) and the argmax point-cloud decode
(``decode_pointcloud``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from . import ray_loss
from .layers import MLP, LearnedPositionalEncoding, TorchLinear
from .vidar_decoder import PredictionDecoder


class ViDARHead(nn.Module):

    def __init__(self, embed_dims: int = 256, bev_h: int = 200,
                 bev_w: int = 200,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 num_pred_height: int = 16,
                 can_bus_dims: Tuple[int, ...] = (0, 1, 2, 17),
                 history_queue_length: int = 4,
                 pred_history_frame_num: int = 3,
                 pred_future_frame_num: int = 1, ray_grid_num: int = 512,
                 ray_grid_step: float = 1.0, decoder_num_layers: int = 3,
                 dtype=None, device=None):
        super().__init__()
        self.embed_dims, self.bev_h, self.bev_w = embed_dims, bev_h, bev_w
        self.pc_range = tuple(pc_range)
        self.num_pred_height = num_pred_height
        self.can_bus_dims = tuple(can_bus_dims)
        self.history_queue_length = history_queue_length
        self.pred_history_frame_num = pred_history_frame_num
        self.pred_frame_num = 1 + pred_history_frame_num + pred_future_frame_num
        self.ray_grid_num, self.ray_grid_step = ray_grid_num, ray_grid_step
        self.decoder_num_layers = decoder_num_layers
        self.bev_embedding = nn.Parameter(torch.empty(
            bev_h * bev_w, embed_dims, device=device))
        self.prev_frame_embedding = nn.Parameter(torch.empty(
            1, embed_dims, device=device))
        self.can_bus_mlp = MLP(len(can_bus_dims),
                               (embed_dims // 2, embed_dims), dtype=dtype,
                               device=device)
        self.positional_encoding = LearnedPositionalEncoding(
            embed_dims // 2, bev_h, bev_w, device=device)
        self.transformer = PredictionDecoder(
            num_layers=decoder_num_layers, embed_dims=embed_dims,
            feedforward_channels=embed_dims * 2, dtype=dtype, device=device)
        for lvl in range(decoder_num_layers):
            self.add_module(f'bev_pred_head_{lvl}_out', TorchLinear(
                embed_dims, self.pred_frame_num * num_pred_height,
                dtype=dtype, device=device))

    def predict_next(self, prev_feats, future_can_bus, tgt_points,
                     ref_points):
        """prev_feats [bs, F, N, C] memory frames; future_can_bus
        [bs, len(can_bus_dims)]; tgt_points [bs, N, 2]; ref_points
        [bs, N, F, 2] -> [layers, bs, N, C]."""
        bs = prev_feats.shape[0]
        queries = self.bev_embedding[None].expand(bs,
                                                  *self.bev_embedding.shape)
        can_emb = self.can_bus_mlp(future_can_bus.to(queries.dtype))
        queries = queries + can_emb[:, None, :]
        bev_pos = self.positional_encoding(bs).reshape(
            bs, self.bev_h * self.bev_w, -1)
        prev_in = prev_feats + self.prev_frame_embedding[None, :, None, :]
        return self.transformer(queries, prev_in, tgt_points, ref_points,
                                bev_pos, self.bev_h, self.bev_w)

    def forward_head(self, next_bev_feats):
        """[frames, layers, bs, N, C] -> [frames, layers, pred_frame_num,
        bs, N, Z]; channels other than the current frame's are residuals on
        it."""
        outs = []
        cur = self.pred_history_frame_num
        for lvl in range(self.decoder_num_layers):
            x = getattr(self, f'bev_pred_head_{lvl}_out')(
                next_bev_feats[:, lvl])
            f, bs, n, _ = x.shape
            x = x.reshape(f, bs, n, self.num_pred_height,
                          self.pred_frame_num)
            base = x[..., cur:cur + 1]
            x = torch.cat([x[..., :cur] + base, base, x[..., cur + 1:] + base],
                          dim=-1)
            outs.append(x.permute(0, 4, 1, 2, 3))
        return torch.stack(outs, dim=1)

    def _channel_frame_transforms(self, cur2ref, ref2cur, channel: int,
                                  num_rollout: int):
        """src->tgt 4x4s [bs, V, 4, 4] for one prediction channel."""
        hq = self.history_queue_length
        start = hq - self.pred_history_frame_num + channel
        src = cur2ref[:, start:start + num_rollout]
        tgt = ref2cur[:, hq:hq + num_rollout]
        return torch.einsum('bvij,bvjk->bvik', src, tgt)

    def _reanchor_points(self, gt_points, gt_tindex, src_to_tgt, channel: int,
                         num_rollout: int):
        """GT points into their channel's target frame -> (pts [bs, P, 3],
        frame_idx [bs, P] in [0, V) or -1, origins [bs, V, 3])."""
        start = self.history_queue_length - self.pred_history_frame_num + \
            channel
        tindex = gt_tindex.to(torch.int64)
        v_idx = tindex - start
        valid = (v_idx >= 0) & (v_idx < num_rollout) & (tindex >= 0)
        v_safe = v_idx.clamp(0, num_rollout - 1)
        bs, p = v_safe.shape
        mats = torch.gather(src_to_tgt, 1, v_safe[:, :, None, None].expand(
            bs, p, 4, 4))
        homo = torch.cat([gt_points, torch.ones_like(gt_points[..., :1])], -1)
        pts = torch.einsum('bpj,bpjk->bpk', homo, mats)[..., :3]
        origin_h = torch.tensor([0.0, 0.0, 0.0, 1.0], device=gt_points.device)
        origins = torch.einsum('j,bvjk->bvk', origin_h, src_to_tgt)[..., :3]
        frame_idx = torch.where(valid, v_idx, torch.full_like(v_idx, -1))
        return pts, frame_idx, origins

    def decode_pointcloud(self, sigma_cur, gt_points, gt_tindex, cur2ref,
                          ref2cur, num_rollout: int):
        """sigma_cur [V, bs, N, Z] -> dict of pred/gt distances (metric),
        per-ray frame index, re-anchored GT points and frame origins."""
        zdim = self.num_pred_height
        v, bs, n, _ = sigma_cur.shape
        sigma_vol = sigma_cur.permute(1, 0, 3, 2).reshape(
            bs, v, zdim, self.bev_h, self.bev_w)
        cur = self.pred_history_frame_num
        s2t = self._channel_frame_transforms(cur2ref, ref2cur, cur,
                                             num_rollout)
        pts, frame_idx, origins = self._reanchor_points(
            gt_points, gt_tindex, s2t, cur, num_rollout)
        gt_grids = ray_loss.coords_to_voxel_grids(
            pts, self.bev_h, self.bev_w, zdim, self.pc_range)
        origin_grids = ray_loss.coords_to_voxel_grids(
            origins, self.bev_h, self.bev_w, zdim, self.pc_range)
        pred_dist, gt_dist = ray_loss.argmax_ray_depth(
            sigma_vol, origin_grids, gt_grids, frame_idx, self.ray_grid_num,
            self.ray_grid_step)
        sf = (self.pc_range[3] - self.pc_range[0]) / self.bev_w
        return dict(pred_dist=pred_dist * sf, gt_dist=gt_dist * sf,
                    frame_idx=frame_idx, gt_points_ref=pts, origins=origins)
