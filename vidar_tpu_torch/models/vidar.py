"""ViDAR: visual point cloud forecasting (port of the eval entry points of
vidar_tpu/models/vidar.py). ``ForecastRunner`` drives the four phases:
``backbone_forward`` once over every (frame, camera) image,
``encode_single`` once per history frame, ``rollout_single`` once per
future frame, then ``decode_from_features``."""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from .fpn import FPN
from .resnet import ResNet
from .transformer import BEVEncoderHead
from .vidar_head import ViDARHead


def bev_cell_grids(bev_h: int, bev_w: int) -> np.ndarray:
    ys = (np.arange(bev_h, dtype=np.float32) + 0.5) / bev_h
    xs = (np.arange(bev_w, dtype=np.float32) + 0.5) / bev_w
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], -1)


class ViDAR(nn.Module):
    """Takes the keyword configuration of ``vidar_tpu.configs`` presets
    (training-only keys are accepted and unused), plus ``dtype`` (compute
    dtype, None = f32) and ``device``."""

    def __init__(self, embed_dims: int = 256, bev_h: int = 200,
                 bev_w: int = 200,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 num_cams: int = 6, backbone_depth: int = 101,
                 backbone_dcn: Tuple[bool, ...] = (False, False, True, True),
                 frozen_stages: int = 1, future_pred_frame_num: int = 3,
                 test_future_frame_num: int = 6,
                 history_queue_length: int = 4,
                 supervise_all_future: bool = True,
                 pred_history_frame_num: int = 3,
                 pred_future_frame_num: int = 1,
                 per_frame_loss_weight=(0.2, 0.4, 0.6, 1.0, 1.2),
                 loss_weight=((1,), (1,), (1,), (1,), (0,)),
                 num_pred_height: int = 16, ray_grid_num: int = 512,
                 ray_grid_step: float = 1.0, use_ce_loss: bool = True,
                 use_dist_loss: bool = False, use_dense_loss: bool = True,
                 decoder_num_layers: int = 3, encoder_num_layers: int = 6,
                 latent_render_lids: Tuple[int, ...] = (2,),
                 latent_render_cfg: Optional[dict] = None,
                 sca_capacity_ratio: float = 0.5,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.embed_dims, self.bev_h, self.bev_w = embed_dims, bev_h, bev_w
        self.pc_range = tuple(pc_range)
        self.test_future_frame_num = test_future_frame_num
        self.history_queue_length = history_queue_length
        self.pred_history_frame_num = pred_history_frame_num
        self.decoder_num_layers = decoder_num_layers
        kw = dict(dtype=dtype, device=device)
        self.img_backbone = ResNet(depth=backbone_depth,
                                   stage_with_dcn=tuple(backbone_dcn), **kw)
        self.img_neck = FPN((512, 1024, 2048), out_channels=embed_dims,
                            **kw)
        self.pts_bbox_head = BEVEncoderHead(
            embed_dims=embed_dims, bev_h=bev_h, bev_w=bev_w,
            pc_range=pc_range, num_cams=num_cams,
            latent_render_lids=tuple(latent_render_lids),
            latent_render_cfg=latent_render_cfg,
            encoder_num_layers=encoder_num_layers,
            sca_capacity_ratio=sca_capacity_ratio, **kw)
        self.future_pred_head = ViDARHead(
            embed_dims=embed_dims, bev_h=bev_h, bev_w=bev_w,
            pc_range=pc_range, num_pred_height=num_pred_height,
            history_queue_length=history_queue_length,
            pred_history_frame_num=pred_history_frame_num,
            pred_future_frame_num=pred_future_frame_num,
            ray_grid_num=ray_grid_num, ray_grid_step=ray_grid_step,
            decoder_num_layers=decoder_num_layers, **kw)

    @torch.no_grad()
    def randomize_(self, generator: torch.Generator, scale: float = 0.02):
        """Fill every parameter and buffer with N(0, 1) * scale drawn from
        ``generator`` (the benchmark's random weights, bench.py:78-90)."""
        for t in itertools.chain(self.parameters(), self.buffers()):
            t.copy_(torch.randn(t.shape, generator=generator,
                                device=generator.device, dtype=t.dtype)
                    * scale)
        return self

    # ------------------------------------------------------------ phases

    def backbone_forward(self, images_flat):
        """[N, H, W, 3] -> list of [N, h, w, C] FPN maps."""
        return self.img_neck(self.img_backbone(images_flat))

    def encode_single(self, feats, can_bus, shift, rotate_angle, lidar2img,
                      prev_bev, prev_bev_exists, img_hw):
        """One frame's BEV encode. feats: list of [bs, cams, h, w, C]."""
        return self.pts_bbox_head(feats, can_bus, shift, rotate_angle,
                                  lidar2img, img_hw, prev_bev,
                                  prev_bev_exists)

    def _align_future_coords(self, future2ref_t, ref_to_history):
        """(tgt_grids [bs, N, 2], aligned_grids [bs, N, F, 2]) in [0, 1];
        the homogeneous coordinate is [x, y, 1, 1] (z is literally 1)."""
        bs = ref_to_history.shape[0]
        pc = self.pc_range
        n = self.bev_h * self.bev_w
        grids = torch.from_numpy(bev_cell_grids(self.bev_h, self.bev_w)).to(
            future2ref_t.device)
        ones = torch.ones(n, dtype=torch.float32, device=grids.device)
        coords = torch.stack([grids[:, 0] * (pc[3] - pc[0]) + pc[0],
                              grids[:, 1] * (pc[4] - pc[1]) + pc[1],
                              ones, ones], -1)
        fut2hist = torch.einsum('bij,bfjk->bfik', future2ref_t,
                                ref_to_history)
        aligned = torch.einsum('nj,bfjk->bfnk', coords, fut2hist)[..., :2]
        ax = (aligned[..., 0] - pc[0]) / (pc[3] - pc[0])
        ay = (aligned[..., 1] - pc[1]) / (pc[4] - pc[1])
        aligned_grids = torch.stack([ax, ay], -1).permute(0, 2, 1, 3)
        return grids[None].expand(bs, n, 2), aligned_grids

    def rollout_single(self, prev_feats, ref_to_history, future2ref_t,
                       ref2future_t, future_can_bus_sel):
        """prev_feats [bs, 1, N, C], ref_to_history [bs, 1, 4, 4] ->
        (pred [layers, bs, N, C], new ref_to_history)."""
        tgt, aligned = self._align_future_coords(future2ref_t,
                                                 ref_to_history)
        pred = self.future_pred_head.predict_next(
            prev_feats, future_can_bus_sel, tgt, aligned)
        return pred, ref2future_t[:, None]

    def decode_from_features(self, next_bev_feats, gt_points, gt_tindex,
                             cur2ref, ref2cur, num_future: int):
        """[frames, layers, bs, N, C] -> eval decode dict."""
        sigma = self.future_pred_head.forward_head(next_bev_feats)
        sigma_cur = sigma[:, -1, self.pred_history_frame_num]
        return self.future_pred_head.decode_pointcloud(
            sigma_cur, gt_points, gt_tindex, cur2ref, ref2cur,
            num_rollout=num_future + 1)
