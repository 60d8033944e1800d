"""Phase-wise forecast runner (port of vidar_tpu/evals/forecast_runner.py):
the serving eval path. The host loop drives one backbone pass over every
(frame, camera) image, one encode per history frame (the BEV carry stays
f32), one rollout step per future frame, then the head and depth decode.
"""

from __future__ import annotations

from typing import Dict

import torch


class ForecastRunner:

    def __init__(self, model, img_hw, *, num_future: int, device):
        self.model = model
        self.img_hw = tuple(img_hw)
        self.num_future = num_future
        self.device = torch.device(device)

    @torch.inference_mode()
    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        m = self.model
        batch = batch.to(self.device)
        bs, t, cams, h, w, _ = batch.images.shape
        prev_bev = torch.zeros(bs, m.bev_h * m.bev_w, m.embed_dims,
                               dtype=torch.float32, device=self.device)
        # one backbone pass for the whole window: frames are independent
        # through the conv stack
        feats_all = m.backbone_forward(
            batch.images.reshape(bs * t * cams, h, w, 3))
        feats_all = [x.reshape((bs, t, cams) + tuple(x.shape[1:]))
                     for x in feats_all]
        for f in range(t):
            prev_bev = m.encode_single(
                [x[:, f] for x in feats_all], batch.can_bus[:, f],
                batch.shift[:, f], batch.rotate_angle[:, f],
                batch.lidar2img[:, f], prev_bev, batch.prev_bev_exists[:, f],
                self.img_hw)

        layers = m.decoder_num_layers
        next_feats = [prev_bev[None].expand(layers, *prev_bev.shape)]
        hq = m.history_queue_length
        can_bus_dims = list(m.future_pred_head.can_bus_dims)
        prev_feats = prev_bev[:, None]
        ref2hist = batch.ref2cur[:, hq][:, None]
        for fi in range(1, self.num_future + 1):
            pred, ref2hist = m.rollout_single(
                prev_feats, ref2hist, batch.future2ref[:, fi],
                batch.ref2future[:, fi],
                batch.future_can_bus[:, fi][:, can_bus_dims])
            next_feats.append(pred)
            prev_feats = pred[-1][:, None]
        stacked = torch.stack(next_feats, dim=0)
        return m.decode_from_features(stacked, batch.gt_points,
                                      batch.gt_tindex, batch.cur2ref,
                                      batch.ref2cur, self.num_future)
