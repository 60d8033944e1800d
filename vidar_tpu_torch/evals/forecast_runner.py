"""Phase-wise forecast runner (port of vidar_tpu/evals/forecast_runner.py):
the serving eval path. The host loop drives one backbone pass over every
(frame, camera) image, one encode per history frame (the BEV carry stays
f32), one rollout step per future frame, then the head and depth decode;
each phase is a ``core.timing`` span (``forecast/backbone``,
``forecast/encode``, ``forecast/rollout``, ``forecast/decode``), so it
shows in a torch profiler trace.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.timing import timer
from ..models.vidar import eval_mode


class ForecastRunner:

    def __init__(self, model, img_hw, *, num_future: int, device):
        self.model = model
        self.img_hw = tuple(img_hw)
        self.num_future = num_future
        self.device = torch.device(device)

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        """Forecast with dropout off, whatever the model's mode: one
        backbone pass over the whole window (frames are independent through
        the conv stack), the encode of every frame, the rollout, the
        decode."""
        m = self.model
        with torch.inference_mode(), eval_mode(m):
            batch = batch.to(self.device)
            with timer('forecast/backbone'):
                feats = m.extract_feats(batch.images)
            with timer('forecast/encode'):
                bev = m.encode_history(feats, batch, self.img_hw,
                                       batch.images.shape[1])
            with timer('forecast/rollout'):
                preds = m.rollout(bev, batch, self.num_future)
            stack = bev[None, None].expand(1, m.decoder_num_layers,
                                           *bev.shape)
            with timer('forecast/decode'):
                return m.decode_from_features(
                    torch.cat([stack, preds]), batch.gt_points,
                    batch.gt_tindex, batch.cur2ref, batch.ref2cur,
                    self.num_future)
