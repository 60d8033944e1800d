"""Streaming (video) evaluation: host-side ego-motion rebasing (the port's
own copy of vidar_tpu/evals/streaming.py and of
``vidar_tpu.data.nuscenes.compute_bev_shift``, plain numpy).

The reference's streaming ``forward_test`` (projects/mmdet3d_plugin/
bevformer/detectors/bevformer.py:291-324) caches the previous frame's BEV
plus its raw ego pos/angle in ``prev_frame_info``; each new frame's
can_bus is rebased to the delta against that cache, resets on scene
change, and the (pos, angle) cache is updated from the RAW values.
:class:`StreamingRebase` runs that state machine on the host and produces
the ``(can_bus, shift, rotate_angle, has_prev)`` that
``BEVFormer.streaming_test`` consumes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def compute_bev_shift(can_bus_rebased: np.ndarray, l2g_rot: np.ndarray,
                      bev_size, pc_range) -> np.ndarray:
    """BEV-grid ego-motion shift from a rebased can_bus delta: the
    global-frame translation delta rotated into the lidar frame and
    normalised by the BEV cell size (reference modules/transformer.py:
    120-134)."""
    bev_h, bev_w = bev_size
    grid_len_y = (pc_range[4] - pc_range[1]) / bev_h
    grid_len_x = (pc_range[3] - pc_range[0]) / bev_w
    delta = np.linalg.inv(l2g_rot) @ np.asarray(can_bus_rebased[:3],
                                                np.float64)
    return np.array([delta[0] / grid_len_x / bev_w,
                     delta[1] / grid_len_y / bev_h], np.float32)


class StreamingRebase:
    """Per-stream cache mirroring the reference's ``prev_frame_info``."""

    def __init__(self, bev_size=(200, 200),
                 pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)):
        self.bev_size = bev_size
        self.pc_range = pc_range
        self.scene_token: Optional[str] = None
        self.prev_pos: Optional[np.ndarray] = None
        self.prev_angle: Optional[float] = None

    def reset(self):
        self.scene_token = None
        self.prev_pos = None
        self.prev_angle = None

    def step(self, meta: Dict) -> Dict:
        """Rebase one streamed frame.

        Args:
          meta: dict with raw ``can_bus`` (pos in [:3], patch angle in
            [-1]), ``scene_token`` and ``l2g_rot``.

        Returns dict(can_bus [18], shift [2], rotate_angle scalar,
        has_prev bool). ``has_prev`` is False on the first frame of a
        scene: the cached prev_bev is then ignored (reference
        bevformer.py:298-301).
        """
        cb = np.asarray(meta['can_bus'], np.float64).copy()
        raw_pos = cb[:3].copy()
        raw_angle = float(cb[-1])
        has_prev = (self.scene_token == meta['scene_token']
                    and self.prev_pos is not None)
        if has_prev:
            cb[:3] = raw_pos - self.prev_pos
            cb[-1] = raw_angle - self.prev_angle
        else:
            cb[:3] = 0.0
            cb[-1] = 0.0
        self.scene_token = meta['scene_token']
        self.prev_pos = raw_pos
        self.prev_angle = raw_angle
        shift = compute_bev_shift(cb, meta['l2g_rot'], self.bev_size,
                                  self.pc_range)
        return dict(can_bus=cb.astype(np.float32), shift=shift,
                    rotate_angle=np.float32(cb[-1]), has_prev=has_prev)
