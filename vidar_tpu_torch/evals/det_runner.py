"""Detection eval runner (port of the per-sample body of ``det_eval``,
vidar_tpu/tools/test.py:84-148): one sample through ``BEVFormer``, its
NMS-free decode, and the numpy entries that ``evaluate_detection`` takes.

Two modes, as ``tools/test.py --streaming`` chooses:
* full window: the window forward (every history frame re-encoded), then
  ``get_bboxes``;
* streaming: the current frame's can-bus, shift and yaw delta rebased
  against the previous frame on the host (``StreamingRebase``), then one
  ``streaming_test`` step on the cached BEV, then ``get_bboxes``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.bevformer import StreamState
from .detection import infer_attributes
from .streaming import StreamingRebase

CLASS_NAMES = ('car', 'truck', 'construction_vehicle', 'bus', 'trailer',
               'barrier', 'motorcycle', 'bicycle', 'pedestrian',
               'traffic_cone')


class DetectionRunner:
    """``runner(det_batch, meta=None) -> (prediction, ground_truth)`` for a
    batch of one sample, dropout off. ``meta`` (streaming only) is the
    frame's raw ``can_bus`` [18], ``scene_token`` and ``l2g_rot`` [3, 3];
    the stream resets itself on a new scene token. ``class_names`` name the
    labels for the inferred attributes."""

    def __init__(self, model, *, streaming: bool = False, device='cuda',
                 class_names=CLASS_NAMES):
        self.model = model
        self.streaming = streaming
        self.class_names = tuple(class_names)
        self.device = resolve_device(device)
        self.rebase = StreamingRebase(bev_size=(model.bev_h, model.bev_w),
                                      pc_range=model.pc_range)
        self.state: Optional[StreamState] = None

    def reset(self):
        self.rebase.reset()
        self.state = None

    def _decode(self, batch, meta):
        """The NMS-free decode of the batch's one sample: dict of [1, K,
        ...] tensors (bboxes, scores, labels, valid)."""
        m = self.model
        frames = batch.frames.to(self.device)
        if frames.images.shape[0] != 1:
            raise ValueError('DetectionRunner takes one sample per batch')
        with torch.inference_mode():
            if not self.streaming:
                return m.get_bboxes(m(frames, train=False))
            rb = self.rebase.step(meta)
            t = frames.images.shape[1] - 1
            fields = {}
            for name in ('can_bus', 'shift', 'rotate_angle'):
                v = getattr(frames, name).clone()
                v[:, t] = torch.as_tensor(rb[name], device=self.device)
                fields[name] = v
            frames = dataclasses.replace(frames, **fields)
            if self.state is None:
                self.state = m.init_stream(1, self.device)
            state = StreamState(
                prev_bev=self.state.prev_bev,
                has_prev=torch.full((1,), bool(rb['has_prev']),
                                    device=self.device))
            preds, self.state = m.streaming_test(frames, state)
            return m.get_bboxes(preds)

    def __call__(self, batch, meta: Optional[Dict] = None
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """-> (prediction: the valid boxes, scores, labels and inferred
        attributes; ground truth: the sample's valid GT boxes and labels),
        as ``evaluate_detection`` takes them."""
        # a bf16 model decodes bf16 boxes and scores, which numpy has no
        # type for: f32 holds each of them exactly
        det = {k: (v[0].float() if v.is_floating_point() else v[0]
                   ).cpu().numpy()
               for k, v in self._decode(batch, meta).items()}
        valid = det['valid']
        boxes, labels = det['bboxes'][valid], det['labels'][valid]
        prediction = dict(boxes=boxes, scores=det['scores'][valid],
                          labels=labels,
                          attrs=infer_attributes(boxes, labels,
                                                 self.class_names))
        g = int(batch.num_valid_gt[0])
        ground_truth = dict(boxes=batch.gt_bboxes[0, :g].cpu().numpy(),
                            labels=batch.gt_labels[0, :g].cpu().numpy())
        return prediction, ground_truth
