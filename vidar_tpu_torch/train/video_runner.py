"""Video-replay train step (port of vidar_tpu/train/video_runner.py, the
reference's EpochBasedRunner_video, bevformer/runner/
epoch_based_runner.py:18-97, with hooks/custom_hooks.py:5-13
``TransferWeight``): a frozen copy of the parameters replays the sample's
history under ``torch.no_grad()`` to produce ``prev_bev``, then ONE
gradient step trains on the current frame alone. Registered but unused by
the released configs.

The frozen copy is ``eval_params`` (a state dict), the current parameters
where it is not given: TransferWeight copies the train weights into the
eval model every iteration, so the two are the same."""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from ..models.vidar import eval_mode
from ..parallel.mesh import global_sum
from .step import _Step


@contextlib.contextmanager
def _weights(model, state: Optional[dict]):
    """``model`` holding ``state``'s tensors inside (none swapped where it
    is None); its own are restored after."""
    if state is None:
        yield
        return
    own = {k: v.detach().clone() for k, v in model.state_dict().items()
           if k in state}
    with torch.no_grad():
        model.load_state_dict(state, strict=False)
    try:
        yield
    finally:
        with torch.no_grad():
            model.load_state_dict(own, strict=False)


class VideoTrainStep(_Step):
    """``step(batch, eval_params=None) -> metrics`` for a ``ViDAR``: the
    history frames encoded without gradient by ``eval_params``, the
    current frame (the camera-sequential backbone, no grid mask) encoded
    with gradient, its BEV broadcast over the decoder layers into
    ``future_pred_head.forward_head``, the loss with ``num_rollout=1``
    (the current-frame channel alone), the backward pass and the clipped
    update. Dropout is off throughout, as JAX's step runs every module
    deterministic; ``generator`` draws the Gumbel noise of the dense loss
    (None: argmax). -> every loss, ``loss`` and ``grad_norm``."""

    def __call__(self, batch, eval_params: Optional[dict] = None
                 ) -> Dict[str, float]:
        m = self.model
        batch = batch.to(self.device)
        img_hw = tuple(batch.images.shape[3:5])
        t = batch.images.shape[1]
        self.optimizer.zero_grad(set_to_none=True)
        with eval_mode(m):
            with _weights(m, eval_params), torch.no_grad():
                feats = m.extract_feats(batch.images[:, :-1])
                prev_bev = m.encode_history(feats, batch, img_hw, t - 1)
            del feats
            cur = m.extract_feats_cam_seq(batch.images[:, -1])
            ref_bev = m.encode_single(
                cur, batch.can_bus[:, t - 1], batch.shift[:, t - 1],
                batch.rotate_angle[:, t - 1], batch.lidar2img[:, t - 1],
                prev_bev, batch.prev_bev_exists[:, t - 1], img_hw)
            head = m.future_pred_head
            stack = ref_bev[None, None].expand(1, m.decoder_num_layers,
                                               *ref_bev.shape)
            sigma = head.forward_head(stack)
            missing = (~batch.prev_bev_exists[:, 1:]).sum()
            losses = head.loss(sigma[:, -1].permute(1, 0, 2, 3, 4),
                               batch.gt_points, batch.gt_tindex,
                               batch.cur2ref, batch.ref2cur, num_rollout=1,
                               full_prev_bev_exists=global_sum(missing) == 0,
                               generator=self.generator)
        return self._update(losses)


def make_video_train_step(model, optimizer, *,
                          generator: Optional[torch.Generator] = None,
                          device='cuda') -> VideoTrainStep:
    """The video-replay step of ``model`` under ``optimizer``
    (``train.make_optimizer``); call it as ``step(batch, eval_params=None)``
    (``make_video_train_step``, video_runner.py:23)."""
    return VideoTrainStep(model, optimizer, generator=generator,
                          device=device)
