"""BEVFormer detector, the detection fine-tune (port of
vidar_tpu/models/bevformer.py:29-176).

A frozen recurrence of BEV encodes over the history frames, with a gradient
window over the last ``backwarded_prev_frame_num`` of them in training, then
the current frame's encode and the DETR head (``BEVFormerHead``). Module
names follow the flax tree (``img_backbone``, ``img_neck``,
``pts_bbox_head_bev``, ``pts_bbox_head_det``), so ``state_dict_from_jax``
fills the model with ``strict=True``. ``streaming_test`` is the one-frame
step of the streaming eval, its cache an explicit ``StreamState``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..device import resolve_device
from .detection import BEVFormerHead
from .fpn import FPN
from .grid_mask import grid_mask
from .resnet import ResNet
from .transformer import BEVEncoderHead
from .vidar import CameraModel, eval_mode


@dataclasses.dataclass
class StreamState:
    """Streaming-eval cache (reference prev_frame_info, bevformer.py:60-66)."""
    prev_bev: torch.Tensor     # [bs, H*W, C] f32
    has_prev: torch.Tensor     # [bs] bool


class BEVFormer(CameraModel, nn.Module):
    """Takes the keyword configuration of the fine-tune config's ``model``
    dict (``configs.vidar_finetune_1_8_nusc_3future``), plus ``dtype``
    (compute dtype, None = f32) and ``device`` (the card unless the caller
    asks for the CPU)."""

    def __init__(self, embed_dims: int = 256, bev_h: int = 200,
                 bev_w: int = 200,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 num_cams: int = 6, num_classes: int = 10,
                 num_query: int = 900, backbone_depth: int = 101,
                 backbone_dcn: Tuple[bool, ...] = (False, False, True, True),
                 frozen_stages: int = 1, use_grid_mask: bool = True,
                 backwarded_prev_frame_num: int = 0,
                 encoder_num_layers: int = 6,
                 latent_render_lids: Tuple[int, ...] = (2,),
                 latent_render_cfg: Optional[dict] = None,
                 sca_capacity_ratio: float = 0.5,
                 dtype: Optional[torch.dtype] = None, device='cuda'):
        super().__init__()
        device = resolve_device(device)
        self.embed_dims, self.bev_h, self.bev_w = embed_dims, bev_h, bev_w
        self.pc_range = tuple(pc_range)
        self.use_grid_mask = use_grid_mask
        self.backwarded_prev_frame_num = backwarded_prev_frame_num
        self.sca_capacity_ratio = sca_capacity_ratio
        kw = dict(dtype=dtype, device=device)
        self.img_backbone = ResNet(depth=backbone_depth,
                                   stage_with_dcn=tuple(backbone_dcn),
                                   frozen_stages=frozen_stages, **kw)
        self.img_neck = FPN((512, 1024, 2048), out_channels=embed_dims,
                            **kw)
        self.pts_bbox_head_bev = BEVEncoderHead(
            embed_dims=embed_dims, bev_h=bev_h, bev_w=bev_w,
            pc_range=pc_range, num_cams=num_cams,
            latent_render_lids=tuple(latent_render_lids),
            latent_render_cfg=latent_render_cfg,
            encoder_num_layers=encoder_num_layers,
            sca_capacity_ratio=sca_capacity_ratio, **kw)
        self.pts_bbox_head_det = BEVFormerHead(
            num_classes=num_classes, num_query=num_query,
            embed_dims=embed_dims, bev_h=bev_h, bev_w=bev_w,
            pc_range=pc_range, **kw)

    def encode_frame(self, feats, batch, t: int, prev_bev, exists, img_hw):
        """Frame t's BEV encode. feats: list of [bs, cams, h, w, C]."""
        return self.pts_bbox_head_bev(
            feats, batch.can_bus[:, t], batch.shift[:, t],
            batch.rotate_angle[:, t], batch.lidar2img[:, t], img_hw,
            prev_bev, exists)

    def obtain_history_bev(self, feats, batch, img_hw, *, num_prev: int,
                           train: bool):
        """The recurrence over the first ``num_prev`` frames of feats (list
        of [bs, T, cams, h, w, C], no gradient) -> prev_bev [bs, N, C] f32.
        A frame is encoded frozen (no gradient, dropout off) unless it is
        one of the last ``backwarded_prev_frame_num`` in training, which
        carry the gradient through the BEV head, dropout following
        ``train()`` (bevformer.py:95-115)."""
        bs = batch.images.shape[0]
        back_n = self.backwarded_prev_frame_num if train else 0
        prev_bev = torch.zeros(bs, self.bev_h * self.bev_w, self.embed_dims,
                               dtype=torch.float32,
                               device=batch.images.device)
        for t in range(num_prev):
            args = ([f[:, t] for f in feats], batch, t, prev_bev,
                    batch.prev_bev_exists[:, t], img_hw)
            if t < num_prev - back_n:
                with torch.no_grad(), eval_mode(self.pts_bbox_head_bev):
                    prev_bev = self.encode_frame(*args)
            else:
                prev_bev = self.encode_frame(*args)
        return prev_bev

    def forward(self, batch, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """The window forward -> the det head's dict (``loss`` and
        ``get_bboxes`` take it). ``train`` False: the eval forward, dropout
        off, one backbone pass over every image. ``train`` True: the
        current frame grid-masked from ``generator`` and its backbone
        checkpointed camera by camera, the history's features without
        gradient, the gradient window of ``obtain_history_bev``; dropout
        follows ``train()``/``eval()``."""
        img_hw = tuple(batch.images.shape[3:5])
        t = batch.images.shape[1]
        images = batch.images
        if not train:
            with eval_mode(self):
                feats = self.extract_feats(images)
                prev_bev = self.obtain_history_bev(
                    feats, batch, img_hw, num_prev=t - 1, train=False)
                bev = self.encode_frame(
                    [f[:, t - 1] for f in feats], batch, t - 1, prev_bev,
                    batch.prev_bev_exists[:, t - 1], img_hw)
                return self.pts_bbox_head_det(bev)
        cur = images[:, -1]
        if self.use_grid_mask:
            # the current frame's cameras only: the reference extracts the
            # history in eval mode, where GridMask is off (bevformer.py:
            # 123-130)
            bs, cams, h, w, c = cur.shape
            cur = grid_mask(generator, cur.reshape(bs * cams, h, w, c)
                            ).reshape(bs, cams, h, w, c)
        with torch.no_grad():
            hist = self.extract_feats(images[:, :-1])
        prev_bev = self.obtain_history_bev(hist, batch, img_hw,
                                           num_prev=t - 1, train=True)
        bev = self.encode_frame(self.extract_feats_cam_seq(cur), batch,
                                t - 1, prev_bev,
                                batch.prev_bev_exists[:, t - 1], img_hw)
        return self.pts_bbox_head_det(bev)

    def loss(self, preds, gt_bboxes, gt_labels, num_valid_gt):
        return self.pts_bbox_head_det.loss(preds, gt_bboxes, gt_labels,
                                           num_valid_gt)

    def get_bboxes(self, preds):
        return self.pts_bbox_head_det.get_bboxes(preds)

    def init_stream(self, bs: int, device) -> StreamState:
        """The empty cache of a new stream: no previous BEV."""
        return StreamState(
            prev_bev=torch.zeros(bs, self.bev_h * self.bev_w,
                                 self.embed_dims, device=device),
            has_prev=torch.zeros(bs, dtype=torch.bool, device=device))

    def streaming_test(self, batch, state: StreamState):
        """One frame of the streaming eval (video_test_mode), dropout off:
        the last frame's images encoded on the cached BEV -> (det head
        dict, the new state)."""
        img_hw = tuple(batch.images.shape[3:5])
        t = batch.images.shape[1] - 1
        with eval_mode(self):
            feats = self.extract_feats(batch.images[:, -1:])
            bev = self.encode_frame([f[:, 0] for f in feats], batch, t,
                                    state.prev_bev, state.has_prev, img_hw)
            preds = self.pts_bbox_head_det(bev)
        return preds, StreamState(prev_bev=bev,
                                  has_prev=torch.ones_like(state.has_prev))


class BEVFormerFP16(BEVFormer):
    """Half-precision BEVFormer (reference detectors/bevformer_fp16.py:23):
    compute in bf16 by default, f32 parameters."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = torch.bfloat16,
                 **kwargs):
        super().__init__(*args, dtype=dtype, **kwargs)
