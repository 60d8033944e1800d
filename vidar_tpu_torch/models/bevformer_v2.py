"""BEVFormerV2 family (port of vidar_tpu/models/bevformer_v2.py:38-197).

* ``ResNetFusion``: the per-frame BEV maps concatenated in frame order,
  ``num_layer`` residual conv blocks, then a linear and a LayerNorm back to
  ``embed_dims``.
* ``BEVFormerV2``: each frame of ``frames`` encoded on its own by the
  single-frame ``BEVEncoderHead`` (zero shift, no previous BEV), the frames
  other than offset 0 without gradient and with dropout off, fused by
  ``ResNetFusion``, then the DETR head (``BEVFormerHead``). ``loss`` adds
  the mono-head losses of a co-trained detector, weighted.

Module names follow the flax tree (``img_backbone``, ``img_neck``,
``pts_bbox_head_bev``, ``fusion``, ``pts_bbox_head_det``), so
``state_dict_from_jax`` fills the model with ``strict=True``. The fusion
blocks run NCHW; GroupNorm (flax's epsilon 1e-6) stands in for the
reference's SyncBN, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..device import resolve_device
from .detection import BEVFormerHead
from .fpn import FPN
from .grid_mask import grid_mask
from .layers import Conv2d, GroupNorm, LayerNorm, TorchLinear
from .resnet import ResNet
from .transformer import BEVEncoderHead
from .vidar import CameraModel, eval_mode


def _gn_groups(channels: int) -> int:
    for g in (32, 16, 8, 4, 2):
        if channels % g == 0:
            return g
    return 1


def group_norm(channels: int, device=None) -> GroupNorm:
    """flax ``nn.GroupNorm`` (epsilon 1e-6) over ``_gn_groups(channels)``
    groups."""
    return GroupNorm(_gn_groups(channels), channels, eps=1e-6,
                     device=device)


class _BasicBlock(nn.Module):
    """conv3x3 -> GN -> relu -> conv3x3 -> GN, plus the identity (a conv3x3
    and GN where the channel count changes), relu. NCHW."""

    def __init__(self, in_ch: int, channels: int, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv2d(in_ch, channels, 3, padding=1, use_bias=False,
                            **kw)
        self.norm1 = group_norm(channels, device)
        self.conv2 = Conv2d(channels, channels, 3, padding=1, use_bias=False,
                            **kw)
        self.norm2 = group_norm(channels, device)
        if in_ch != channels:
            self.downsample_conv = Conv2d(in_ch, channels, 3, padding=1,
                                          use_bias=False, **kw)
            self.downsample_norm = group_norm(channels, device)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        ident = x
        if self.downsample_conv is not None:
            ident = self.downsample_norm(self.downsample_conv(x))
        return torch.relu(y + ident)


class ResNetFusion(nn.Module):
    """Fuse ``num_frames`` BEV maps: a list of [bs, H, W, C] -> [bs, H*W,
    out_channels] (H-major rows, as the JAX package flattens its
    channel-last map)."""

    def __init__(self, in_channels: int, out_channels: int,
                 inter_channels: int, num_layer: int = 3, dtype=None,
                 device=None):
        super().__init__()
        self.num_layer = num_layer
        for i in range(num_layer):
            self.add_module(f'layer{i}', _BasicBlock(
                in_channels if i == 0 else inter_channels, inter_channels,
                dtype=dtype, device=device))
        self.out_proj = TorchLinear(inter_channels, out_channels,
                                    dtype=dtype, device=device)
        self.out_norm = LayerNorm(out_channels, device)

    def forward(self, bev_list):
        x = torch.cat(bev_list, dim=-1).permute(0, 3, 1, 2)
        for i in range(self.num_layer):
            x = getattr(self, f'layer{i}')(x)
        bs, c, h, w = x.shape
        x = x.permute(0, 2, 3, 1).reshape(bs, h * w, c)
        return self.out_norm(self.out_proj(x))


class BEVFormerV2(CameraModel, nn.Module):
    """V2 detector: independent per-frame BEV encodes, fusion, DETR head.

    ``frames``: relative frame offsets such as the reference's (-2, -1, 0);
    offset 0 is the last image frame, an offset past the window is clamped
    into it (the reference's neighbour copy). Takes the JAX module's
    keyword configuration, plus ``device`` (the card unless the caller
    asks for the CPU)."""

    def __init__(self, embed_dims: int = 256, bev_h: int = 200,
                 bev_w: int = 200,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 num_cams: int = 6, num_classes: int = 10,
                 num_query: int = 900, backbone_depth: int = 101,
                 backbone_dcn: Tuple[bool, ...] = (False, False, True, True),
                 frozen_stages: int = 1, use_grid_mask: bool = False,
                 frames: Tuple[int, ...] = (0,), num_fusion: int = 3,
                 inter_channels: Optional[int] = None,
                 encoder_num_layers: int = 6, mono_loss_weight: float = 1.0,
                 dtype: Optional[torch.dtype] = None, device='cuda'):
        super().__init__()
        device = resolve_device(device)
        self.embed_dims, self.bev_h, self.bev_w = embed_dims, bev_h, bev_w
        self.use_grid_mask = use_grid_mask
        self.frames = tuple(frames)
        self.mono_loss_weight = mono_loss_weight
        kw = dict(dtype=dtype, device=device)
        self.img_backbone = ResNet(depth=backbone_depth,
                                   stage_with_dcn=tuple(backbone_dcn),
                                   frozen_stages=frozen_stages, **kw)
        self.img_neck = FPN((512, 1024, 2048), out_channels=embed_dims,
                            num_outs=4, **kw)
        self.pts_bbox_head_bev = BEVEncoderHead(
            embed_dims=embed_dims, bev_h=bev_h, bev_w=bev_w,
            pc_range=pc_range, num_cams=num_cams, latent_render_lids=(),
            latent_render_cfg=None, encoder_num_layers=encoder_num_layers,
            **kw)
        if len(self.frames) > 1:
            inter = (inter_channels if inter_channels is not None
                     else len(self.frames) * embed_dims)
            self.fusion = ResNetFusion(len(self.frames) * embed_dims,
                                       embed_dims, inter,
                                       num_layer=num_fusion, **kw)
        self.pts_bbox_head_det = BEVFormerHead(
            num_classes=num_classes, num_query=num_query,
            embed_dims=embed_dims, bev_h=bev_h, bev_w=bev_w,
            pc_range=pc_range, **kw)

    def _encode_frame(self, feats, batch, t: int, img_hw):
        """Frame t's single-frame BEV encode. feats: list of [bs, cams, h,
        w, C] -> [bs, H*W, C] f32."""
        bs = feats[0].shape[0]
        dev = feats[0].device
        return self.pts_bbox_head_bev(
            feats, batch.can_bus[:, t],
            torch.zeros(bs, 2, device=dev), torch.zeros(bs, device=dev),
            batch.lidar2img[:, t], img_hw,
            torch.zeros(bs, self.bev_h * self.bev_w, self.embed_dims,
                        device=dev),
            torch.zeros(bs, dtype=torch.bool, device=dev))

    def forward(self, batch, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """-> the det head's dict (``loss`` and ``get_bboxes`` take it).
        ``train`` False: dropout off throughout. ``train`` True: every
        image grid-masked from ``generator`` where ``use_grid_mask``, the
        offset-0 frame's backbone checkpointed camera by camera and its
        dropout following ``train()``/``eval()``; the other frames are
        encoded without gradient and with dropout off."""
        if not train:
            with eval_mode(self):
                return self._forward(batch, False, None)
        return self._forward(batch, True, generator)

    def _forward(self, batch, train, generator):
        img_hw = tuple(batch.images.shape[3:5])
        images = batch.images
        t_total = images.shape[1]
        if train and self.use_grid_mask:
            bs, _, cams, h, w, c = images.shape
            images = grid_mask(generator, images.reshape(-1, h, w, c)
                               ).reshape(bs, t_total, cams, h, w, c)
        bev_per_frame = []
        for off in self.frames:
            t = max(0, min(t_total - 1, t_total - 1 + off))
            if off != 0:
                with torch.no_grad(), eval_mode(self.pts_bbox_head_bev):
                    feats = [f[:, 0] for f in
                             self.extract_feats(images[:, t:t + 1])]
                    bev = self._encode_frame(feats, batch, t, img_hw)
            else:
                feats = (self.extract_feats_cam_seq(images[:, t]) if train
                         else [f[:, 0] for f in
                               self.extract_feats(images[:, t:t + 1])])
                bev = self._encode_frame(feats, batch, t, img_hw)
            bev_per_frame.append(bev)
        if len(self.frames) > 1:
            bs = images.shape[0]
            bev = self.fusion([b.reshape(bs, self.bev_h, self.bev_w, -1)
                               for b in bev_per_frame])
        else:
            bev = bev_per_frame[0]
        return self.pts_bbox_head_det(bev)

    def loss(self, preds, gt_bboxes, gt_labels, num_valid_gt,
             mono_losses=None):
        """The det head's losses, plus each of ``mono_losses`` (a dict of
        scalar tensors, e.g. ``NuScenesDD3D.loss``) as ``'{k}_mono'`` x
        ``mono_loss_weight``."""
        losses = self.pts_bbox_head_det.loss(preds, gt_bboxes, gt_labels,
                                             num_valid_gt)
        if mono_losses is not None:
            for k, v in mono_losses.items():
                losses[f'{k}_mono'] = v * self.mono_loss_weight
        return losses

    def get_bboxes(self, preds):
        return self.pts_bbox_head_det.get_bboxes(preds)
