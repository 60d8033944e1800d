"""ViDAR: visual point cloud forecasting (port of vidar_tpu/models/vidar.py).

Serving: ``ForecastRunner`` drives the four phases, ``backbone_forward``
once over every (frame, camera) image, ``encode_single`` once per history
frame, ``rollout_single`` once per future frame, then
``decode_from_features``. Training: ``forward(batch)`` returns the loss
dict of the pre-training step (vidar.py:315-389, ``train=True``);
``TrainStep`` (``vidar_tpu_torch.train``) takes its gradient.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..parallel.mesh import global_sum
from .fpn import FPN
from .grid_mask import grid_mask
from .resnet import ResNet
from .transformer import BEVEncoderHead
from .vidar_head import ViDARHead


def bev_cell_grids(bev_h: int, bev_w: int) -> np.ndarray:
    ys = (np.arange(bev_h, dtype=np.float32) + 0.5) / bev_h
    xs = (np.arange(bev_w, dtype=np.float32) + 0.5) / bev_w
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], -1)


@contextlib.contextmanager
def eval_mode(module: nn.Module):
    """Dropout off inside (serving, and the frozen history encode of a
    train step, run deterministic); the module's mode is restored after."""
    was = module.training
    module.eval()
    try:
        yield
    finally:
        module.train(was)


class CameraModel:
    """What ``ViDAR`` and ``BEVFormer`` share: random weights, and the image
    features of ``img_backbone`` and ``img_neck``."""

    @torch.no_grad()
    def randomize_(self, generator: torch.Generator, scale: float = 0.02):
        """Fill every parameter and buffer with N(0, 1) * scale drawn from
        ``generator`` (the benchmark's random weights, bench.py:78-90)."""
        for t in itertools.chain(self.parameters(), self.buffers()):
            t.copy_(torch.randn(t.shape, generator=generator,
                                device=generator.device, dtype=t.dtype)
                    * scale)
        return self

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        """Weights to train from, drawn from ``generator`` (the CLIs'
        initialisation), after the JAX package's initialisers where they
        set the scale: convolutions and deformable-conv kernels
        U(+-1/sqrt(fan_in)) (``resnet.py:_conv_kernel_init``), other
        matrices Xavier-uniform, embeddings N(0, 1), biases 0, norm scales
        1; the deformable convs' offset convs 0 and the deformable
        attentions' offset and weight projections as Deformable DETR (each
        module's ``init_offsets_``: ``attention.py:_DeformProj``, UniAD's
        ``MotionDeformableAttention``); buffers (the frozen BatchNorms) as
        built."""

        def draw(shape):
            return torch.rand(shape, generator=generator,
                              device=generator.device) * 2.0 - 1.0

        for name, p in self.named_parameters():
            leaf = name.rsplit('.', 1)[-1]
            if '.conv_offset.' in name:
                p.zero_()
            elif p.dim() == 4 or leaf == 'kernel':
                fan_in = (p.shape[0] if leaf == 'kernel'
                          else int(np.prod(p.shape[1:])))
                p.copy_(draw(p.shape) / fan_in ** 0.5)
            elif p.dim() == 2 and leaf == 'weight':
                p.copy_(draw(p.shape) * (6.0 / sum(p.shape)) ** 0.5)
            elif p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device))
            elif leaf == 'bias':
                p.zero_()
            else:
                p.fill_(1.0)
        for m in self.modules():
            if hasattr(m, 'init_offsets_'):
                m.init_offsets_()
        return self

    def backbone_forward(self, images_flat):
        """[N, H, W, 3] -> list of [N, h, w, C] FPN maps."""
        return self.img_neck(self.img_backbone(images_flat))

    def extract_feats(self, images):
        """[bs, T, cams, H, W, 3] -> list of [bs, T, cams, h, w, C]: one
        batched backbone pass (serving, and the no-gradient frames)."""
        bs, t, cams, h, w, _ = images.shape
        feats = self.backbone_forward(images.reshape(bs * t * cams, h, w, 3))
        return [f.reshape((bs, t, cams) + tuple(f.shape[1:])) for f in feats]

    def extract_feats_cam_seq(self, images):
        """[bs, cams, H, W, 3] -> list of [bs, cams, h, w, C] for the
        gradient-carrying frame: one checkpointed backbone pass per camera,
        so a camera's activations are recomputed in its own backward and
        only one camera's are alive at a time (vidar.py:134-154)."""
        per_cam = [checkpoint(self.backbone_forward, images[:, c],
                              use_reentrant=False)
                   for c in range(images.shape[1])]
        return [torch.stack(level, dim=1) for level in zip(*per_cam)]


class ViDAR(CameraModel, nn.Module):
    """Takes the keyword configuration of ``vidar_tpu.configs`` presets, plus
    ``use_grid_mask``, ``dtype`` (compute dtype, None = f32) and ``device``
    (the card unless the caller asks for the CPU). ``supervise_all_future``
    is accepted with the preset and unused: ``TrainStep`` takes it."""

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
                 sca_capacity_ratio: float = 0.5, use_grid_mask: bool = True,
                 dtype: Optional[torch.dtype] = None, device='cuda'):
        super().__init__()
        device = resolve_device(device)
        self.embed_dims, self.bev_h, self.bev_w = embed_dims, bev_h, bev_w
        self.pc_range = tuple(pc_range)
        self.future_pred_frame_num = future_pred_frame_num
        self.test_future_frame_num = test_future_frame_num
        self.history_queue_length = history_queue_length
        self.pred_history_frame_num = pred_history_frame_num
        self.decoder_num_layers = decoder_num_layers
        self.sca_capacity_ratio = sca_capacity_ratio
        self.use_grid_mask = use_grid_mask
        kw = dict(dtype=dtype, device=device)
        self.img_backbone = ResNet(depth=backbone_depth,
                                   stage_with_dcn=tuple(backbone_dcn),
                                   frozen_stages=frozen_stages, **kw)
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
            per_frame_loss_weight=per_frame_loss_weight,
            loss_weight=loss_weight, ray_grid_num=ray_grid_num,
            ray_grid_step=ray_grid_step, use_ce_loss=use_ce_loss,
            use_dist_loss=use_dist_loss, use_dense_loss=use_dense_loss,
            decoder_num_layers=decoder_num_layers, **kw)

    # ------------------------------------------------------------ phases

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

    # ----------------------------------------------------------- training

    def encode_history(self, feats, batch, img_hw, num_history: int):
        """The frozen, deterministic recurrence over the first
        ``num_history`` frames of feats (list of [bs, T, cams, h, w, C])
        -> prev_bev [bs, N, C] f32, without gradient."""
        bs = batch.images.shape[0]
        prev_bev = torch.zeros(bs, self.bev_h * self.bev_w, self.embed_dims,
                               dtype=torch.float32,
                               device=batch.images.device)
        with torch.no_grad(), eval_mode(self.pts_bbox_head):
            for f in range(num_history):
                prev_bev = self.encode_single(
                    [x[:, f] for x in feats], batch.can_bus[:, f],
                    batch.shift[:, f], batch.rotate_angle[:, f],
                    batch.lidar2img[:, f], prev_bev,
                    batch.prev_bev_exists[:, f], img_hw)
        return prev_bev

    def rollout(self, ref_bev, batch, num_future: int,
                train_frame_gate: Optional[Sequence[float]] = None):
        """Autoregressive rollout from ref_bev [bs, N, C] ->
        [num_future, layers, bs, N, C]; a future whose gate is 0 is rolled
        out without gradient, carry included (vidar.py:263)."""
        if batch.future2ref.shape[1] < num_future + 1:
            raise ValueError(
                f'batch future chain has {batch.future2ref.shape[1] - 1} '
                f'future frames but the rollout needs {num_future}')
        dims = list(self.future_pred_head.can_bus_dims)
        prev_feats = ref_bev[:, None]
        ref2hist = batch.ref2cur[:, self.history_queue_length][:, None]
        preds = []
        for fi in range(1, num_future + 1):
            pred, ref2hist = self.rollout_single(
                prev_feats, ref2hist, batch.future2ref[:, fi],
                batch.ref2future[:, fi], batch.future_can_bus[:, fi][:, dims])
            if train_frame_gate is not None and \
                    float(train_frame_gate[fi - 1]) <= 0:
                pred = pred.detach()
            preds.append(pred)
            prev_feats = pred[-1][:, None]
        return torch.stack(preds)

    def forward(self, batch, *,
                generator: Optional[torch.Generator] = None,
                gumbel_generator: Optional[torch.Generator] = None,
                train_frame_gate: Optional[Sequence[float]] = None):
        """The train forward (vidar.py:315-389, ``train=True``): grid-mask
        the current frame (``generator``), encode the history frozen, the
        current frame with gradient, roll out ``future_pred_frame_num``
        futures under ``train_frame_gate`` and return the loss dict, the
        dense loss decoded with Gumbel noise from ``gumbel_generator``
        (None: argmax). Dropout follows ``train()``/``eval()``. Serving
        goes through ``ForecastRunner``."""
        img_hw = tuple(batch.images.shape[3:5])
        t = batch.images.shape[1]
        head = self.future_pred_head
        images = batch.images
        cur = images[:, -1]
        if self.use_grid_mask:
            # the current frame's cameras only: history features come from
            # the reference's eval mode, where GridMask is off (vidar.py:
            # 325-333)
            bs, cams, h, w, c = cur.shape
            cur = grid_mask(generator, cur.reshape(bs * cams, h, w, c)
                            ).reshape(bs, cams, h, w, c)
        with torch.no_grad():
            hist_feats = self.extract_feats(images[:, :-1])
        cur_feats = self.extract_feats_cam_seq(cur)
        prev_bev = self.encode_history(hist_feats, batch, img_hw, t - 1)
        ref_bev = self.encode_single(
            cur_feats, batch.can_bus[:, t - 1], batch.shift[:, t - 1],
            batch.rotate_angle[:, t - 1], batch.lidar2img[:, t - 1],
            prev_bev, batch.prev_bev_exists[:, t - 1], img_hw)
        num_future = self.future_pred_frame_num
        layers = self.decoder_num_layers
        next_feats = ref_bev[None, None].expand(1, layers, *ref_bev.shape)
        if num_future > 0:
            preds = self.rollout(ref_bev, batch, num_future,
                                 train_frame_gate)
            next_feats = torch.cat([next_feats, preds])
        # [frames, layers, channels, bs, N, Z]; the last layer, channel-major
        sigma = head.forward_head(next_feats)
        # frame 0 opens the queue: its own flag is excluded (vidar.py:372);
        # JAX's all() spans the global batch, so the missing flags are
        # counted over every rank's samples
        missing = (~batch.prev_bev_exists[:, 1:]).sum()
        full_prev = global_sum(missing) == 0
        return head.loss(sigma[:, -1].permute(1, 0, 2, 3, 4),
                         batch.gt_points, batch.gt_tindex, batch.cur2ref,
                         batch.ref2cur, num_rollout=num_future + 1,
                         full_prev_bev_exists=full_prev,
                         generator=gumbel_generator)
