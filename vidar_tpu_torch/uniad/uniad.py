"""UniAD: tracking perception and the end-to-end task dispatch (port of
vidar_tpu/uniad/uniad.py; reference uniad_track.py:21-138 and
uniad_e2e.py:17-346).

``UniADTrack`` encodes a frame's BEV with the port's ResNet, FPN and
``BEVEncoderHead`` (K9 in the DCN stages, K1 in every attention, K3/K4 at
the latent-render layers), detects with persistent track queries in the
DETR decoder and keeps the fixed-capacity tracker. ``UniAD`` runs track ->
seg -> motion -> occupancy -> planning; every tensor between the heads is a
padded ``[B, A]`` tensor with masks. Module names follow the flax tree
(``track``, ``seg_head``, ``motion_head``, ``occ_head``, ``planning_head``,
``track.pts_bbox_head_bev``, ``track.det_head``, ...), so
``state_dict_from_jax`` fills the model with ``strict=True``.

``deterministic`` is the JAX package's flag: True (eval) runs the
collision optimisation on the predicted occupancy, False (training) does
not. Dropout follows ``train()`` / ``eval()``, as in the other models.

``clip_forward`` is the train-time clip (reference forward_track_train,
uniad_track.py:547-633): the window's frames in turn, the track queries
carried between them, per frame the clip matcher (one Hungarian
assignment per sample, scipy on the host), velocity-compensated reference
points, the memory bank and QIM, the previous BEV carried detached, and the
task heads on the last frame's matched tracks.

A train step's memory: with gradient on (the clip and the single frame
alike), a frame's backbone runs camera by camera, each camera
checkpointed (``extract_feats_cam_seq``, as ViDAR and BEVFormer train),
and the frame's BEV encoder is checkpointed too, so a clip frame holds
its FPN maps, its BEV and its track decoder until the backward, which
recomputes the rest. The last frame's encoder included: its
recomputation starts after the heads' backward has freed theirs, which
saves its 9 GiB of the 80 GB card's memory at no measurable cost in time
(PERF.md). Recomputing the same operations changes no result;
dropout replays under the saved RNG state.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..core import bbox as bbox_core
from ..device import resolve_device
from ..models.detection import BEVFormerHead
from ..models.fpn import FPN
from ..models.position_embedding import sine_positional_encoding
from ..models.resnet import ResNet
from ..models.transformer import BEVEncoderHead
from ..models.vidar import CameraModel
from ..parallel.multihost import world_size
from .clip_matcher import FrameGT, bev_iou_aligned, match_frame, velo_update
from .motion_head import MotionHead, default_anchors, load_motion_anchors
from .occ_head import OccHead
from .panseg_head import PansegformerHead
from .planning_head import PlanningHeadSingleMode
from .track import (MemoryBank, QueryInteractionModule, RuntimeTracker,
                    TrackInstances)

PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


class UniADTrack(CameraModel, nn.Module):
    """Tracking perception: detection queries + persistent track queries."""

    def __init__(self, embed_dims: int = 256, bev_h: int = 200,
                 bev_w: int = 200, pc_range: Sequence[float] = PC_RANGE,
                 num_cams: int = 6, num_classes: int = 10,
                 num_query: int = 900, backbone_depth: int = 101,
                 latent_render_lids: Tuple[int, ...] = (2,),
                 latent_render_cfg: Optional[dict] = None,
                 score_thresh: float = 0.4,
                 filter_score_thresh: float = 0.35, miss_tolerance: int = 5,
                 memory_len: int = 4, dtype=None, device='cuda'):
        super().__init__()
        device = resolve_device(device)
        self.embed_dims, self.num_query = embed_dims, num_query
        self.num_classes, self.memory_len = num_classes, memory_len
        self.bev_h, self.bev_w = bev_h, bev_w
        self.pc_range = tuple(pc_range)
        kw = dict(dtype=dtype, device=device)
        self.img_backbone = ResNet(depth=backbone_depth, **kw)
        self.img_neck = FPN((512, 1024, 2048), out_channels=embed_dims, **kw)
        self.pts_bbox_head_bev = BEVEncoderHead(
            embed_dims=embed_dims, bev_h=bev_h, bev_w=bev_w,
            pc_range=pc_range, num_cams=num_cams,
            latent_render_lids=tuple(latent_render_lids),
            latent_render_cfg=latent_render_cfg, **kw)
        self.det_head = BEVFormerHead(
            num_classes=num_classes, num_query=num_query,
            embed_dims=embed_dims, bev_h=bev_h, bev_w=bev_w,
            pc_range=pc_range, **kw)
        self.qim = QueryInteractionModule(embed_dims, **kw)
        self.mem_bank = MemoryBank(embed_dims, max(memory_len, 1), **kw)
        self.tracker = RuntimeTracker(score_thresh, filter_score_thresh,
                                      miss_tolerance)
        # the ego (SDC) query, reference uniad_track.py sdc_embedding
        self.sdc_query = nn.Parameter(torch.empty(2 * embed_dims,
                                                  device=device))

    def init_tracks(self, bs: int) -> TrackInstances:
        qe = self.det_head.query_embedding
        ref = torch.sigmoid(self.det_head.reference_points(
            qe[:, :self.embed_dims]))
        return TrackInstances.empty(self.num_query, self.embed_dims,
                                    self.num_classes, qe, ref,
                                    memory_len=self.memory_len,
                                    batch_shape=(bs,))

    def frame_feats(self, images):
        """[bs, cams, H, W, 3] -> list of [bs, cams, h, w, C] FPN maps:
        camera by camera, each checkpointed, where gradient is on; one
        batched pass where it is off (eval)."""
        if torch.is_grad_enabled():
            return self.extract_feats_cam_seq(images)
        bs, cams, h, w, _ = images.shape
        feats = self.backbone_forward(images.reshape(bs * cams, h, w, 3))
        return [f.reshape((bs, cams) + tuple(f.shape[1:])) for f in feats]

    def encode_bev(self, batch, prev_bev, prev_exists, frame: int = -1):
        """Frame ``frame`` of the batch's window -> BEV [bs, H*W, C]. Where
        gradient is on, the BEV encoder is checkpointed (its activations
        recomputed in the backward), as the backbone is in
        ``frame_feats``."""
        img_hw = tuple(batch.images.shape[3:5])
        args = (self.frame_feats(batch.images[:, frame]),
                batch.can_bus[:, frame], batch.shift[:, frame],
                batch.rotate_angle[:, frame], batch.lidar2img[:, frame],
                img_hw, prev_bev, prev_exists)
        if torch.is_grad_enabled():
            return checkpoint(self.pts_bbox_head_bev, *args,
                              use_reentrant=False)
        return self.pts_bbox_head_bev(*args)

    def track_frame(self, bev, tracks: TrackInstances):
        """One frame of detection with the track queries in the decoder:
        its output embeddings become the slots' content, its last
        reference points their references."""
        preds = self.det_head(bev, query_embeds=tracks.query,
                              ref_points=tracks.ref_points)
        cls_last = preds['all_cls_scores'][-1]
        query = torch.cat([tracks.query[..., :self.embed_dims],
                           preds['query_feats'].to(tracks.query.dtype)], -1)
        return preds, tracks.replace(
            scores=torch.sigmoid(cls_last).amax(-1),
            pred_boxes=preds['all_bbox_preds'][-1], pred_logits=cls_last,
            query=query, ref_points=preds['last_ref_points'])

    def refresh_tracks(self, tracks: TrackInstances) -> TrackInstances:
        """Between frames: the memory bank, then QIM."""
        d = self.embed_dims
        if self.memory_len > 0:
            fused, new_mem = self.mem_bank(tracks.query[..., d:],
                                           tracks.memory,
                                           tracks.obj_idxes >= 0)
            tracks = tracks.replace(
                query=torch.cat([tracks.query[..., :d], fused], -1),
                memory=new_mem)
        return self.qim(tracks, self.det_head.query_embedding)

    def advance_refs(self, tracks: TrackInstances, l2g_r1, l2g_t1, l2g_r2,
                     l2g_t2, time_delta) -> TrackInstances:
        """Reference points for the next frame: re-derived from the query
        position, x/y from ``velo_update`` of the current ones."""
        new_ref = torch.sigmoid(self.det_head.reference_points(
            tracks.query[..., :self.embed_dims]))
        upd = velo_update(tracks.ref_points, tracks.pred_boxes[..., 8:10],
                          l2g_r1, l2g_t1, l2g_r2, l2g_t2, time_delta,
                          self.pc_range)
        return tracks.replace(ref_points=torch.cat(
            [upd[..., :2], new_ref[..., 2:]], -1))


class UniAD(CameraModel, nn.Module):
    """The end-to-end dispatcher. Takes the keyword configuration of the
    UniAD config files' ``model`` dict, plus ``dtype`` (compute dtype, None
    = f32) and ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, embed_dims: int = 256, bev_h: int = 200,
                 bev_w: int = 200, pc_range: Sequence[float] = PC_RANGE,
                 num_cams: int = 6, num_query: int = 900,
                 num_seg_query: int = 300, num_classes: int = 10,
                 backbone_depth: int = 101, predict_steps: int = 12,
                 predict_modes: int = 6, occ_n_future: int = 4,
                 planning_steps: int = 6,
                 task_loss_weight: Optional[dict] = None,
                 latent_render_lids: Tuple[int, ...] = (2,),
                 latent_render_cfg: Optional[dict] = None,
                 vehicle_id_list: Sequence[int] = (0, 1, 2, 3, 4, 6, 7),
                 memory_len: int = 4, gt_iou_threshold: float = 0.0,
                 anchor_info_path: Optional[str] = None, dtype=None,
                 device='cuda'):
        super().__init__()
        device = resolve_device(device)
        self.embed_dims, self.bev_h, self.bev_w = embed_dims, bev_h, bev_w
        self.num_query, self.num_classes = num_query, num_classes
        self.predict_steps = predict_steps
        self.task_loss_weight = task_loss_weight
        self.gt_iou_threshold = gt_iou_threshold
        vm = np.zeros((num_classes,), np.float32)
        vm[list(vehicle_id_list)] = 1.0
        self.register_buffer('vehicle_table', torch.from_numpy(vm).to(
            device), persistent=False)
        kw = dict(dtype=dtype, device=device)
        self.track = UniADTrack(
            embed_dims=embed_dims, bev_h=bev_h, bev_w=bev_w,
            pc_range=pc_range, num_cams=num_cams, num_query=num_query,
            num_classes=num_classes, backbone_depth=backbone_depth,
            latent_render_lids=latent_render_lids,
            latent_render_cfg=latent_render_cfg, memory_len=memory_len,
            **kw)
        self.seg_head = PansegformerHead(embed_dims=embed_dims,
                                         num_query=num_seg_query,
                                         bev_h=bev_h, bev_w=bev_w, **kw)
        self.motion_head = MotionHead(
            embed_dims=embed_dims, num_anchor=predict_modes,
            predict_steps=predict_steps, num_classes=num_classes,
            bev_h=bev_h, bev_w=bev_w, pc_range=pc_range, **kw)
        self.occ_head = OccHead(embed_dims=embed_dims, n_future=occ_n_future,
                                bev_h=bev_h, bev_w=bev_w, **kw)
        self.planning_head = PlanningHeadSingleMode(
            embed_dims=embed_dims, planning_steps=planning_steps,
            bev_h=bev_h, bev_w=bev_w, pc_range=pc_range, **kw)
        # [G, P, T, 2]: the k-means anchor file's, else the radial fan
        mh = self.motion_head
        if anchor_info_path:
            anc = load_motion_anchors(anchor_info_path)
            if anc.shape != (mh.num_anchor_group, mh.num_anchor,
                             predict_steps, 2):
                raise ValueError(f'{anchor_info_path}: anchors of shape '
                                 f'{anc.shape}')
        else:
            anc = default_anchors(mh.num_anchor_group, mh.num_anchor,
                                  predict_steps)
        self.register_buffer('anchors', torch.from_numpy(
            np.array(anc, np.float32)).to(device), persistent=False)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        """``CameraModel.init_weights_``, and the ego query N(0, 1) as the
        JAX package draws it."""
        super().init_weights_(generator)
        q = self.track.sdc_query
        q.copy_(torch.randn(q.shape, generator=generator,
                            device=generator.device))
        return self

    def init_stream(self, bs: int, device):
        """A new scene: no tracks (None) and an all-zero previous BEV."""
        return None, torch.zeros(bs, self.bev_h * self.bev_w,
                                 self.embed_dims, device=device)

    # ------------------------------------------------------------ task heads

    def _run_task_heads(self, bev, tracks: TrackInstances, command, active,
                        *, deterministic: bool = True,
                        with_masks: bool = False) -> Dict:
        """Map seg + motion + occupancy + planning on one frame's BEV and
        tracks; ``active`` [B, cap] gates which slots feed the motion
        head."""
        seg = self.seg_head(bev, with_masks=with_masks)
        _, _, _, lane_query, _, lane_query_pos, _ = seg['args_tuple']
        d = self.embed_dims
        box = tracks.pred_boxes
        bs = box.shape[0]
        dev = box.device
        labels = tracks.pred_logits.argmax(-1)
        # the ego query at the last slot (uniad_e2e.py:117-136)
        sdc = self.track.sdc_query[None, None, d:].expand(bs, 1, d)
        tq = torch.cat([tracks.query[..., d:], sdc], 1)
        centers = torch.cat([box[..., :2], torch.zeros(bs, 1, 2,
                                                       device=dev)], 1)
        yaw = torch.cat([torch.atan2(box[..., 6], box[..., 7]),
                         torch.zeros(bs, 1, device=dev)], 1)
        labels = torch.cat([labels, torch.zeros_like(labels[:, :1])], 1)
        active = torch.cat([active, torch.ones_like(active[:, :1])], 1)
        motion = self.motion_head(tq, labels, centers, yaw, lane_query,
                                  lane_query_pos, bev, self.anchors)
        vehicle_mask = self.vehicle_table[labels.clamp(
            0, self.num_classes - 1)] * active

        # the ego's queries apart from the agents' (motion_head.py:152-160)
        sdc_traj_query = motion['traj_query'][:, :, -1]
        sdc_track_query = motion['track_query'][:, -1]
        ins_query = self.occ_head.merge_queries(
            motion['traj_query'][-1][:, :-1], motion['track_query'][:, :-1],
            motion['track_query_pos'][:, :-1])
        occ = self.occ_head(bev, ins_query)
        bev_pos = sine_positional_encoding(self.bev_h, self.bev_w, d // 2,
                                           device=dev).reshape(1, -1, d)
        bev_pos = bev_pos.expand(bs, -1, d).to(bev.dtype)
        plan = self.planning_head(
            bev, occ['seg_out'] if deterministic else None, bev_pos,
            sdc_traj_query, sdc_track_query, command,
            deterministic=deterministic)
        return dict(bev=bev, seg=seg, motion=motion, occ=occ, plan=plan,
                    active=active, vehicle_mask=vehicle_mask)

    # -------------------------------------------------------- single frame

    def forward(self, batch, tracks: Optional[TrackInstances], prev_bev,
                prev_exists, command, *, deterministic: bool = True,
                with_masks: bool = False):
        """One frame (the window's last): its BEV on ``prev_bev``, the
        track queries (new ones where ``tracks`` is None), the tracker's
        update, the task heads, then the queries refreshed for the next
        frame -> the heads' dict with ``det`` and ``tracks``."""
        bs = batch.images.shape[0]
        if tracks is None:
            tracks = self.track.init_tracks(bs)
        bev = self.track.encode_bev(batch, prev_bev, prev_exists)
        det_preds, tracks = self.track.track_frame(bev, tracks)
        tracks = self.track.tracker.update(tracks)
        out = self._run_task_heads(bev, tracks, command,
                                   tracks.obj_idxes >= 0,
                                   deterministic=deterministic,
                                   with_masks=with_masks)
        out.update(det=det_preds, tracks=self.track.refresh_tracks(tracks))
        return out

    # -------------------------------------------------------- clip training

    def clip_forward(self, batch, track_gt: FrameGT, l2g_r, l2g_t, timestamp,
                     command, *, deterministic: bool = False,
                     with_masks: bool = True):
        """The train-time clip. batch: a ``ViDARBatch`` whose T image
        frames are the clip; track_gt: ``FrameGT`` of [B, T, ...] tensors
        (instance ids consistent across frames); l2g_r / l2g_t [B, T, 3,
        3] / [B, T, 3] lidar -> global; timestamp [B, T] seconds ->
        (track losses summed over the clip, the heads' dict, the last
        frame's matched gt row per slot [B, cap])."""
        bs, t_clip = batch.images.shape[:2]
        dev = batch.images.device
        tracks = self.track.init_tracks(bs)
        prev_bev = torch.zeros(bs, self.bev_h * self.bev_w, self.embed_dims,
                               device=dev)
        slot_mask = torch.ones(self.num_query, dtype=torch.bool, device=dev)
        track_losses = dict(loss_cls=0.0, loss_bbox=0.0)
        global_bs = bs * world_size()
        for t in range(t_clip):
            exists = (batch.prev_bev_exists[:, t] if t > 0 else
                      torch.zeros(bs, dtype=torch.bool, device=dev))
            bev = self.track.encode_bev(batch, prev_bev, exists, frame=t)
            det_preds, tracks = self.track.track_frame(bev, tracks)
            # the clip matcher, sample by sample; the mean over the global
            # batch (JAX's over the samples of its one batch)
            new_obj, matched = [], []
            for i in range(bs):
                obj_i, m_i, fl = match_frame(
                    det_preds['all_cls_scores'][:, i],
                    det_preds['all_bbox_preds'][:, i],
                    tracks.obj_idxes[i], track_gt.index(i, t), slot_mask,
                    self.num_classes)
                new_obj.append(obj_i)
                matched.append(m_i)
                track_losses = {k: track_losses[k] + fl[k] / global_bs
                                for k in track_losses}
            tracks = tracks.replace(obj_idxes=torch.stack(new_obj))
            matched = torch.stack(matched)
            if t < t_clip - 1:
                tracks = self.track.advance_refs(
                    tracks, l2g_r[:, t], l2g_t[:, t], l2g_r[:, t + 1],
                    l2g_t[:, t + 1], timestamp[:, t + 1] - timestamp[:, t])
                tracks = self.track.refresh_tracks(tracks)
                # the previous BEV carried detached, as the reference's
                # no-gradient history queue (uniad_track.py get_bevs)
                prev_bev = bev.detach()

        # the last frame's active gate (uniad_track.py:513-515): a matched
        # track whose predicted box overlaps its gt
        gt_last = track_gt.boxes[:, -1]                       # [B, G, 10]
        safe = matched.clamp(0, gt_last.shape[1] - 1)
        gt_m = torch.gather(gt_last, 1, safe[..., None].expand(
            -1, -1, gt_last.shape[-1]))
        iou = bev_iou_aligned(bbox_core.denormalize_bbox(tracks.pred_boxes),
                              bbox_core.denormalize_bbox(gt_m))
        active = ((tracks.obj_idxes >= 0) & (matched >= 0) &
                  (iou >= self.gt_iou_threshold))
        out = self._run_task_heads(bev, tracks, command, active,
                                   deterministic=deterministic,
                                   with_masks=with_masks)
        out.update(det=det_preds, tracks=tracks)
        return track_losses, out, matched
