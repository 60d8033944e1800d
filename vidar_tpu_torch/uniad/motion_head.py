"""MotionFormer, the multi-modal trajectory head (port of
vidar_tpu/uniad/motion_head.py; reference motion_head.py, modules.py,
motion_deformable_attn.py, traj_loss.py).

Agents are fixed-capacity tensors ``[B, A]`` with a validity mask.
``MotionDeformableAttention`` folds its ``num_steps`` sampling groups into
the query axis of one ``ops.msda.msdeform_attn`` call: at the released
widths 901 agents x 6 modes x 12 steps = 64,872 queries into the one
200x200 BEV level (K1 on the card, K5 in its backward). The k-means anchors
are an input; ``default_anchors`` is the deterministic radial fan used
without an anchor file.
"""

from __future__ import annotations

import functools
import math
import os
import pickle
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import DROPOUT, FFN, Dense, LayerNorm, TorchLinear
from ..ops.msda import msdeform_attn
from .blocks import FuserMLP, TorchDecoderLayer, TorchEncoderLayer
from .functional import (anchor_coordinate_transform,
                         bivariate_gaussian_activation, norm_points,
                         pos2posemb2d, trajectory_coordinate_transform)


def load_motion_anchors(path: str) -> np.ndarray:
    """A k-means anchor pickle (``anchors_all``: per-group [P, T, 2]) ->
    [G, P, T, 2] f32, cached by (path, mtime) and write-protected."""
    return _load_motion_anchors_cached(path, os.stat(path).st_mtime_ns)


@functools.lru_cache(maxsize=8)
def _load_motion_anchors_cached(path: str, _mtime_ns: int) -> np.ndarray:
    with open(path, 'rb') as f:
        infos = pickle.load(f)
    arr = np.stack([np.asarray(a, np.float32) for a in infos['anchors_all']])
    arr.flags.writeable = False
    return arr


def default_anchors(num_groups: int = 4, num_modes: int = 6,
                    steps: int = 12) -> np.ndarray:
    """Deterministic radial-fan anchors [G, P, T, 2]: per mode a straight
    ray fanned over heading, its speed by group (vehicle / bike /
    pedestrian / other)."""
    speeds = (8.0, 4.0, 1.5, 3.0)
    out = np.zeros((num_groups, num_modes, steps, 2), np.float32)
    t = np.arange(1, steps + 1, dtype=np.float32) * 0.5
    for g in range(num_groups):
        v = speeds[g % len(speeds)]
        for p in range(num_modes):
            ang = (p - (num_modes - 1) / 2.0) * (math.pi / 6.0) - math.pi / 2
            out[g, p, :, 0] = v * t * math.cos(ang)
            out[g, p, :, 1] = v * t * math.sin(ang)
    return out


def offset_grid_bias(num_heads: int, num_steps: int, num_levels: int,
                     num_points: int) -> np.ndarray:
    """The sampling offsets' bias init (motion_deformable_attn.py:329-346):
    head h along angle 2 pi h / heads, point i at i + 1 cells, every step
    alike."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * math.pi /
                                                       num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, None, :],
                   (1, num_steps, num_levels, num_points, 1))
    for i in range(num_points):
        grid[:, :, :, i, :] *= i + 1
    return grid.reshape(-1)


class MotionDeformableAttention(nn.Module):
    """Deformable goal-point attention over the BEV map: each (agent, mode)
    query samples ``num_steps`` groups of points around its trajectory's
    endpoint; the steps' outputs are concatenated and fused by Linear(S*D
    -> D) + LN + ReLU."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 num_steps: int = 12, sample_index: int = -1,
                 bev_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2,
                                               51.2, 3.0),
                 dtype=None, device=None):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        self.num_steps, self.sample_index = num_steps, sample_index
        self.bev_range = tuple(bev_range)
        n = num_heads * num_steps * num_levels * num_points
        kw = dict(dtype=dtype, device=device)
        self.sampling_offsets = Dense(embed_dims, n * 2, **kw)
        self.attention_weights = Dense(embed_dims, n, **kw)
        self.value_proj = TorchLinear(embed_dims, embed_dims, **kw)
        self.output_proj_fc = TorchLinear(num_steps * embed_dims, embed_dims,
                                          **kw)
        self.output_proj_ln = LayerNorm(embed_dims, device)
        self.drop = nn.Dropout(DROPOUT)

    @torch.no_grad()
    def init_offsets_(self):
        """Zero offset and weight projections, the directional offset
        bias (the JAX package's init)."""
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(torch.from_numpy(offset_grid_bias(
            self.num_heads, self.num_steps, self.num_levels,
            self.num_points)))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query, value, reference_trajs, centers, spatial_shapes,
                query_pos=None, identity=None):
        """query [B, A, P, D]; value [B, HW, D]; reference_trajs [B, A, P,
        T, 2] agent-offset trajectories; centers [B, A, 2] (metres)."""
        bs, a, p, d = query.shape
        nq = a * p
        h, s, lv, pt = (self.num_heads, self.num_steps, self.num_levels,
                        self.num_points)
        if identity is None:
            identity = query
        if query_pos is not None:
            query = query + query_pos
        q = query.reshape(bs, nq, d)
        offsets = self.sampling_offsets(q).reshape(bs, nq, h, s, lv, pt, 2)
        weights = self.attention_weights(q).reshape(bs, nq, h, s, lv * pt)
        weights = torch.softmax(weights.float(), -1).reshape(bs, nq, h, s,
                                                             lv, pt)
        value_p = self.value_proj(value).reshape(bs, value.shape[1], h,
                                                 self.embed_dims // h)
        # the endpoint in ego coordinates, normalised over the BEV range
        end = (reference_trajs[:, :, :, self.sample_index, :] +
               centers[:, :, None, :]).detach()
        r = self.bev_range
        ex = (end[..., 0] - r[0]) / (r[3] - r[0])
        ey = (end[..., 1] - r[1]) / (r[4] - r[1])
        ref = torch.stack([ex, ey], -1).reshape(bs, nq, 1, 1, 1, 1, 2)
        normalizer = torch.tensor([[w_, h_] for (h_, w_) in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        loc = ref + offsets / normalizer[None, None, None, None, :, None, :]
        # the steps folded into the query axis: one msda call for all S
        loc = loc.permute(0, 1, 3, 2, 4, 5, 6).reshape(bs, nq * s, h, lv, pt,
                                                       2)
        w = weights.permute(0, 1, 3, 2, 4, 5).reshape(bs, nq * s, h, lv, pt)
        out = msdeform_attn(value_p, list(spatial_shapes), loc, w)
        out = out.reshape(bs, nq, s * self.embed_dims).to(query.dtype)
        out = torch.relu(self.output_proj_ln(self.output_proj_fc(out)))
        return self.drop(out).reshape(bs, a, p, d) + identity


class MotionTransformerAttentionLayer(nn.Module):
    """cross-attention -> norm -> FFN -> norm."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 num_steps: int = 12, feedforward: int = 512,
                 bev_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2,
                                               51.2, 3.0),
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cross_attn = MotionDeformableAttention(
            embed_dims, num_heads, num_levels, num_points, num_steps,
            bev_range=bev_range, **kw)
        self.norm0 = LayerNorm(embed_dims, device)
        self.ffn = FFN(feedforward, embed_dims, **kw)
        self.norm1 = LayerNorm(embed_dims, device)

    def forward(self, query, value, reference_trajs, centers, spatial_shapes,
                query_pos=None):
        x = self.norm0(self.cross_attn(query, value, reference_trajs,
                                       centers, spatial_shapes,
                                       query_pos=query_pos))
        return self.norm1(self.ffn(x))


class _ClsBranch(nn.Module):
    """(Linear, LN, ReLU) x n + Linear(1)."""

    def __init__(self, embed_dims: int, num_fcs: int, dtype=None,
                 device=None):
        super().__init__()
        self.num_fcs = num_fcs
        kw = dict(dtype=dtype, device=device)
        for i in range(num_fcs):
            self.add_module(f'fc{i}', TorchLinear(embed_dims, embed_dims,
                                                  **kw))
            self.add_module(f'ln{i}', LayerNorm(embed_dims, device))
        self.out = TorchLinear(embed_dims, 1, **kw)

    def forward(self, x):
        for i in range(self.num_fcs):
            x = torch.relu(getattr(self, f'ln{i}')(getattr(self,
                                                           f'fc{i}')(x)))
        return self.out(x)


class _RegBranch(nn.Module):
    """(Linear, ReLU) x n + Linear(T * 5)."""

    def __init__(self, embed_dims: int, num_fcs: int, out_dims: int,
                 dtype=None, device=None):
        super().__init__()
        self.num_fcs = num_fcs
        kw = dict(dtype=dtype, device=device)
        for i in range(num_fcs):
            self.add_module(f'fc{i}', TorchLinear(embed_dims, embed_dims,
                                                  **kw))
        self.out = TorchLinear(embed_dims, out_dims, **kw)

    def forward(self, x):
        for i in range(self.num_fcs):
            x = torch.relu(getattr(self, f'fc{i}')(x))
        return self.out(x)


class MotionHead(nn.Module):
    """Intention / track / map / BEV interaction decoder: per layer
    log-mode scores [L, B, A, P] and bivariate-Gaussian trajectories [L,
    B, A, P, T, 5] (cumulative-sum speed parameterisation)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_layers: int = 3, num_anchor: int = 6,
                 num_anchor_group: int = 4, num_classes: int = 10,
                 predict_steps: int = 12, num_cls_fcs: int = 3,
                 bev_h: int = 200, bev_w: int = 200,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 group_id_list: Sequence[Sequence[int]] = (
                     (0, 1, 2, 3, 4), (6, 7), (8,), (5, 9)),
                 dtype=None, device=None):
        super().__init__()
        d = embed_dims
        self.embed_dims, self.num_layers = d, num_layers
        self.num_anchor, self.num_anchor_group = num_anchor, num_anchor_group
        self.num_classes, self.predict_steps = num_classes, predict_steps
        self.bev_h, self.bev_w = bev_h, bev_w
        self.pc_range = tuple(pc_range)
        table = np.zeros((num_classes,), np.int64)
        for gi, ids in enumerate(group_id_list):
            for cid in ids:
                table[cid] = gi
        self.register_buffer('group_table', torch.from_numpy(table).to(
            device), persistent=False)
        kw = dict(dtype=dtype, device=device)
        self.learnable_motion_query_embedding = nn.Parameter(torch.empty(
            num_anchor * num_anchor_group, d, device=device))
        for name in ('boxes_query_embedding_layer',
                     'agent_level_embedding_layer',
                     'scene_level_ego_embedding_layer',
                     'scene_level_offset_embedding_layer'):
            # pos2posemb2d's 2 x 128 features
            self.add_module(name, FuserMLP(256, 2 * d, d, **kw))
        self.intention_interaction = TorchEncoderLayer(d, num_heads, 2 * d,
                                                       **kw)
        for i in range(num_layers):
            self.add_module(f'track_agent_interaction_{i}',
                            TorchDecoderLayer(d, num_heads, 2 * d, **kw))
            self.add_module(f'map_interaction_{i}',
                            TorchDecoderLayer(d, num_heads, 2 * d, **kw))
            self.add_module(f'bev_interaction_{i}',
                            MotionTransformerAttentionLayer(
                                d, num_heads, num_steps=predict_steps,
                                feedforward=2 * d, bev_range=pc_range, **kw))
        self.static_dynamic_fuser = FuserMLP(2 * d, 2 * d, d, **kw)
        self.dynamic_embed_fuser = FuserMLP(3 * d, 2 * d, d, **kw)
        self.in_query_fuser = FuserMLP(2 * d, 2 * d, d, **kw)
        self.out_query_fuser = FuserMLP(4 * d, 2 * d, d, **kw)
        for i in range(num_layers):
            self.add_module(f'traj_cls_branches_{i}', _ClsBranch(
                d, num_cls_fcs - 1, **kw))
            self.add_module(f'traj_reg_branches_{i}', _RegBranch(
                d, num_cls_fcs - 1, predict_steps * 5, **kw))

    def _embed(self, layer, points):
        return getattr(self, layer)(pos2posemb2d(norm_points(points,
                                                             self.pc_range)))

    def forward(self, track_query, labels, centers, yaw, lane_query,
                lane_query_pos, bev, anchors):
        """track_query [B, A, D] (the ego query at slot -1), labels [B, A],
        centers [B, A, 2], yaw [B, A], lane_query / lane_query_pos [B, M,
        D], bev [B, HW, D], anchors [G, P, T, 2]."""
        bs, a, d = track_query.shape
        g, p, t, _ = anchors.shape
        track_query_pos = self._embed('boxes_query_embedding_layer', centers)
        learnable_pos = self.learnable_motion_query_embedding.reshape(
            g, self.num_anchor, d)
        scene_ego = anchor_coordinate_transform(anchors, centers, yaw,
                                                with_translation=True)
        scene_off = anchor_coordinate_transform(anchors, centers, yaw,
                                                with_translation=False)
        agent_emb = self._embed('agent_level_embedding_layer',
                                anchors[..., -1, :])
        scene_ego_emb = self._embed('scene_level_ego_embedding_layer',
                                    scene_ego[..., -1, :])
        scene_off_emb = self._embed('scene_level_offset_embedding_layer',
                                    scene_off[..., -1, :])

        # the anchor group of each agent's class
        gidx = self.group_table[labels.clamp(0, self.num_classes - 1)]

        def sel(x):               # [B, A, G, P, ...] -> [B, A, P, ...]
            idx = gidx.reshape(bs, a, 1, *([1] * (x.dim() - 3)))
            return torch.gather(x, 2, idx.expand(bs, a, 1, *x.shape[3:])
                                ).squeeze(2)

        agent_emb = sel(agent_emb[None, None].expand(bs, a, g, p, d))
        scene_ego_emb = sel(scene_ego_emb)
        scene_off_emb = sel(scene_off_emb)
        learnable_emb = sel(learnable_pos[None, None].expand(bs, a, g, p, d))
        reference = sel(scene_off).detach()            # [B, A, P, T, 2]

        spatial_shapes = ((self.bev_h, self.bev_w),)
        track_q_bc = track_query[:, :, None, :].expand(bs, a, p, d)
        track_pos_bc = track_query_pos[:, :, None, :].expand(bs, a, p, d)
        agent_emb = self.intention_interaction(
            agent_emb.reshape(bs * a, p, d)).reshape(bs, a, p, d)
        static_intention = agent_emb + scene_off_emb + learnable_emb
        # every agent's queries attend the same track and lane memories:
        # a leading dim of 1 that the attention broadcasts over the agents
        # (the JAX package copies them per agent; the same products)
        track_mem = (track_query + track_query_pos)[:, None]   # [B, 1, A, D]
        lane_mem = (lane_query + lane_query_pos)[:, None]      # [B, 1, M, D]

        query = torch.zeros_like(static_intention)
        inter_states, inter_refs = [], []
        for lid in range(self.num_layers):
            dyn = self.dynamic_embed_fuser(torch.cat(
                [agent_emb, scene_off_emb, scene_ego_emb], -1))
            intention = self.static_dynamic_fuser(torch.cat(
                [static_intention, dyn], -1))
            query = self.in_query_fuser(torch.cat([query, intention], -1))
            q_in = query + track_pos_bc
            tq = getattr(self, f'track_agent_interaction_{lid}')(q_in,
                                                                 track_mem)
            mq = getattr(self, f'map_interaction_{lid}')(q_in, lane_mem)
            bq = getattr(self, f'bev_interaction_{lid}')(
                query, bev, reference, centers, spatial_shapes,
                query_pos=track_pos_bc)
            query = self.out_query_fuser(torch.cat(
                [tq, mq, bq, track_q_bc + track_pos_bc], -1))

            # the reference from the reg branch (modules.py:141-170)
            tmp = getattr(self, f'traj_reg_branches_{lid}')(query).reshape(
                bs, a, p, t, 5)
            reference = torch.cumsum(tmp[..., :2], 3).detach()
            ep_ego = trajectory_coordinate_transform(
                reference, centers, yaw, with_translation=True,
                with_rotation=False)
            ep_agent = trajectory_coordinate_transform(
                reference, centers, yaw, with_translation=False,
                with_rotation=True)
            agent_emb = self._embed('agent_level_embedding_layer',
                                    ep_agent[..., -1, :])
            scene_ego_emb = self._embed('scene_level_ego_embedding_layer',
                                        ep_ego[..., -1, :])
            scene_off_emb = self._embed('scene_level_offset_embedding_layer',
                                        reference[..., -1, :])
            inter_states.append(query)
            inter_refs.append(reference)

        scores, trajs = [], []
        for lid in range(self.num_layers):
            cls = getattr(self, f'traj_cls_branches_{lid}')(
                inter_states[lid])[..., 0]
            tmp = getattr(self, f'traj_reg_branches_{lid}')(
                inter_states[lid]).reshape(bs, a, p, t, 5)
            tmp = torch.cat([torch.cumsum(tmp[..., :2], 3), tmp[..., 2:]],
                            -1)
            scores.append(torch.log_softmax(cls, -1))
            trajs.append(bivariate_gaussian_activation(tmp))
        return dict(all_traj_scores=torch.stack(scores),
                    all_traj_preds=torch.stack(trajs),
                    traj_query=torch.stack(inter_states),
                    track_query=track_query,
                    track_query_pos=track_query_pos,
                    inter_references=torch.stack(inter_refs))


# ------------------------------------------------- TrajLoss (traj_loss.py)

def min_ade(traj, traj_gt, valid):
    """[N, P, T, >=2] x [N, T, 2] x [N, T] -> (err [N], inds [N])."""
    err = torch.linalg.norm(traj[..., :2] - traj_gt[:, None], dim=-1)
    cnt = valid.sum(-1).clamp(min=1)[:, None]
    err = (err * valid[:, None]).sum(-1) / cnt
    return err.min(-1).values, err.argmin(-1)


def min_fde(traj, traj_gt, valid):
    """The last valid step's displacement error of the best mode."""
    last = (valid.sum(-1).long() - 1).clamp(min=0)
    n, p = traj.shape[:2]
    tl = torch.gather(traj[..., :2], 2, last[:, None, None, None].expand(
        n, p, 1, 2)).squeeze(2)
    gl = torch.gather(traj_gt, 1, last[:, None, None].expand(n, 1, 2)
                      ).squeeze(1)
    err = torch.linalg.norm(tl - gl[:, None], dim=-1)
    return err.min(-1).values, err.argmin(-1)


def miss_rate(traj, traj_gt, valid, dist_thresh: float = 2.0):
    """1 where the best mode's largest in-horizon displacement exceeds the
    threshold."""
    dist = torch.linalg.norm(traj[..., :2] - traj_gt[:, None], dim=-1)
    dist = torch.where(valid[:, None] > 0, dist,
                       torch.full_like(dist, -math.inf))
    worst = dist.amax(-1).amin(-1)
    return (worst > dist_thresh).float()


def traj_nll(pred, traj_gt, valid):
    """Bivariate-Gaussian NLL per agent (traj_loss.py:122-165)."""
    mu_x, mu_y = pred[..., 0], pred[..., 1]
    sig_x = pred[..., 2].clamp(1e-4, 1e4)
    sig_y = pred[..., 3].clamp(1e-4, 1e4)
    rho = pred[..., 4].clamp(-0.99, 0.99)
    ohr = (1.0 - rho ** 2) ** -0.5
    dx = traj_gt[..., 0] - mu_x
    dy = traj_gt[..., 1] - mu_y
    nll = (0.5 * ohr ** 2 * (sig_x ** 2 * dx ** 2 + sig_y ** 2 * dy ** 2 -
                             2.0 * rho * sig_x * sig_y * dx * dy)
           - torch.log(sig_x * sig_y * ohr) + 1.8379)
    nll = torch.where(torch.isfinite(nll), nll, torch.zeros_like(nll))
    return (nll * valid).sum(-1) / (valid.sum(-1) + 1e-5)


def supervised_agents(gt_valid, agent_mask):
    """[B * A] 1 where an agent is supervised: in ``agent_mask`` [B, A]
    with at least one valid step of ``gt_valid`` [B, A, T]."""
    b, a_, t_ = gt_valid.shape
    valid = gt_valid.reshape(b * a_, t_).float()
    return agent_mask.reshape(b * a_).float() * (valid.sum(-1) > 0)


def traj_loss(log_scores, trajs, gt_traj, gt_valid, agent_mask, num_agents,
              use_variance: bool = True, cls_loss_weight: float = 0.5,
              nll_loss_weight: float = 0.5, loss_weight_minade: float = 0.0,
              loss_weight_minfde: float = 0.25):
    """One layer's MTP loss over the supervised agents: log_scores [B, A,
    P], trajs [B, A, P, T, 5], gt_traj [B, A, T, 2], gt_valid [B, A, T],
    agent_mask [B, A] -> dict(loss_traj, l_class, l_reg, l_minade,
    l_minfde, l_mr). Each term is summed over the supervised agents
    (``supervised_agents``) and divided by ``num_agents``, the global
    batch's count of them."""
    b, a_, p_, t_, _ = trajs.shape
    traj = trajs.reshape(b * a_, p_, t_, 5)
    gt = gt_traj.reshape(b * a_, t_, 2)
    valid = gt_valid.reshape(b * a_, t_).float()
    m = supervised_agents(gt_valid, agent_mask)
    denom = num_agents + 1e-5
    l_minfde, _ = min_fde(traj, gt, valid)
    l_minade, inds = min_ade(traj, gt, valid)
    l_mr = (miss_rate(traj, gt, valid) * m).sum() / denom
    best = torch.gather(traj, 1, inds[:, None, None, None].expand(
        -1, 1, t_, 5)).squeeze(1)
    l_reg = traj_nll(best, gt, valid) if use_variance else l_minade
    lp = log_scores.reshape(b * a_, p_)
    l_class = -torch.gather(lp, 1, inds[:, None]).squeeze(1)
    l_reg = (l_reg * m).sum() / denom
    l_class = (l_class * m).sum() / denom
    l_minade = (l_minade * m).sum() / denom
    l_minfde = (l_minfde * m).sum() / denom
    loss = (l_class * cls_loss_weight + l_reg * nll_loss_weight +
            l_minade * loss_weight_minade + l_minfde * loss_weight_minfde)
    return dict(loss_traj=loss, l_class=l_class, l_reg=l_reg,
                l_minade=l_minade, l_minfde=l_minfde, l_mr=l_mr)
