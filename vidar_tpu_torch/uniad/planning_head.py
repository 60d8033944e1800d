"""The planning head: one ego trajectory per command, then collision
optimisation (port of vidar_tpu/uniad/planning_head.py; reference
planning_head.py, collision_optimization.py, planning_loss.py).

The collision post-process is the JAX package's: a fixed-iteration
gradient descent on the device over the dense occupancy grid (tracking L2 +
a Gaussian collision potential), its gradient written out by hand.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..models.layers import Conv2d, TorchLinear
from .blocks import LinLNReLU, TorchDecoder


class _MLPFuser(nn.Module):
    def __init__(self, in_features: int, out: int, dtype=None, device=None):
        super().__init__()
        self.fuse = LinLNReLU(in_features, out, dtype=dtype, device=device)

    def forward(self, x):
        return self.fuse(x)


class _AdapterBlock(nn.Module):
    """Conv3x3 + ReLU + Conv1x1 residual adapter."""

    def __init__(self, channels: int, dtype=None, device=None):
        super().__init__()
        self.conv0 = Conv2d(channels, channels // 2, 3, padding=1,
                            dtype=dtype, device=device)
        self.conv1 = Conv2d(channels // 2, channels, 1, dtype=dtype,
                            device=device)

    def forward(self, x):
        return self.conv1(torch.relu(self.conv0(x)))


class PlanningHeadSingleMode(nn.Module):
    """Command-conditioned ego planner (planning_head.py:17-201)."""

    def __init__(self, embed_dims: int = 256, planning_steps: int = 6,
                 bev_h: int = 200, bev_w: int = 200,
                 with_adapter: bool = True, use_col_optim: bool = True,
                 occ_filter_range: float = 5.0, sigma: float = 1.0,
                 alpha_collision: float = 5.0,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 dtype=None, device=None):
        super().__init__()
        d = embed_dims
        self.planning_steps = planning_steps
        self.bev_h, self.bev_w = bev_h, bev_w
        self.with_adapter, self.use_col_optim = with_adapter, use_col_optim
        self.occ_filter_range, self.sigma = occ_filter_range, sigma
        self.alpha_collision = alpha_collision
        self.pc_range = tuple(pc_range)
        kw = dict(dtype=dtype, device=device)
        self.navi_embed = nn.Parameter(torch.empty(3, d, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, d, device=device))
        self.mlp_fuser = _MLPFuser(3 * d, d, **kw)
        self.attn_module = TorchDecoder(3, d, 8, d * 2, dropout=0.1, **kw)
        self.reg_fc0 = TorchLinear(d, d, **kw)
        self.reg_fc1 = TorchLinear(d, planning_steps * 2, **kw)
        if with_adapter:
            for i in range(3):
                self.add_module(f'bev_adapter_{i}', _AdapterBlock(d, **kw))

    def forward(self, bev, occ_mask, bev_pos, sdc_traj_query,
                sdc_track_query, command, *, deterministic: bool = True):
        """bev / bev_pos [B, HW, D]; occ_mask [B, T_occ, H, W] or None;
        sdc_traj_query [L, B, P, D] (the last layer used); sdc_track_query
        [B, D]; command [B] in {0, 1, 2}. ``deterministic`` (eval) runs
        the collision optimisation on ``occ_mask``."""
        sdc_track_query = sdc_track_query.detach()
        traj_q = sdc_traj_query[-1]
        bs, p, d = traj_q.shape
        track_q = sdc_track_query[:, None].expand(bs, p, d)
        navi = self.navi_embed[command.long()][:, None].expand(bs, p, d)
        plan_q = self.mlp_fuser(torch.cat([traj_q, track_q, navi], -1))
        plan_q = plan_q.amax(1, keepdim=True)
        feat = bev + bev_pos if bev_pos is not None else bev
        if self.with_adapter:
            x = feat.reshape(bs, self.bev_h, self.bev_w, d).permute(0, 3, 1,
                                                                    2)
            for i in range(3):
                x = x + getattr(self, f'bev_adapter_{i}')(x)
            feat = x.permute(0, 2, 3, 1).reshape(bs, -1, d)
        plan_q = self.attn_module(plan_q + self.pos_embed[None], feat)
        traj = self.reg_fc1(torch.relu(self.reg_fc0(plan_q[:, 0])))
        traj = torch.cumsum(traj.reshape(bs, self.planning_steps, 2), 1)
        if self.use_col_optim and deterministic and occ_mask is not None:
            traj = collision_optimize(
                traj, occ_mask, bev_h=self.bev_h, bev_w=self.bev_w,
                occ_filter_range=self.occ_filter_range, sigma=self.sigma,
                alpha_collision=self.alpha_collision,
                pc_range=self.pc_range)
        return dict(sdc_traj=traj, sdc_traj_all=traj)


@torch.no_grad()
def collision_optimize(traj, occ_mask, *, bev_h: int = 200,
                       bev_w: int = 200, occ_filter_range: float = 5.0,
                       sigma: float = 1.0, alpha_collision: float = 5.0,
                       n_iters: int = 50, lr: float = 0.1,
                       pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2,
                                                    51.2, 3.0)):
    """Refine [B, T, 2] waypoints against [B, T_occ, H, W] occupancy by
    ``n_iters`` steps of gradient descent on

      sum_t ||p_t - ref_t||^2
      + alpha / (2.507 sigma) sum_occupied exp(-||p_t - c||^2 / 2 sigma^2)

    over the occupied cells within ``occ_filter_range`` of the waypoint
    (cell centres from ``pc_range``); waypoint t reads occupancy slice
    min(t + 1, T_occ - 1)."""
    t_occ = occ_mask.shape[1]
    steps = traj.shape[1]
    ref = traj.detach()
    cell_h = (pc_range[4] - pc_range[1]) / bev_h
    cell_w = (pc_range[3] - pc_range[0]) / bev_w
    dev = traj.device
    ys = pc_range[1] + (torch.arange(bev_h, dtype=torch.float32,
                                     device=dev) + 0.5) * cell_h
    xs = pc_range[0] + (torch.arange(bev_w, dtype=torch.float32,
                                     device=dev) + 0.5) * cell_w
    tidx = (torch.arange(steps, device=dev) + 1).clamp(max=t_occ - 1)
    occ_t = occ_mask[:, tidx]                       # [B, steps, H, W]
    norm = alpha_collision / (2.507 * sigma)
    p = traj.detach()
    for _ in range(n_iters):
        dx = p[..., 0][:, :, None, None] - xs[None, None, None, :]
        dy = p[..., 1][:, :, None, None] - ys[None, None, :, None]
        d2 = dx * dx + dy * dy
        in_range = (d2 < occ_filter_range ** 2).float()
        # d/dp of norm * exp(-d2 / 2 sigma^2): the potential times
        # -(dx, dy) / sigma^2
        w = norm * torch.exp(-d2 / (2.0 * sigma ** 2)) * occ_t * in_range
        w = w * (-1.0 / sigma ** 2)
        grad = 2.0 * (p - ref) + torch.stack(
            [(w * dx).sum((2, 3)), (w * dy).sum((2, 3))], -1)
        p = p - lr * grad
    return p


def planning_loss(sdc_traj, gt_traj, mask, num_valid):
    """Masked L2 ADE (PlanningLoss): the error summed over the steps in
    ``mask`` and divided by ``num_valid``, the global batch's count of
    them."""
    err = torch.linalg.norm(sdc_traj[..., :2] - gt_traj[..., :2], dim=-1)
    return (err * mask.float()).sum() / (num_valid + 1e-5)

