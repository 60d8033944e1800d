"""UniAD's trajectory and anchor transforms (port of
vidar_tpu/uniad/functional.py): agents are fixed-capacity tensors
(``centers [B, A, 2]``, ``yaw [B, A]``) with a validity mask."""

from __future__ import annotations

import math

import torch


def bivariate_gaussian_activation(x: torch.Tensor) -> torch.Tensor:
    """Raw 5-vectors -> (mu_x, mu_y, sig_x, sig_y, rho): exp on the sigmas,
    tanh on the correlation."""
    return torch.cat([x[..., 0:2], torch.exp(x[..., 2:4]),
                      torch.tanh(x[..., 4:5])], -1)


def norm_points(pos: torch.Tensor, pc_range) -> torch.Tensor:
    """xy points -> [0, 1] over the BEV perception range."""
    x = (pos[..., 0] - pc_range[0]) / (pc_range[3] - pc_range[0])
    y = (pos[..., 1] - pc_range[1]) / (pc_range[4] - pc_range[1])
    return torch.stack([x, y], -1)


def pos2posemb2d(pos: torch.Tensor, num_pos_feats: int = 128,
                 temperature: float = 10000.0) -> torch.Tensor:
    """Sine/cosine embedding of normalised 2-D positions, (y, x) order:
    [..., 2] -> [..., 2 * num_pos_feats]."""
    pos = pos * (2.0 * math.pi)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=pos.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    px = pos[..., 0, None] / dim_t
    py = pos[..., 1, None] / dim_t
    px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()],
                     -1).reshape(*px.shape[:-1], -1)
    py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()],
                     -1).reshape(*py.shape[:-1], -1)
    return torch.cat([py, px], -1)


def rot_2d(yaw: torch.Tensor) -> torch.Tensor:
    """Rotation matrices of yaw angles: [...] -> [..., 2, 2]."""
    sy, cy = torch.sin(yaw), torch.cos(yaw)
    return torch.stack([torch.stack([cy, -sy], -1),
                        torch.stack([sy, cy], -1)], -2)


def anchor_coordinate_transform(anchors: torch.Tensor, centers: torch.Tensor,
                                yaw: torch.Tensor,
                                with_translation: bool = True,
                                with_rotation: bool = True) -> torch.Tensor:
    """Anchors [G, P, T, 2] into each agent's frame -> [B, A, G, P, T, 2]:
    rotated by yaw - pi, then moved to the agent's centre."""
    shape = tuple(yaw.shape) + tuple(anchors.shape)
    out = anchors[None, None].expand(shape)
    if with_rotation:
        rot = rot_2d(yaw - math.pi)                       # [B, A, 2, 2]
        out = torch.einsum('bars,bagpts->bagptr', rot, out)
    if with_translation:
        out = out + centers[:, :, None, None, None, :]
    return out.expand(shape)


def trajectory_coordinate_transform(traj: torch.Tensor, centers: torch.Tensor,
                                    yaw: torch.Tensor,
                                    with_translation: bool = True,
                                    with_rotation: bool = True
                                    ) -> torch.Tensor:
    """Agent-frame trajectories [B, A, P, T, 2] by each agent's pose: the
    inverse rotation of the anchors', R(yaw - pi)^T, then the centre."""
    out = traj
    if with_rotation:
        rot = rot_2d(yaw - math.pi)
        out = torch.einsum('baptc,bacr->baptr', out, rot)
    if with_translation:
        out = out + centers[:, :, None, None, :]
    return out
