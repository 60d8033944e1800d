"""Ray sampling and the eval depth decode (port of the eval parts of
vidar_tpu/models/ray_loss.py). Voxel-grid convention: grid index g in
[0, size], sampled at pixel coordinate g - 0.5 (grid_sample,
align_corners=False, zeros outside)."""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.gather import bilinear_corners

NEG_INF = -1e9
RAY_CHUNK = 4096  # rays per sampling step


def coords_to_voxel_grids(xyz: torch.Tensor, bev_h: int, bev_w: int,
                          pillar_num: int, pc_range: Sequence[float]):
    """Metric coords -> continuous voxel-grid coords [0, size] per axis."""
    pc = pc_range
    gx = (xyz[..., 0] - pc[0]) / (pc[3] - pc[0]) * bev_w
    gy = (xyz[..., 1] - pc[1]) / (pc[4] - pc[1]) * bev_h
    gz = (xyz[..., 2] - pc[2]) / (pc[5] - pc[2]) * pillar_num
    return torch.stack([gx, gy, gz], dim=-1)


def _sample_chunk(flat, bs, v, h, w, zdim, way, fi):
    """Trilinear sample of the per-frame volumes at ``way`` [bs, pc, S, 3]
    for rays of frame ``fi`` [bs, pc] -> [bs, pc, S] f32."""
    pc, s = way.shape[1], way.shape[2]
    px = way[..., 0].float() - 0.5
    py = way[..., 1].float() - 0.5
    pz = way[..., 2].float() - 0.5
    fi = fi[:, :, None]
    frame_ok = ((fi >= 0) & (fi < v)).float()
    base = (torch.arange(bs, device=way.device)[:, None, None] * v +
            fi.clamp(0, v - 1)) * (h * w)
    xy = None
    for idx, wgt in bilinear_corners(px, py, h, w):
        g = flat[(idx + base).reshape(-1)].reshape(bs, pc, s, zdim)
        term = g * (wgt * frame_ok)[..., None]
        xy = term if xy is None else xy + term
    # linear in z with zeros outside [0, Z)
    z0 = torch.floor(pz)
    wz1 = pz - z0
    iz0 = z0.to(torch.int64)
    out = None
    for iz, wz in ((iz0, 1.0 - wz1), (iz0 + 1, wz1)):
        ok = ((iz >= 0) & (iz < zdim)).float()
        val = torch.gather(xy, 3, iz.clamp(0, zdim - 1)[..., None])[..., 0]
        term = val * (wz * ok)
        out = term if out is None else out + term
    return out


def sample_sigma_rays(sigma: torch.Tensor, origin: torch.Tensor,
                      r_norm: torch.Tensor, gt_grids: torch.Tensor,
                      steps: torch.Tensor, frame_idx: torch.Tensor,
                      with_gt_waypoint: bool = True, chunk: int = RAY_CHUNK):
    """Sample waypoints origin + r_norm * step (and, first, the GT point when
    ``with_gt_waypoint``) from per-frame volumes sigma [bs, V, Z, H, W].

    origin/r_norm/gt_grids [bs, P, 3] voxel coords; frame_idx [bs, P]
    (rays outside [0, V) sample zeros). Returns (feats [bs, P, S] f32,
    outside [bs, P, S] bool).
    """
    bs, v, zdim, h, w = sigma.shape
    flat = sigma.permute(0, 1, 3, 4, 2).reshape(bs * v * h * w, zdim).float()
    size = torch.tensor([w, h, zdim], dtype=torch.float32,
                        device=sigma.device)
    feats, outside = [], []
    for p0 in range(0, origin.shape[1], chunk):
        sl = slice(p0, p0 + chunk)
        way = (origin[:, sl, None, :] +
               r_norm[:, sl, None, :] * steps[None, None, :, None])
        if with_gt_waypoint:
            way = torch.cat([gt_grids[:, sl, None, :], way], dim=2)
        norm = way / size * 2.0 - 1.0
        outside.append(((norm <= -1.0) | (norm >= 1.0)).any(-1))
        feats.append(_sample_chunk(flat, bs, v, h, w, zdim, way,
                                   frame_idx[:, sl]))
    return torch.cat(feats, dim=1), torch.cat(outside, dim=1)


def argmax_ray_depth(sigma: torch.Tensor, origin_grids: torch.Tensor,
                     gt_grids: torch.Tensor, frame_idx: torch.Tensor,
                     ray_grid_num: int, ray_grid_step: float):
    """Eval depth decode: march G waypoints from the frame origin towards
    each GT point, mask exactly-zero samples (the zero padding outside the
    volume) to -inf, and take the argmax waypoint's distance. Returns
    (pred_dist, gt_dist) [bs, P] in grid units."""
    v = sigma.shape[1]
    fi_safe = frame_idx.clamp(0, v - 1).to(torch.int64)
    origin = torch.gather(origin_grids, 1, fi_safe[..., None].expand(-1, -1,
                                                                       3))
    r = gt_grids - origin
    gt_dist = torch.sqrt(torch.clamp((r ** 2).sum(-1), min=0.0))
    r_norm = r / torch.sqrt(torch.clamp((r ** 2).sum(-1, keepdim=True),
                                        min=1e-12))
    steps = (torch.arange(ray_grid_num, dtype=torch.float32,
                          device=sigma.device) + 0.5) * ray_grid_step
    lengths = steps[None, None, :] * torch.sqrt(
        (r_norm ** 2).sum(-1, keepdim=True))
    s, _ = sample_sigma_rays(sigma, origin, r_norm, gt_grids, steps,
                             frame_idx, with_gt_waypoint=False)
    s = torch.where(s == 0.0, torch.full_like(s, NEG_INF), s)
    idx = torch.argmax(s, dim=-1)
    pred_dist = torch.gather(lengths, -1, idx[..., None])[..., 0]
    return pred_dist, gt_dist
