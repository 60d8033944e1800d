"""Ray sampling, the ray losses and the eval depth decode (port of
vidar_tpu/models/ray_loss.py). Voxel-grid convention: grid index g in
[0, size], sampled at pixel coordinate g - 0.5 (grid_sample,
align_corners=False, zeros outside)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.gather import bilinear_corners
from ..parallel.mesh import global_sum

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
        g = flat.index_select(0, (idx + base).reshape(-1)).reshape(
            bs, pc, s, zdim)
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
    outside [bs, P, S] bool). Under autograd each chunk's sampling is
    checkpointed: its [bs, chunk, S, Z] corner gathers are recomputed in
    the backward pass instead of kept (as the JAX package's
    ``jax.checkpoint``, vidar_tpu/models/vidar_head.py:229-232).
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
        fi = frame_idx[:, sl]
        if torch.is_grad_enabled() and flat.requires_grad:
            feats.append(checkpoint(_sample_chunk, flat, bs, v, h, w, zdim,
                                    way, fi, use_reentrant=False))
        else:
            feats.append(_sample_chunk(flat, bs, v, h, w, zdim, way, fi))
    return torch.cat(feats, dim=1), torch.cat(outside, dim=1)


class RayFeatures(NamedTuple):
    feats: torch.Tensor      # [bs, P, G+1] waypoint logits, NEG_INF outside
    lengths: torch.Tensor    # [bs, P, G+1] distance from the origin (grid)
    ray_valid: torch.Tensor  # [bs, P] bool: the ray's GT point is inside
    outside: torch.Tensor    # [bs, P, G+1] bool: waypoint outside the volume


def ray_waypoint_features(sigma: torch.Tensor, origin_grids: torch.Tensor,
                          gt_grids: torch.Tensor, frame_idx: torch.Tensor,
                          ray_grid_num: int, ray_grid_step: float,
                          chunk: int = RAY_CHUNK) -> RayFeatures:
    """Waypoints along each origin -> GT ray of the per-frame volumes
    sigma [bs, V, Z, H, W] (ray_loss.py:229-271): waypoint 0 is the GT point
    itself (the CE positive), waypoints 1..G march from the frame origin
    origin_grids [bs, V, 3] at (k + 0.5) * step; gt_grids [bs, P, 3],
    frame_idx [bs, P] (outside [0, V): an ignored lane). Lengths are closed
    form; samples outside the volume are NEG_INF."""
    v, zdim, h, w = sigma.shape[1:]
    fi_safe = frame_idx.clamp(0, v - 1).to(torch.int64)
    origin = torch.gather(origin_grids, 1,
                          fi_safe[..., None].expand(-1, -1, 3))
    r = gt_grids - origin
    r_sq = (r ** 2).sum(-1, keepdim=True)
    r_norm = r / torch.sqrt(torch.clamp(r_sq, min=1e-12))
    steps = (torch.arange(ray_grid_num, dtype=torch.float32,
                          device=sigma.device) + 0.5) * ray_grid_step
    rn_len = torch.sqrt((r_norm ** 2).sum(-1, keepdim=True))
    lengths = torch.cat([torch.sqrt(torch.clamp(r_sq, min=0.0)),
                         steps[None, None, :] * rn_len], dim=2)
    size = torch.tensor([w, h, zdim], dtype=torch.float32,
                        device=sigma.device)
    norm0 = gt_grids / size * 2.0 - 1.0
    ray_valid = ((norm0 > -1.0) & (norm0 < 1.0)).all(-1)
    feats, outside = sample_sigma_rays(sigma, origin, r_norm, gt_grids,
                                       steps, frame_idx, chunk=chunk)
    feats = torch.where(outside, torch.full_like(feats, NEG_INF), feats)
    return RayFeatures(feats, lengths, ray_valid, outside)


def ray_ce_loss(feats: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Cross entropy along each ray, the GT waypoint (index 0) positive:
    sum(w * CE) / max(sum(w), 1) (ray_loss.py:274-286), the weights summed
    over the global batch (every rank's) before the clamp, as JAX's step
    sums them over its global batch."""
    ce = torch.logsumexp(feats, dim=-1) - feats[..., 0]
    return (ce * weights).sum() / torch.clamp(global_sum(weights.sum()),
                                              min=1.0)


def gumbel_softmax_distance(feats: torch.Tensor, lengths: torch.Tensor,
                            generator: Optional[torch.Generator]
                            ) -> torch.Tensor:
    """Straight-through expected-distance decode (ray_loss.py:289-315): a
    hard Gumbel sample picks a waypoint whose (detached) length is the
    distance; the differentiable factor is P(the waypoints beyond it).
    ``generator`` None takes the argmax instead of a sample. The noise is
    -log(-log(u)), u uniform in [1e-20, 1)."""
    noisy = feats
    if generator is not None:
        u = torch.rand(feats.shape, generator=generator,
                       device=generator.device) * (1.0 - 1e-20) + 1e-20
        noisy = feats + (-torch.log(-torch.log(u))).to(feats.device)
    hard_idx = torch.argmax(noisy, dim=-1)
    pred_dist = torch.gather(lengths, -1, hard_idx[..., None])[..., 0]
    pred_dist = pred_dist.detach()
    shifted = feats - feats.max(-1, keepdim=True).values.detach()
    e = torch.exp(shifted)
    nxt = (lengths > pred_dist[..., None]).float()
    prob_next = (e * nxt).sum(-1) / torch.clamp(e.sum(-1), min=1e-20)
    prob_next = 1.0 - prob_next.detach() + prob_next
    return prob_next * pred_dist


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
