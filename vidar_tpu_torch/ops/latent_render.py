"""The two ray passes of latent rendering (port of the fused forms in
vidar_tpu/models/latent_rendering.py and vidar_tpu/ops/latent_render_pallas.py).

Both passes walk, for every BEV cell, the radial ray from the map centre
through the cell: waypoint k of cell n is ``(0.5 + radial_norm[n] *
steps[k]) * 2 - 1`` in [-1, 1] map coordinates. ``grids`` [N, 2] are the
cell centres in [0, 1], ``radial_norm`` [N, 2] the unit directions (zero for
the centre cell) and ``steps`` [G] the step lengths.

* ``ray_first_hit`` (K3, ``csrc/ray_first_hit.cu``): per cell and height
  bin, prod(1 - p * inside) over the waypoints times p at the cell itself,
  p = act(bilinear occupancy logit) -> [B, N, Z] f32 (spec:
  ``_first_hit_xla``, latent_rendering.py:81-105).
* ``ray_aggregate`` (K4, ``csrc/ray_aggregate.cu``): sum(feat * prob) /
  (sum(prob) + eps) over the waypoints inside the map's boundary square,
  feature channel k weighted by probability channel k // (c_r / Z) ->
  [B, N, c_r] f32 (spec: ``_aggregate_xla``, :310-340).

CUDA tensors run ``torch.autograd.Function``s whose forwards are K3/K4 and
whose backwards are K6/K7 (``csrc/ray_first_hit_bwd.cu``, one kernel for
both TPU kernels) and K8 (``csrc/ray_aggregate_bwd.cu``); only the map gets
a gradient, the geometry is constant (as in the JAX ``custom_vjp``s,
latent_rendering.py:226-298, :397-468). CPU tensors run the plain versions,
and autograd differentiates those.
"""

from __future__ import annotations

import torch

from ._build import (KernelCounter, check, load_library, on_device,
                     stream_of)
from .grid_sample import grid_sample_2d

FIRST_HIT = KernelCounter(
    'ray_first_hit_forward', source='vidar_tpu_torch/csrc/ray_first_hit.cu',
    replaces='vidar_tpu/ops/latent_render_pallas.py:141 (ray_prob_fused)')
AGGREGATE = KernelCounter(
    'ray_aggregate_forward', source='vidar_tpu_torch/csrc/ray_aggregate.cu',
    replaces='vidar_tpu/ops/latent_render_pallas.py:379 (ray_agg_fused)')
FIRST_HIT_BACKWARD = KernelCounter(
    'ray_first_hit_backward',
    source='vidar_tpu_torch/csrc/ray_first_hit_bwd.cu',
    replaces='vidar_tpu/ops/latent_render_pallas.py:526 (ray_prob_dlogit), '
             ':657 (ray_prob_scatter)')
AGGREGATE_BACKWARD = KernelCounter(
    'ray_aggregate_backward',
    source='vidar_tpu_torch/csrc/ray_aggregate_bwd.cu',
    replaces='vidar_tpu/ops/latent_render_pallas.py:334 (ray_agg_fused_bwd)')

RAY_CHUNK = 4096  # cells per step of the plain versions


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == 'exp':
        return 1.0 - torch.exp(-torch.relu(x))
    if act == 'sigmoid':
        return torch.sigmoid(x)
    raise NotImplementedError(act)


def _waypoints(radial_norm, steps):
    """[Nc, 2], [G] -> [Nc, G, 2] waypoints in [-1, 1]."""
    return (0.5 + radial_norm[:, None, :] * steps[None, :, None]) * 2.0 - 1.0


def _sample(fmap, pts):
    """fmap [B, H, W, C], pts [Nc, S, 2] in [-1, 1] -> [B, Nc, S, C] f32."""
    b = fmap.shape[0]
    nc, s, _ = pts.shape
    grid = pts.reshape(1, nc * s, 2).expand(b, -1, -1)
    return grid_sample_2d(fmap, grid).reshape(b, nc, s, -1)


def ray_first_hit_plain(occ, grids, radial_norm, steps, act: str):
    """Plain PyTorch version of K3: occ [B, H, W, Z] -> [B, N, Z] f32."""
    outs = []
    for n0 in range(0, grids.shape[0], RAY_CHUNK):
        g = grids[n0:n0 + RAY_CHUNK]
        path = torch.cat([_waypoints(radial_norm[n0:n0 + RAY_CHUNK], steps),
                          (g * 2.0 - 1.0)[:, None, :]], dim=1)
        path_len = torch.sqrt((path ** 2).sum(-1))
        inside = (path_len < path_len[:, -1:]).float()       # [Nc, G+1]
        p = _act(_sample(occ, path), act)                     # [B, Nc, G+1, Z]
        trans = torch.prod(1.0 - p * inside[None, :, :, None], dim=2)
        outs.append(trans * p[:, :, -1])
    return torch.cat(outs, dim=1)


def ray_aggregate_plain(fused_map, grids, radial_norm, steps, c_r: int,
                        zdim: int, eps: float):
    """Plain PyTorch version of K4: fused_map [B, H, W, c_r + Z] ->
    [B, N, c_r] f32."""
    b = fused_map.shape[0]
    group = c_r // zdim
    outs = []
    for n0 in range(0, grids.shape[0], RAY_CHUNK):
        rn = radial_norm[n0:n0 + RAY_CHUNK]
        way = _waypoints(rn, steps)                           # [Nc, G, 2]
        boundary = torch.minimum(1.0 / rn[:, 0:1].abs(),
                                 1.0 / rn[:, 1:2].abs())
        valid = (torch.sqrt((way ** 2).sum(-1)) < boundary).float()
        fused = _sample(fused_map, way)                       # [B, Nc, G, C]
        nc, g = way.shape[:2]
        prob = fused[..., c_r:] * valid[None, :, :, None]
        feat = fused[..., :c_r].reshape(b, nc, g, zdim, group)
        num = (feat * prob[..., None]).sum(2).reshape(b, nc, c_r)
        den = prob.sum(2).repeat_interleave(group, dim=-1)
        outs.append(num / (den + eps))
    return torch.cat(outs, dim=1)


def _check_geometry(name, fmap, grids, radial_norm, steps):
    dev = fmap.device
    if not (fmap.is_cuda and grids.device == radial_norm.device ==
            steps.device == dev):
        raise ValueError(f'{name}: all inputs must be on one CUDA device')
    if fmap.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'{name}: map dtype {fmap.dtype}')
    if not all(t.dtype == torch.float32 for t in (grids, radial_norm, steps)):
        raise TypeError(f'{name}: grids, radial_norm, steps must be float32')
    n = grids.shape[0]
    if (fmap.dim() != 4 or grids.shape != (n, 2) or
            radial_norm.shape != (n, 2) or steps.dim() != 1):
        raise ValueError(f'{name}: shapes map {tuple(fmap.shape)}, grids '
                         f'{tuple(grids.shape)}, radial '
                         f'{tuple(radial_norm.shape)}, steps '
                         f'{tuple(steps.shape)}')
    if not all(t.is_contiguous()
               for t in (fmap, grids, radial_norm, steps)):
        raise ValueError(f'{name}: inputs must be contiguous')


# ray_first_hit_route's codes
FIRST_HIT_ROUTES = {1: 'vector', 0: 'first design'}


def ray_first_hit_route(occ) -> str:
    """Which K3 kernel ``ray_first_hit_cuda`` runs for the map occ [B, H, W,
    Z]: 'vector' (Z = 16 or 4, the presets', on a 16-byte boundary) or
    'first design' (any other Z or alignment). The wrapper's output is a
    fresh, aligned allocation (0 stands for its address)."""
    return FIRST_HIT_ROUTES[load_library().ray_first_hit_route(
        occ.data_ptr(), 0, occ.shape[-1])]


def ray_first_hit_cuda(occ, grids, radial_norm, steps, act: str):
    """Launch K3 -> [B, N, Z] f32 (any Z and alignment: see
    ``ray_first_hit_route``)."""
    _check_geometry('ray_first_hit_forward', occ, grids, radial_norm, steps)
    if act not in ('exp', 'sigmoid'):
        raise NotImplementedError(act)
    b, h, w, z = occ.shape
    n, g = grids.shape[0], steps.shape[0]
    out = torch.empty(b, n, z, dtype=torch.float32, device=occ.device)
    lib = load_library()
    with on_device(occ.device):
        rc = lib.ray_first_hit_forward(
            occ.data_ptr(), int(occ.dtype == torch.bfloat16),
            grids.data_ptr(), radial_norm.data_ptr(), steps.data_ptr(),
            out.data_ptr(), b, h, w, z, n, g, int(act == 'exp'),
            stream_of(occ))
    check(rc, 'ray_first_hit_forward')
    FIRST_HIT.launched(occ=occ, grids=grids, radial_norm=radial_norm,
                       steps=steps, act=act)
    return out


def ray_aggregate_cuda(fused_map, grids, radial_norm, steps, c_r: int,
                       zdim: int, eps: float):
    """Launch K4 -> [B, N, c_r] f32."""
    _check_geometry('ray_aggregate_forward', fused_map, grids, radial_norm,
                    steps)
    b, h, w, ct = fused_map.shape
    if ct != c_r + zdim or zdim <= 0 or c_r % zdim:
        raise ValueError(f'ray_aggregate_forward: {ct} channels for c_r='
                         f'{c_r}, Z={zdim}')
    n, g = grids.shape[0], steps.shape[0]
    out = torch.empty(b, n, c_r, dtype=torch.float32,
                      device=fused_map.device)
    lib = load_library()
    with on_device(fused_map.device):
        rc = lib.ray_aggregate_forward(
            fused_map.data_ptr(), int(fused_map.dtype == torch.bfloat16),
            grids.data_ptr(), radial_norm.data_ptr(), steps.data_ptr(),
            out.data_ptr(), b, h, w, ct, c_r, zdim, n, g, float(eps),
            stream_of(fused_map))
    check(rc, 'ray_aggregate_forward')
    AGGREGATE.launched(fused_map=fused_map, grids=grids,
                       radial_norm=radial_norm, steps=steps, c_r=c_r,
                       zdim=zdim, eps=eps)
    return out


def _check_grad(name, g, shape, dev):
    if g.device != dev or g.dtype != torch.float32 or \
            tuple(g.shape) != tuple(shape) or not g.is_contiguous():
        raise ValueError(f'{name}: upstream gradient {tuple(g.shape)} '
                         f'{g.dtype} must be contiguous f32 {tuple(shape)} '
                         f'on {dev}')


# ray_first_hit_backward_route's codes
FIRST_HIT_BACKWARD_ROUTES = {1: 'vector', 0: 'scalar'}


def ray_first_hit_backward_route(occ, g) -> str:
    """Which K6/K7 kernel ``ray_first_hit_backward_cuda`` runs for the map
    occ [B, H, W, Z] and the gradient g [B, N, Z]: 'vector' (a warp per
    cell; Z = 16 or 4, the presets', occ and g on 16-byte boundaries) or
    'scalar' (a thread per (cell, bin); any other Z or alignment). The
    wrapper's d occ is a fresh, aligned allocation (0 stands for its
    address)."""
    return FIRST_HIT_BACKWARD_ROUTES[
        load_library().ray_first_hit_backward_route(
            occ.data_ptr(), g.data_ptr(), 0, occ.shape[-1])]


def ray_first_hit_backward_cuda(occ, grids, radial_norm, steps, act: str,
                                g):
    """Launch K6/K7: d occ [B, H, W, Z] (occ's dtype, accumulated in f32)
    from the gradient g [B, N, Z] f32 of K3's output; any Z, G and alignment
    (see ``ray_first_hit_backward_route``)."""
    _check_geometry('ray_first_hit_backward', occ, grids, radial_norm,
                    steps)
    if act not in ('exp', 'sigmoid'):
        raise NotImplementedError(act)
    b, h, w, z = occ.shape
    n, ng = grids.shape[0], steps.shape[0]
    _check_grad('ray_first_hit_backward', g, (b, n, z), occ.device)
    docc = torch.zeros(b, h, w, z, dtype=torch.float32, device=occ.device)
    lib = load_library()
    with on_device(occ.device):
        rc = lib.ray_first_hit_backward(
            occ.data_ptr(), int(occ.dtype == torch.bfloat16),
            grids.data_ptr(), radial_norm.data_ptr(), steps.data_ptr(),
            g.data_ptr(), docc.data_ptr(), b, h, w, z, n, ng,
            int(act == 'exp'), stream_of(occ))
    check(rc, 'ray_first_hit_backward')
    FIRST_HIT_BACKWARD.launched(occ=occ, grids=grids,
                                radial_norm=radial_norm, steps=steps,
                                act=act, g=g)
    return docc.to(occ.dtype)


# ray_aggregate_backward_route's codes
AGGREGATE_BACKWARD_ROUTES = {1: 'vector', 0: 'scalar'}


def ray_aggregate_backward_route(fused_map, g) -> str:
    """Which K8 kernel ``ray_aggregate_backward_cuda`` runs for the map
    fused_map [B, H, W, c_r + Z] and the gradient g [B, N, c_r]: 'vector' (a
    warp per cell; (c_r, Z) = (16, 16) or (4, 4), the presets', the map and
    g on 16-byte boundaries) or 'scalar' (a thread per (cell, feature
    channel); any other (c_r, Z) or alignment). The wrapper's d fused_map
    is a fresh, aligned allocation (0 stands for its address)."""
    c_r = g.shape[-1]
    return AGGREGATE_BACKWARD_ROUTES[
        load_library().ray_aggregate_backward_route(
            fused_map.data_ptr(), g.data_ptr(), 0, c_r,
            fused_map.shape[-1] - c_r)]


def ray_aggregate_backward_cuda(fused_map, grids, radial_norm, steps,
                                c_r: int, zdim: int, eps: float, g):
    """Launch K8: d fused_map [B, H, W, c_r + Z] (the map's dtype,
    accumulated in f32) from the gradient g [B, N, c_r] f32 of K4's output;
    any (c_r, Z), G and alignment (see ``ray_aggregate_backward_route``)."""
    _check_geometry('ray_aggregate_backward', fused_map, grids, radial_norm,
                    steps)
    b, h, w, ct = fused_map.shape
    if ct != c_r + zdim or zdim <= 0 or c_r % zdim:
        raise ValueError(f'ray_aggregate_backward: {ct} channels for c_r='
                         f'{c_r}, Z={zdim}')
    n, ng = grids.shape[0], steps.shape[0]
    _check_grad('ray_aggregate_backward', g, (b, n, c_r), fused_map.device)
    dmap = torch.zeros(b, h, w, ct, dtype=torch.float32,
                       device=fused_map.device)
    lib = load_library()
    with on_device(fused_map.device):
        rc = lib.ray_aggregate_backward(
            fused_map.data_ptr(), int(fused_map.dtype == torch.bfloat16),
            grids.data_ptr(), radial_norm.data_ptr(), steps.data_ptr(),
            g.data_ptr(), dmap.data_ptr(), b, h, w, ct, c_r, zdim, n, ng,
            float(eps), stream_of(fused_map))
    check(rc, 'ray_aggregate_backward')
    AGGREGATE_BACKWARD.launched(fused_map=fused_map, grids=grids,
                                radial_norm=radial_norm, steps=steps,
                                c_r=c_r, zdim=zdim, eps=eps, g=g)
    return dmap.to(fused_map.dtype)


class _FirstHit(torch.autograd.Function):
    """K3 forward, K6/K7 backward; d occ only."""

    @staticmethod
    def forward(ctx, occ, grids, radial_norm, steps, act):
        ctx.act = act
        ctx.save_for_backward(occ, grids, radial_norm, steps)
        return ray_first_hit_cuda(occ, grids, radial_norm, steps, act)

    @staticmethod
    def backward(ctx, g):
        occ, grids, radial_norm, steps = ctx.saved_tensors
        docc = ray_first_hit_backward_cuda(occ, grids, radial_norm, steps,
                                           ctx.act, g.float().contiguous())
        return docc, None, None, None, None


class _Aggregate(torch.autograd.Function):
    """K4 forward, K8 backward; d fused_map only."""

    @staticmethod
    def forward(ctx, fused_map, grids, radial_norm, steps, c_r, zdim, eps):
        ctx.args = (c_r, zdim, eps)
        ctx.save_for_backward(fused_map, grids, radial_norm, steps)
        return ray_aggregate_cuda(fused_map, grids, radial_norm, steps, c_r,
                                  zdim, eps)

    @staticmethod
    def backward(ctx, g):
        fused_map, grids, radial_norm, steps = ctx.saved_tensors
        dmap = ray_aggregate_backward_cuda(fused_map, grids, radial_norm,
                                           steps, *ctx.args,
                                           g.float().contiguous())
        return dmap, None, None, None, None, None, None


def ray_first_hit(occ, grids, radial_norm, steps, act: str):
    """First-hit probability [B, N, Z] f32: K3 (backward K6/K7) on CUDA,
    plain on CPU."""
    if occ.device.type == 'cpu':
        return ray_first_hit_plain(occ, grids, radial_norm, steps, act)
    return _FirstHit.apply(occ.contiguous(), grids.float().contiguous(),
                           radial_norm.float().contiguous(),
                           steps.float().contiguous(), act)


def ray_aggregate(fused_map, grids, radial_norm, steps, c_r: int, zdim: int,
                  eps: float):
    """Prob-weighted ray aggregation [B, N, c_r] f32: K4 (backward K8) on
    CUDA, plain on CPU."""
    if fused_map.device.type == 'cpu':
        return ray_aggregate_plain(fused_map, grids, radial_norm, steps, c_r,
                                   zdim, eps)
    return _Aggregate.apply(fused_map.contiguous(),
                            grids.float().contiguous(),
                            radial_norm.float().contiguous(),
                            steps.float().contiguous(), c_r, zdim, eps)
