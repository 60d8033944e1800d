"""The port's voxel renderer (dvxlr / dvr) against the JAX package's, on
the CPU in f32: ``voxel_render`` with padded rays, rays that miss the grid
and an opaque wall, ``voxel_render_loss`` with each loss and its gradient
with respect to sigma, ``voxel_render_forward`` and ``voxel_render_v2``."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidar_tpu_torch.ops import voxel_render as vr

# the module (vidar_tpu.ops exports a function of its name)
jvr = importlib.import_module('vidar_tpu.ops.voxel_render')

# a walk of <= 32 steps: sums of <= 32 terms in other orders, exp
TOL = 1e-4
STEPS = 32          # >= Z + H + W + 1 for the 4 x 8 x 8 grid


def _jax(fn, *args):
    """fn(*args) compiled at XLA's default backend level, not conftest.py's
    level 0: the walk's rounded path voxel depends on whether the position
    update is one fused multiply-add, and level 0 leaves it unfused in
    some compilations and not in others. At the default level XLA fuses
    it, as nvcc does in the reference's kernel, and the port computes it
    so."""
    return jax.jit(fn).lower(*args).compile(compiler_options=dict(
        xla_backend_optimization_level=3))(*args)


def _close(got, want, what, tol=TOL):
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-12), (
        what, err, np.abs(want).max())


def _scene(seed=0):
    """Two frames of a 4 x 8 x 8 grid, 48 rays per sample: a third padded,
    some ending outside the grid, some starting outside it and missing
    it; frame 1 holds an opaque wall at x = 5."""
    rng = np.random.default_rng(seed)
    n, t, m = 2, 2, 48
    sigma = rng.uniform(0.0, 0.6, (n, t, 4, 8, 8)).astype(np.float32)
    sigma[:, 1, :, :, 5] = 100.0
    origin = np.concatenate([rng.uniform(1, 7, (n, t, 2)),
                             rng.uniform(0.5, 3.5, (n, t, 1))], -1)
    origin[1, 0] = (-3.0, 4.2, 1.5)          # outside the grid
    points = np.concatenate([rng.uniform(-4, 12, (n, m, 2)),
                             rng.uniform(-1, 5, (n, m, 1))], -1)
    points[1, :4] = (-3.0, 12.0, 1.5)        # parallel to the grid's edge
    tindex = rng.integers(-1, t, (n, m)).astype(np.int32)
    return (sigma, origin.astype(np.float32), points.astype(np.float32),
            tindex)


@pytest.mark.parametrize('loss', ['l1', 'l2', 'absrel', 'bce'])
def test_render_loss_and_dsigma_match_jax(loss):
    sigma, origin, points, tindex = _scene()
    w = np.random.default_rng(1).uniform(0.5, 1.5, tindex.shape).astype(
        np.float32)

    def run(s):
        def total(s):
            out = jvr.voxel_render_loss(s, origin, points, tindex,
                                        loss=loss, max_steps=STEPS)
            return (out[2] * w).sum(), out
        return jax.grad(total, has_aux=True)(s)

    jgrad, (jpred, jgt, jl) = _jax(run, jnp.asarray(sigma))
    s = torch.from_numpy(sigma).requires_grad_()
    pred, gt, per_ray = vr.voxel_render_loss(
        s, *map(torch.from_numpy, (origin, points, tindex)), loss=loss,
        max_steps=STEPS)
    _close(pred, jpred, 'pred')
    _close(gt, jgt, 'gt')
    _close(per_ray, jl, 'per-ray loss')
    (per_ray * torch.from_numpy(w)).sum().backward()
    _close(s.grad, jgrad, 'd sigma')
    # padded rays and rays that miss the grid give 0; others render
    padded = tindex < 0
    assert not pred.detach().numpy()[padded].any()
    assert (pred.detach().numpy()[~padded] > 0).sum() > 20
    assert (np.asarray(jgt)[~padded] == 0).any()      # a missed ray
    assert float(s.grad.abs().sum()) > 0


def test_opaque_wall_stops_rays():
    """Frame 1's wall at x = 5 on an empty volume: a +x ray from x = 0.5
    renders as in JAX, short of the empty volume's distance."""
    sigma, origin, _, _ = _scene()
    sigma[:, 1, :, :, :5] = 0.0
    origin[0, 1] = (0.5, 4.0, 2.0)
    points = np.array([[[7.5, 4.0, 2.0], [7.5, 4.3, 1.2]]], np.float32)
    points = np.concatenate([points, points], 0)
    tindex = np.ones((2, 2), np.int32)
    want, _ = _jax(lambda s: jvr.voxel_render(s, origin, points, tindex,
                                              max_steps=STEPS), sigma)
    got, _ = vr.voxel_render_forward(*map(torch.from_numpy, (
        sigma, origin, points, tindex)), max_steps=STEPS)
    _close(got, want, 'wall')
    sigma[:, 1] = 0.0
    empty, _ = vr.voxel_render_forward(*map(torch.from_numpy, (
        sigma, origin, points, tindex)), max_steps=STEPS)
    # an empty volume renders the last in-grid distance; the wall less
    assert float(got[0, 0]) < float(empty[0, 0]) - 0.3


def test_render_v2_matches_jax():
    sigma, origin, points, tindex = _scene(2)
    regul = np.random.default_rng(3).uniform(0, 1, sigma.shape).astype(
        np.float32)
    want = _jax(lambda s: jvr.voxel_render_v2(s, origin, points, tindex,
                                              regul, max_steps=STEPS), sigma)
    got = vr.voxel_render_v2(*map(torch.from_numpy, (
        sigma, origin, points, tindex, regul)), max_steps=STEPS)
    for name, g, w in zip(('pred', 'gt', 'ray_pred', 'indicator'), got,
                          want):
        _close(g, w, name)
    assert 0 < float(got[3].sum()) < got[3].numel()
