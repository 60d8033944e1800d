"""Gradients of the port's two ray passes against ``jax.vjp`` of the JAX
package's XLA forms, ``_first_hit_xla`` and ``_aggregate_xla``
(vidar_tpu/models/latent_rendering.py:81, :310), on the CPU.

The port differentiates its plain versions with autograd here; on the card
the backwards are the kernels K6/K7 and K8, held against this autograd by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``. Only the map
gets a gradient; the geometry is constant on both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidar_tpu.models import latent_rendering as jlr

from vidar_tpu_torch.models.latent_rendering import ray_geometry
from vidar_tpu_torch.ops import latent_render

H, W, G = 10, 12, 6
# f32 on both sides: the adjoints of bilinear sums and of products along
# <= 7 waypoints, accumulated in another order; 1e-4 of the largest
# gradient
REL_TOL = 1e-4


def _jax_geometry():
    grids = jnp.asarray(jlr._bev_center_grids(H, W))[None]
    radial = grids - 0.5
    rn = jnp.nan_to_num(radial / jnp.sqrt((radial ** 2).sum(-1,
                                                            keepdims=True)))
    steps = (jnp.arange(G, dtype=jnp.float32) + 0.5) * (0.5 / (min(H, W) //
                                                              2))
    return grids, rn, steps


def _jax_vjp(fn, x, g):
    """The vjp of fn at x against g, jitted: one compile, not one per
    operation."""
    return jax.jit(lambda x, g: jax.vjp(fn, x)[1](g)[0])(jnp.asarray(x),
                                                           jnp.asarray(g))


def _check(got, want, what):
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (what, err)


@pytest.mark.parametrize('case', ['sigmoid', 'exp', 'saturated'])
def test_first_hit_grad_matches_jax(case):
    rng = np.random.default_rng(11)
    act = 'exp' if case == 'exp' else 'sigmoid'
    occ = rng.normal(size=(1, H, W, 4)).astype(np.float32)
    if case == 'saturated':
        # whole bins of some cells at logit 40: sigmoid(40) is 1.0 in f32,
        # so those rays' transmittance factors are exactly 0
        occ[0, 3:6, 4:8, :2] = 40.0
        occ[0, 6, :, 2] = 40.0
    g = rng.normal(size=(1, H * W, 4)).astype(np.float32)
    grids, rn, steps = _jax_geometry()
    want = _jax_vjp(lambda o: jlr._first_hit_xla(o, grids, rn, steps, act,
                                                 4096), occ, g)

    t_occ = torch.from_numpy(occ.copy()).requires_grad_()
    out = latent_render.ray_first_hit(t_occ, *ray_geometry(H, W, G, 0.5,
                                                           'cpu'), act)
    (out * torch.from_numpy(g)).sum().backward()
    got = t_occ.grad.numpy()
    assert np.isfinite(got).all()
    _check(got, want, case)


@pytest.mark.parametrize('c_r,z', [(4, 4), (8, 4)], ids=['group1',
                                                         'group2'])
def test_aggregate_grad_matches_jax(c_r, z):
    rng = np.random.default_rng(12)
    fmap = np.concatenate([rng.normal(size=(1, H, W, c_r)),
                           rng.uniform(0, 1, (1, H, W, z))], -1).astype(
                               np.float32)
    g = rng.normal(size=(1, H * W, c_r)).astype(np.float32)
    grids, rn, steps = _jax_geometry()
    want = _jax_vjp(lambda f: jlr._aggregate_xla(f, grids, rn, steps, c_r,
                                                 z, 1e-3, 4096), fmap, g)

    t_map = torch.from_numpy(fmap.copy()).requires_grad_()
    out = latent_render.ray_aggregate(
        t_map, *ray_geometry(H, W, G, 0.5, 'cpu'), c_r, z, 1e-3)
    (out * torch.from_numpy(g)).sum().backward()
    _check(t_map.grad.numpy(), want, f'{c_r},{z}')
