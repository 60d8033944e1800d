"""The port's plain ray passes (the CPU side of kernels K3 and K4) against
the JAX Pallas forms in interpret mode (``_first_hit_fused_impl``,
``_aggregate_fused_partials``) and the XLA forms (``_first_hit_xla``,
``_aggregate_xla``), and the whole ``LatentRendering`` module."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidar_tpu.models import latent_rendering as jlr

from vidar_tpu_torch.convert import state_dict_from_jax
from vidar_tpu_torch.models.latent_rendering import (LatentRendering,
                                                     ray_geometry)
from vidar_tpu_torch.ops import latent_render

H, W, G = 10, 12, 6
# f32 on both sides: bilinear sums, products along <= 7 waypoints and a
# normalised sum, each taken in another order
ATOL = 1e-5


def _geometry():
    """JAX's [1, N, 2] geometry and the port's [N, 2] one, built apart."""
    grids = jnp.asarray(jlr._bev_center_grids(H, W))[None]
    radial = grids - 0.5
    rn = jnp.nan_to_num(radial / jnp.sqrt((radial ** 2).sum(-1,
                                                            keepdims=True)))
    steps = (jnp.arange(G, dtype=jnp.float32) + 0.5) * (0.5 / (min(H, W) //
                                                              2))
    return (grids, rn, steps), ray_geometry(H, W, G, 0.5, 'cpu')


def test_port_geometry_equals_jax():
    (grids, rn, steps), (tg, trn, tsteps) = _geometry()
    np.testing.assert_array_equal(tg.numpy(), np.asarray(grids[0]))
    np.testing.assert_array_equal(trn.numpy(), np.asarray(rn[0]))
    np.testing.assert_array_equal(tsteps.numpy(), np.asarray(steps))


@pytest.mark.parametrize('act', ['sigmoid', 'exp'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_first_hit_matches_fused_and_xla(act, dtype):
    rng = np.random.default_rng(3)
    occ = jnp.asarray(rng.normal(size=(1, H, W, 4)).astype(np.float32))
    occ = occ.astype(getattr(jnp, dtype))
    (grids, rn, steps), geo = _geometry()
    fused = np.asarray(jlr._first_hit_fused_impl(occ, grids, rn, steps, act))
    xla = np.asarray(jlr._first_hit_xla(occ, grids, rn, steps, act, 4096))
    got = latent_render.ray_first_hit(
        torch.from_numpy(np.array(occ.astype(jnp.float32))).to(
            getattr(torch, dtype)), *geo, act).numpy()
    np.testing.assert_allclose(got, fused, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, xla, rtol=0, atol=ATOL)


@pytest.mark.parametrize('c_r,z', [(4, 4), (8, 4)], ids=['group1',
                                                         'group2'])
def test_aggregate_matches_fused_and_xla(c_r, z):
    rng = np.random.default_rng(4)
    fused_map = jnp.asarray(
        rng.uniform(0.1, 1.0, (1, H, W, c_r + z)).astype(np.float32))
    (grids, rn, steps), geo = _geometry()
    xla = np.asarray(jlr._aggregate_xla(fused_map, grids, rn, steps, c_r, z,
                                        1e-3, 4096))
    got = latent_render.ray_aggregate(torch.from_numpy(np.array(
        fused_map)), *geo, c_r, z, 1e-3).numpy()
    np.testing.assert_allclose(got, xla, rtol=0, atol=ATOL)
    if c_r == z:
        # the Pallas pass takes group 1 only (latent_rendering.py:477-484)
        num, den = jlr._aggregate_fused_partials(fused_map, grids, rn, steps,
                                                 c_r)
        fused = np.asarray(num / (den + 1e-3))
        np.testing.assert_allclose(got, fused, rtol=0, atol=ATOL)


def test_latent_rendering_module_matches_jax():
    cfg = dict(embed_dims=32, pred_height=4, grid_num=8, grid_step=0.5,
               reduction=8, act='sigmoid')
    rng = np.random.default_rng(5)
    embed = rng.standard_normal((1, H, W, 32)).astype(np.float32)
    mod = jlr.LatentRendering(**cfg)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(embed))
    want = np.asarray(mod.apply(params, jnp.asarray(embed)))
    port = LatentRendering(**cfg)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(embed)).numpy()
    # the per-ray normalisation amplifies f32 rounding where ray sums are
    # small (see tests/models/test_latent_rendering.py)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
