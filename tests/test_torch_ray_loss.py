"""The port's training ray losses against the JAX package's, values and
gradients, on the CPU in f32: ``ray_waypoint_features``, ``ray_ce_loss``
and ``gumbel_softmax_distance`` without noise (vidar_tpu/models/
ray_loss.py:229-315), and ``chamfer_distance_masked``
(vidar_tpu/ops/chamfer.py:87)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidar_tpu.models import ray_loss as jrl
from vidar_tpu.ops.chamfer import chamfer_distance_masked as jax_chamfer

from vidar_tpu_torch.models import ray_loss
from vidar_tpu_torch.ops.chamfer import chamfer_distance_masked

# f32 on both sides: trilinear sums and their adjoints, logsumexp and the
# chamfer's exact recomputation, each in another order; 1e-4 of the
# largest magnitude
REL_TOL = 1e-4
BS, V, Z, H, W, P, G = 2, 3, 4, 10, 12, 300, 24


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= REL_TOL * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.fixture(scope='module')
def rays():
    rng = np.random.default_rng(21)
    sigma = rng.normal(size=(BS, V, Z, H, W)).astype(np.float32)
    origin = np.stack([rng.uniform(2, W - 2, (BS, V)),
                       rng.uniform(2, H - 2, (BS, V)),
                       rng.uniform(1, Z - 1, (BS, V))], -1).astype(np.float32)
    # GT points inside, on and beyond the volume's faces
    gt = np.stack([rng.uniform(-1, W + 1, (BS, P)),
                   rng.uniform(-1, H + 1, (BS, P)),
                   rng.uniform(-0.5, Z + 0.5, (BS, P))], -1).astype(
                       np.float32)
    frame_idx = rng.integers(-1, V + 1, (BS, P)).astype(np.int32)
    weights = rng.uniform(size=(BS, P)).astype(np.float32)
    gcot = rng.normal(size=(BS, P)).astype(np.float32)
    return sigma, origin, gt, frame_idx, weights, gcot


def _torch_rays(sigma, origin, gt, frame_idx, chunk=None):
    s = torch.from_numpy(sigma.copy()).requires_grad_()
    kw = {} if chunk is None else dict(chunk=chunk)
    feats = ray_loss.ray_waypoint_features(
        s, torch.from_numpy(origin), torch.from_numpy(gt),
        torch.from_numpy(frame_idx).long(), G, 0.5, **kw)
    return s, feats


def test_waypoint_features_match_jax(rays):
    sigma, origin, gt, frame_idx, _, _ = rays
    # jitted: one compile of the reference, not one per operation
    want = jax.jit(jrl.ray_waypoint_features, static_argnums=(4, 5))(
        jnp.asarray(sigma), jnp.asarray(origin), jnp.asarray(gt),
        jnp.asarray(frame_idx), G, 0.5)
    _, got = _torch_rays(sigma, origin, gt, frame_idx)
    _close(got.feats.detach(), want.feats, 'feats')
    _close(got.lengths, want.lengths, 'lengths')
    np.testing.assert_array_equal(got.ray_valid.numpy(),
                                  np.asarray(want.ray_valid))
    np.testing.assert_array_equal(got.outside.numpy(),
                                  np.asarray(want.outside))


@pytest.mark.parametrize('loss', ['ce', 'gumbel'])
def test_losses_and_grads_match_jax(rays, loss):
    sigma, origin, gt, frame_idx, weights, gcot = rays

    def jax_loss(sg):
        r = jrl.ray_waypoint_features(sg, jnp.asarray(origin),
                                      jnp.asarray(gt),
                                      jnp.asarray(frame_idx), G, 0.5)
        if loss == 'ce':
            return jrl.ray_ce_loss(r.feats, jnp.asarray(weights))
        d = jrl.gumbel_softmax_distance(r.feats[..., 1:], r.lengths[..., 1:],
                                        None)
        return jnp.sum(d * jnp.asarray(gcot))

    want, want_g = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(sigma))
    # 64-ray chunks: the checkpointed chunk loop is differentiated too
    s, r = _torch_rays(sigma, origin, gt, frame_idx, chunk=64)
    if loss == 'ce':
        got = ray_loss.ray_ce_loss(r.feats, torch.from_numpy(weights))
    else:
        d = ray_loss.gumbel_softmax_distance(r.feats[..., 1:],
                                             r.lengths[..., 1:], None)
        got = (d * torch.from_numpy(gcot)).sum()
    got.backward()
    _close(got.detach(), want, loss)
    _close(s.grad, want_g, f'{loss} grad')


def test_gumbel_noise_draws_in_range():
    feats = torch.zeros(4, 1000, 8)
    lengths = torch.arange(8.0).expand(4, 1000, 8)
    gen = torch.Generator().manual_seed(0)
    d = ray_loss.gumbel_softmax_distance(feats, lengths, gen)
    # equal logits: the hard sample is uniform over the 8 waypoints
    picks = torch.bincount(d.reshape(-1).round().long(), minlength=8)
    assert picks.min() > 400 and picks.max() < 600, picks


@pytest.mark.parametrize('empty_dst', [False, True])
def test_chamfer_matches_jax(empty_dst):
    rng = np.random.default_rng(22)
    src = rng.normal(size=(500, 3)).astype(np.float32) * 3
    dst = rng.normal(size=(700, 3)).astype(np.float32) * 3 + 1
    src_mask = rng.uniform(size=500) < 0.9
    dst_mask = (rng.uniform(size=700) < 0.8) & (not empty_dst)

    def jax_obj(a, b):
        l_src, l_dst, _, _ = jax_chamfer(a, b, jnp.asarray(src_mask),
                                         jnp.asarray(dst_mask), tile=256)
        return l_src + 2.0 * l_dst, (l_src, l_dst)

    (_, (want_s, want_d)), (ga, gb) = jax.jit(jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True))(jnp.asarray(src),
                                                jnp.asarray(dst))
    a = torch.from_numpy(src.copy()).requires_grad_()
    b = torch.from_numpy(dst.copy()).requires_grad_()
    l_src, l_dst, _, _ = chamfer_distance_masked(
        a, b, torch.from_numpy(src_mask), torch.from_numpy(dst_mask),
        tile=256)
    (l_src + 2.0 * l_dst).backward()
    _close(l_src.detach(), want_s, 'loss_src')
    _close(l_dst.detach(), want_d, 'loss_dst')
    if empty_dst:
        assert float(ga.__abs__().max()) == 0.0
        assert float(a.grad.abs().max()) == 0.0
    else:
        _close(a.grad, ga, 'd src')
        _close(b.grad, gb, 'd dst')
