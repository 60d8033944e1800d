"""The port's f32 deformable-conv taps (``dcn_sample``, the CPU side of
kernel K9) against the JAX package's ``dcn_sample``: its Pallas kernel
``dcn_gather`` in interpret mode and its XLA reference ``_dcn_sample_ref``;
the gradient against ``jax.vjp`` of that reference (what the JAX backward
takes); and the f32 ``DeformConv2d`` against the JAX module."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidar_tpu.models.resnet import DeformConv2d as JaxDeformConv2d
from vidar_tpu.ops import dcn_pallas

from vidar_tpu_torch.convert import state_dict_from_jax
from vidar_tpu_torch.models import resnet
from vidar_tpu_torch.ops import dcn

# taps: four f32 products summed in another order, then the mask; 1e-5 of
# the largest tap
REL_TOL = 1e-5
# gradients: f32 sums over channels and over the taps that share a pixel,
# in another order; 1e-4 of the largest, as tests/test_torch_dcn_grad.py
GRAD_TOL = 1e-4


def _inputs(b=2, h=6, w=9, c=256, q=13, seed=0):
    """Coordinates over and around the map, with the edge cases written in:
    exact pixel centres, the zero ring (one corner on the map, one off),
    and samples wholly off the map."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    sx = rng.uniform(-1.5, w + 0.5, (b, q, 9))
    sy = rng.uniform(-1.5, h + 0.5, (b, q, 9))
    edges_x = np.array([-1.0, -0.5, -0.25, 0.0, w - 1.0, w - 0.75, w - 0.5,
                        w + 0.0, -3.0])
    edges_y = np.array([0.5, h - 0.5, -0.5, h - 1.0, -1.0, 2.0, h + 0.25,
                        1.0, -2.0])
    sx[0, 0], sy[0, 0] = edges_x, edges_y
    sx[1, 1], sy[1, 1] = edges_y * w / h, edges_x * h / w
    mask = rng.uniform(0, 1, (b, q, 9))
    return [np.asarray(a, np.float32) for a in (x, sx, sy, mask)]


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def test_plain_matches_pallas_and_reference():
    x, sx, sy, mask = _inputs()
    jargs = [jnp.asarray(a) for a in (x, sx, sy, mask)]
    # on the CPU the JAX dcn_sample runs dcn_gather in interpret mode; under
    # jax.jit each is one compile, not one per operation
    kernel = np.asarray(jax.jit(dcn_pallas.dcn_sample)(*jargs))
    ref = np.asarray(jax.jit(dcn_pallas._dcn_sample_ref)(*jargs))
    got = dcn.dcn_sample_plain(*[torch.from_numpy(a) for a in
                                 (x, sx, sy, mask)]).numpy()
    _close(got, kernel, REL_TOL, 'taps vs dcn_gather')
    _close(got, ref, REL_TOL, 'taps vs _dcn_sample_ref')
    # a sample wholly off the map is an exact zero
    assert not np.any(got[0, 0, 8]) and not np.any(got[1, 1, 8])


@pytest.mark.parametrize('chunk', [2048, 5])
def test_grads_match_jax_vjp(chunk):
    x, sx, sy, mask = _inputs(c=32, seed=1)
    g = np.random.default_rng(2).standard_normal(
        sx.shape + (x.shape[-1],)).astype(np.float32)
    want = jax.jit(lambda g, *a: jax.vjp(dcn_pallas._dcn_sample_ref, *a)[1](
        g))(*[jnp.asarray(a) for a in (g, x, sx, sy, mask)])
    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (x, sx, sy, mask)]
    out = dcn.dcn_sample(*leaves)
    (out * torch.from_numpy(g)).sum().backward()
    direct = dcn.dcn_sample_backward(*[v.detach() for v in leaves],
                                     torch.from_numpy(g), chunk=chunk)
    for name, leaf, d, w in zip(('dx', 'dsx', 'dsy', 'dmask'), leaves,
                                direct, want):
        _close(leaf.grad, w, GRAD_TOL, name)
        _close(d, w, GRAD_TOL, f'{name}, chunk {chunk}')


def test_module_f32_matches_jax_and_dispatches_on_dtype(monkeypatch):
    rng = np.random.default_rng(3)
    b, h, w, c, co = 1, 6, 8, 256, 128
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    mod = JaxDeformConv2d(features=co)
    shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0),
                                             jnp.asarray(x)))
    # offsets of several pixels: taps leave the map and cross the ring
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
        shapes)
    want = np.asarray(jax.jit(mod.apply)(params, jnp.asarray(x)))
    port = resnet.DeformConv2d(c, co)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    calls = []
    for name in ('dcn_sample', 'dcn_conv'):
        real = getattr(resnet, name)
        monkeypatch.setattr(resnet, name, lambda *a, _n=name, _r=real:
                            calls.append(_n) or _r(*a))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = port(xt).permute(0, 2, 3, 1).numpy()
        port(xt.to(torch.bfloat16))
        with pytest.raises(TypeError, match='float16'):
            port(xt.half())
    assert calls == ['dcn_sample', 'dcn_conv']
    # f32 on both sides: the taps as above, then a product over 9*C
    _close(got, want, 1e-4, 'f32 DeformConv2d')
