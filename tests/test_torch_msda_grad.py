"""Gradients of the port's deformable attention against ``jax.grad`` of the
JAX package's ``msdeform_attn`` on the CPU (its packed XLA form).

On the CPU the port differentiates its plain version with autograd; on the
card the same function's backward is the kernel K5, which
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py`` hold against
this autograd. Sampling locations lie inside, across and outside the
border, so the validity rule (top-left corner in [-1, h-1] x [-1, w-1])
decides some samples.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidar_tpu.ops import msdeform_attn

from vidar_tpu_torch.ops import msda

LEVELS = {
    '1level': [(12, 20)],
    '4levels': [(12, 20), (6, 10), (3, 5), (2, 3)],
}
# f32 on both sides: the adjoints of the same bilinear sums, accumulated in
# another order; 1e-4 of the largest gradient
REL_TOL = 1e-4


def _inputs(shapes, seed, b=2, heads=2, q=37, p=4, dim=32):
    rng = np.random.default_rng(seed)
    v_len = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, v_len, heads, dim)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (b, q, heads, len(shapes), p, 2))
    # samples whose top-left corner sits exactly on the validity border:
    # x = loc * w - 0.5 at -1 (touches the map), w - 1 (touches) and just
    # beyond (-1 - 1/4 and w - 1/4 + 1: touch nothing)
    for lvl, (h, w) in enumerate(shapes):
        for k, xpix in enumerate((-1.0, w - 1.0, -1.25, w + 0.25)):
            loc[:, k, :, lvl, 0, 0] = (xpix + 0.5) / w
            loc[:, k, :, lvl, 1, 1] = (min(xpix, h - 1.0) + 0.5) / h
    w = rng.uniform(size=(b, q, heads, len(shapes) * p))
    w = (w / w.sum(-1, keepdims=True)).reshape(b, q, heads, len(shapes), p)
    g = rng.standard_normal((b, q, heads * dim))
    return [np.asarray(a, np.float32) for a in (value, loc, w, g)]


@pytest.mark.parametrize('levels', sorted(LEVELS))
def test_grads_match_jax(levels):
    shapes = LEVELS[levels]
    value, loc, w, g = _inputs(shapes, seed=3)

    def jax_obj(v, lo, aw):
        out = msdeform_attn(v, shapes, lo, aw)
        return jnp.sum(out * jnp.asarray(g))

    # jitted: one compile of the whole gradient, not one per operation
    want = jax.jit(jax.grad(jax_obj, argnums=(0, 1, 2)))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(w))

    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (value, loc, w)]
    out = msda.msdeform_attn(leaves[0], shapes, leaves[1], leaves[2])
    (out * torch.from_numpy(g)).sum().backward()

    for name, leaf, ref in zip(('dvalue', 'dloc', 'dweights'), leaves,
                               want):
        ref = np.asarray(ref)
        got = leaf.grad.numpy()
        err = np.abs(got - ref).max()
        assert err <= REL_TOL * np.abs(ref).max(), (name, err)
    # the off-map samples send nothing back
    dloc = leaves[1].grad.numpy()
    assert np.all(dloc[:, 2:4, :, :, 0, 0] == 0)
