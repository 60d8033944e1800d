"""The port's deformable-conv backward (``dcn_conv_backward``, the same
chunked PyTorch on the CPU and on the card) against the JAX package's
``_dcn_conv16_vbwd`` (vidar_tpu/ops/dcn_pallas.py:743-842) called with the
same residuals, on the CPU.

The JAX kernel takes its weight with each tap's channels in the
evens-then-odds order of ``dcn16_channel_perm``; the port's K2 takes the
natural (ky, kx, cin) rows, so the two weight gradients are compared
through that permutation. x and the weight are bf16 on both sides, as in
the model, so ``d weight`` comes from the bf16-rounded taps on both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidar_tpu.ops.dcn_pallas import _dcn_conv16_vbwd, dcn16_channel_perm

from vidar_tpu_torch.ops import dcn

# dx and d weight come out in bf16 on both sides, each the rounding of an
# f32 sum taken in another order: one bf16 ulp (2^-8) of the element, so
# 1e-2 of the largest; dsx, dsy and d mask stay f32: 1e-4 of the largest
BF16_TOL = 1e-2
F32_TOL = 1e-4


def _inputs(seed, b=2, h=5, w=7, c=8, co=16):
    rng = np.random.default_rng(seed)
    q = h * w
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    k = np.arange(3) - 1.0
    ky, kx = np.meshgrid(k, k, indexing='ij')
    # offsets of up to 2.5 pixels: many taps fall partly or wholly off
    sy = (gy.reshape(1, q, 1) + ky.reshape(1, 1, 9) +
          rng.uniform(-2.5, 2.5, (b, q, 9)))
    sx = (gx.reshape(1, q, 1) + kx.reshape(1, 1, 9) +
          rng.uniform(-2.5, 2.5, (b, q, 9)))
    mask = rng.uniform(size=(b, q, 9))
    weight = rng.standard_normal((9 * c, co)) / np.sqrt(9 * c)
    g = rng.standard_normal((b, q, co))
    return [np.asarray(a, np.float32) for a in (x, sx, sy, mask, weight, g)]


# one compile for both chunk sizes' (identical) JAX references
_JAX_BACKWARD = jax.jit(_dcn_conv16_vbwd)


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err)


@pytest.mark.parametrize('chunk', [2048, 16])
def test_backward_matches_jax(chunk):
    x, sx, sy, mask, weight, g = _inputs(seed=7)
    c = x.shape[-1]
    perm = np.asarray(dcn16_channel_perm(c))
    kperm = weight.reshape(9, c, -1)[:, perm].reshape(9 * c, -1)
    res = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(sx), jnp.asarray(sy),
           jnp.asarray(mask), jnp.asarray(kperm, jnp.bfloat16))
    jdx, jdsx, jdsy, jdmask, jdkp = _JAX_BACKWARD(res, jnp.asarray(g))

    t = lambda a: torch.from_numpy(a.copy())
    dx, dsx, dsy, dmask, dw = dcn.dcn_conv_backward(
        t(x).to(torch.bfloat16), t(sx), t(sy), t(mask),
        t(weight).to(torch.bfloat16), t(g), chunk=chunk)
    assert dx.dtype == dw.dtype == torch.bfloat16
    _close(dx.float(), np.asarray(jdx, np.float32), BF16_TOL, 'dx')
    _close(dsx, jdsx, F32_TOL, 'dsx')
    _close(dsy, jdsy, F32_TOL, 'dsy')
    _close(dmask, jdmask, F32_TOL, 'dmask')
    dw_perm = dw.float().reshape(9, c, -1)[:, perm].reshape(9 * c, -1)
    _close(dw_perm, np.asarray(jdkp, np.float32), BF16_TOL, 'dweight')


def test_autograd_runs_the_backward():
    """``dcn_conv`` on CPU tensors: the plain forward, and autograd reaches
    ``dcn_conv_backward``."""
    x, sx, sy, mask, weight, g = _inputs(seed=8, b=1)
    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (x, sx, sy, mask, weight)]
    out = dcn.dcn_conv(*leaves)
    want = dcn.dcn_conv_plain(*[v.detach() for v in leaves])
    torch.testing.assert_close(out.detach(), want, rtol=0, atol=0)
    (out * torch.from_numpy(g)).sum().backward()
    direct = dcn.dcn_conv_backward(*[v.detach() for v in leaves],
                                   torch.from_numpy(g))
    for leaf, ref in zip(leaves, direct):
        torch.testing.assert_close(leaf.grad, ref, rtol=0, atol=0)
