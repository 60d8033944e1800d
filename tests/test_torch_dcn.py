"""The port's plain deformable conv (the CPU side of kernel K2) against the
JAX fused Pallas kernel ``dcn_conv16`` in interpret mode, and the port's
``DeformConv2d`` module against the JAX module's f32 XLA path."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from vidar_tpu.models.resnet import DeformConv2d as JaxDeformConv2d
from vidar_tpu.ops import dcn_pallas

from vidar_tpu_torch.convert import state_dict_from_jax
from vidar_tpu_torch.models.resnet import DeformConv2d
from vidar_tpu_torch.ops import dcn


def _data(b=2, h=6, w=9, c=256, co=128, q=11, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    sx = rng.uniform(-1.5, w + 0.5, (b, q, 9)).astype(np.float32)
    sy = rng.uniform(-1.5, h + 0.5, (b, q, 9)).astype(np.float32)
    mask = rng.uniform(0, 1, (b, q, 9)).astype(np.float32)
    kernel = (rng.standard_normal((9 * c, co)) / np.sqrt(9 * c)).astype(
        np.float32)
    return x, sx, sy, mask, kernel


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def test_plain_matches_dcn_conv16_kernel():
    x, sx, sy, mask, kernel = _data()
    x, kernel = _bf16(x), _bf16(kernel)
    c, co = x.shape[-1], kernel.shape[-1]
    # the JAX kernel emits each tap's channels evens-then-odds and takes the
    # conv kernel permuted to match; the port takes the natural order
    perm = np.asarray(dcn_pallas.dcn16_channel_perm(c))
    kperm = kernel.reshape(9, c, co)[:, perm].reshape(9 * c, co)
    want = np.asarray(dcn_pallas.dcn_conv16(
        jnp.asarray(x), jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(mask),
        jnp.asarray(kperm)))
    got = dcn.dcn_conv(torch.from_numpy(x).to(torch.bfloat16),
                       torch.from_numpy(sx), torch.from_numpy(sy),
                       torch.from_numpy(mask),
                       torch.from_numpy(kernel).to(torch.bfloat16)).numpy()
    # both: the same taps rounded to bf16, exact bf16 products, f32 sums of
    # 9*C = 2304 terms in another order
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_module_matches_jax_xla_path_f32():
    rng = np.random.default_rng(5)
    b, h, w, c, co = 2, 7, 10, 32, 128
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    mod = JaxDeformConv2d(features=co)
    shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0),
                                             jnp.asarray(x)))
    # offsets of a few pixels and non-trivial masks
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.05).astype(np.float32),
        shapes)
    want = np.asarray(mod.apply(params, jnp.asarray(x)))
    port = DeformConv2d(c, co)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    # f32 on both sides; sums in another order
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
