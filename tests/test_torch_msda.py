"""The port's plain deformable attention (the CPU side of kernel K1)
against the JAX Pallas kernels, run in interpret mode on the CPU:
``msda_gather_fused`` through ``msdeform_attn(impl='fused')`` and
``msda_gather_fused16`` over a ``pack_atlas16`` table."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vidar_tpu.ops import msda as jax_msda
from vidar_tpu.ops import msdeform_attn
from vidar_tpu.ops.msda_pallas import msda_gather_fused16, pack_atlas16

from vidar_tpu_torch.ops import msda

LEVELS = {
    '1level': [(12, 20)],
    '4levels': [(12, 20), (6, 10), (3, 5), (2, 3)],
}
# f32 sums of <= 32 samples x 4 corners, taken in another order
ATOL = 1e-4


def _inputs(shapes, seed, b=2, heads=2, q=37, p=4, dim=32):
    rng = np.random.default_rng(seed)
    v_len = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, v_len, heads, dim)).astype(np.float32)
    # includes locations off the map: their corners must weigh nothing
    loc = rng.uniform(-0.2, 1.2, (b, q, heads, len(shapes), p, 2)).astype(
        np.float32)
    w = rng.uniform(size=(b, q, heads, len(shapes) * p)).astype(np.float32)
    w = (w / w.sum(-1, keepdims=True)).reshape(b, q, heads, len(shapes), p)
    return value, loc, w


def _port(value, shapes, loc, w, dtype=torch.float32):
    return msda.msdeform_attn(torch.from_numpy(value).to(dtype), shapes,
                              torch.from_numpy(loc),
                              torch.from_numpy(w)).numpy()


@pytest.mark.parametrize('levels', sorted(LEVELS))
def test_plain_matches_fused_kernel_f32(levels, monkeypatch):
    shapes = LEVELS[levels]
    value, loc, w = _inputs(shapes, seed=1)
    calls = []
    real = jax_msda._msda_fused
    monkeypatch.setattr(jax_msda, '_msda_fused',
                        lambda *a: calls.append(1) or real(*a))
    want = np.asarray(msdeform_attn(jnp.asarray(value), shapes,
                                    jnp.asarray(loc), jnp.asarray(w),
                                    impl='fused'))
    assert calls, 'the fused kernel was bypassed'
    got = _port(value, shapes, loc, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _fused16(v16, shapes, loc, w):
    """``_msda_fused_fwd_impl``'s whole-level path with the row-pair u32
    tables, run through ``msda_gather_fused16`` in interpret mode."""
    b, q, heads = loc.shape[:3]
    levels = jax_msda._split_levels(v16, shapes)
    cache = jax_msda._packed_cache(levels, shapes, set(range(len(shapes))),
                                   dtype=jnp.bfloat16)
    tables, table_rows = {}, {}
    for lvl, (h, wd) in enumerate(shapes):
        pk = cache[lvl].reshape(b * heads, (h + 1) * (wd + 1), -1)
        pk = jnp.pad(pk, ((0, 0), (0, (-pk.shape[1]) % 8), (0, 0)))
        tables[lvl] = pack_atlas16(pk)
        table_rows[lvl] = 2 * tables[lvl].shape[1]
    out = None
    for entries in jax_msda._fused_plan(shapes, packed16=True):
        atlas, row_idx, wx1, wy1, aw = jax_msda._prep_group_fwd(
            tables, table_rows, shapes, jnp.asarray(loc), jnp.asarray(w),
            entries, 256)
        part = msda_gather_fused16(atlas, row_idx, wx1, wy1, aw,
                                   q_block=256, interpret=True)
        out = part if out is None else out + part
    dim = out.shape[1]
    return np.asarray(out[:, :, :q].reshape(b, heads, dim, q).transpose(
        0, 3, 1, 2).reshape(b, q, heads * dim))


@pytest.mark.parametrize('levels', sorted(LEVELS))
def test_plain_matches_fused16_kernel_bf16(levels):
    shapes = LEVELS[levels]
    value, loc, w = _inputs(shapes, seed=2)
    v16 = jnp.asarray(value).astype(jnp.bfloat16)
    want = _fused16(v16, shapes, loc, w)
    # both sides read the same bf16 values and sum in f32
    got = _port(np.array(v16.astype(jnp.float32)), shapes, loc, w,
                dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_plain_matches_xla_small_head_dim():
    """Head dims below 32 (the small configs) against the XLA path."""
    shapes = LEVELS['4levels']
    value, loc, w = _inputs(shapes, seed=3, dim=4)
    want = np.asarray(msdeform_attn(jnp.asarray(value), shapes,
                                    jnp.asarray(loc), jnp.asarray(w),
                                    impl='plain'))
    got = _port(value, shapes, loc, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_query_chunks_agree():
    shapes = LEVELS['1level']
    value, loc, w = _inputs(shapes, seed=4, q=50)
    args = (torch.from_numpy(value), shapes, torch.from_numpy(loc),
            torch.from_numpy(w))
    whole = msda.msdeform_attn_plain(*args)
    chunked = msda.msdeform_attn_plain(*args, query_chunk=16)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
