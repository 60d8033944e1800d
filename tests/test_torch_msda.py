"""The port's plain deformable attention (the CPU side of kernel K1)
against the JAX Pallas kernels, run in interpret mode on the CPU:
``msda_gather_fused`` through ``msdeform_attn(impl='fused')`` and
``msda_gather_fused16`` over a ``pack_atlas16`` table."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidar_tpu.ops import msda as jax_msda
from vidar_tpu.ops import msda_pallas, msdeform_attn
from vidar_tpu.ops.msda_pallas import msda_gather_fused16, pack_atlas16

from vidar_tpu_torch.ops import msda

LEVELS = {
    '1level': [(12, 20)],
    '4levels': [(12, 20), (6, 10), (3, 5), (2, 3)],
}
# f32 sums of <= 32 samples x 4 corners, taken in another order
ATOL = 1e-4
# The kernels' query tile. In interpret mode each tile's row gathers are
# unrolled into the trace (qt x samples of them), so a small tile keeps the
# compile short; every query is computed alone, so the function is the same
# for any tile.
QT = 8


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
    kernel = msda_pallas.msda_gather_fused
    monkeypatch.setattr(msda_pallas, 'msda_gather_fused',
                        lambda *a, **kw: kernel(*a, **kw, qt=QT))
    # under jax.jit: one compile, not one per operation
    want = np.asarray(jax.jit(
        lambda v, lo, aw: msdeform_attn(v, shapes, lo, aw, impl='fused'))(
            jnp.asarray(value), jnp.asarray(loc), jnp.asarray(w)))
    assert calls, 'the fused kernel was bypassed'
    got = _port(value, shapes, loc, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _fused16(v16, shapes, loc, w):
    """``_msda_fused_fwd_impl``'s whole-level path with the row-pair u32
    tables, run through ``msda_gather_fused16`` in interpret mode, under
    jax.jit (one compile, not one per operation)."""
    b, q, heads = loc.shape[:3]

    @jax.jit
    def run(v16, loc, w):
        levels = jax_msda._split_levels(v16, shapes)
        cache = jax_msda._packed_cache(levels, shapes,
                                       set(range(len(shapes))),
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
                tables, table_rows, shapes, loc, w, entries, 256)
            part = msda_gather_fused16(atlas, row_idx, wx1, wy1, aw,
                                       q_block=256, interpret=True, qt=QT)
            out = part if out is None else out + part
        dim = out.shape[1]
        return out[:, :, :q].reshape(b, heads, dim, q).transpose(
            0, 3, 1, 2).reshape(b, q, heads * dim)

    return np.asarray(run(v16, jnp.asarray(loc), jnp.asarray(w)))


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


@pytest.mark.parametrize('dim', [4, 64])
def test_plain_matches_xla_small_head_dim(dim):
    """Head dims other than 32 against the XLA path: 4 (the small configs)
    and 64 (a width K1 and K5 take on the card)."""
    shapes = LEVELS['4levels']
    value, loc, w = _inputs(shapes, seed=3, dim=dim)
    want = np.asarray(jax.jit(
        lambda v, lo, aw: msdeform_attn(v, shapes, lo, aw, impl='plain'))(
            jnp.asarray(value), jnp.asarray(loc), jnp.asarray(w)))
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
