"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Marked ``cuda``: skips where ``torch.cuda.is_available()`` is false.

Both sides get the same CUDA tensors; the plain versions are device-agnostic
PyTorch. Tolerances (each stated at its assert) cover only summation order
and activation rounding: the kernels read the same values and compute the
same products.
"""

import numpy as np
import pytest
import torch

from vidar_tpu_torch.ops import dcn, latent_render, msda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _t(a, dev, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


@pytest.mark.parametrize('case', ['tsa', 'sca', 'sca_f32', 'dim8'])
def test_msda_kernel_matches_plain(dev, case):
    rng = np.random.default_rng(0)
    if case == 'tsa':
        shapes, b, q, heads, dim, p = [(200, 200)], 2, 5000, 8, 32, 4
    elif case == 'dim8':
        shapes, b, q, heads, dim, p = [(16, 16)], 1, 256, 8, 8, 4
    else:
        shapes = [(116, 200), (58, 100), (29, 50), (15, 25)]
        b, q, heads, dim, p = 6, 3000, 8, 32, 8
    v_len = sum(h * w for h, w in shapes)
    dtype = torch.float32 if case == 'sca_f32' else torch.bfloat16
    value = _t(rng.standard_normal((b, v_len, heads, dim)), dev, dtype)
    loc = _t(rng.uniform(-0.1, 1.1, (b, q, heads, len(shapes), p, 2)), dev)
    w = rng.uniform(size=(b, q, heads, len(shapes) * p))
    w = _t((w / w.sum(-1, keepdims=True)).reshape(b, q, heads, len(shapes),
                                                  p), dev)
    before = msda.KERNEL.launches
    got = msda.msda_forward_cuda(value, shapes, loc, w)
    want = msda.msdeform_attn_plain(value, shapes, loc, w)
    torch.cuda.synchronize()
    assert msda.KERNEL.launches == before + 1
    # f32 sums of <= 32 samples x 4 corners in another order
    err = (got - want).abs().max().item()
    assert err <= 1e-5 + 1e-4 * want.abs().max().item(), err


def test_msda_kernel_rejects_bad_input(dev):
    value = torch.zeros(1, 16, 8, 32, device=dev, dtype=torch.float16)
    loc = torch.zeros(1, 4, 8, 1, 4, 2, device=dev)
    w = torch.zeros(1, 4, 8, 1, 4, device=dev)
    with pytest.raises(TypeError):
        msda.msda_forward_cuda(value, [(4, 4)], loc, w)


@pytest.mark.parametrize('c,co', [(256, 256), (512, 512)])
def test_dcn_kernel_matches_plain(dev, c, co):
    rng = np.random.default_rng(1)
    b, h, w = 2, 13, 21
    q = h * w
    x = _t(rng.standard_normal((b, h, w, c)), dev, torch.bfloat16)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    k = np.arange(3) - 1.0
    ky, kx = np.meshgrid(k, k, indexing='ij')
    sy = (gy.reshape(1, q, 1) + ky.reshape(1, 1, 9) +
          rng.normal(0, 1.5, (b, q, 9)))
    sx = (gx.reshape(1, q, 1) + kx.reshape(1, 1, 9) +
          rng.normal(0, 1.5, (b, q, 9)))
    mask = rng.uniform(size=(b, q, 9))
    weight = _t(rng.standard_normal((9 * c, co)) / np.sqrt(9 * c), dev,
                torch.bfloat16)
    sx, sy, mask = _t(sx, dev), _t(sy, dev), _t(mask, dev)
    got = dcn.dcn_conv_cuda(x, sx, sy, mask, weight)
    want = dcn.dcn_conv_plain(x, sx, sy, mask, weight)
    torch.cuda.synchronize()
    # same bf16 taps and exact bf16 products; only the f32 accumulation
    # order over 9*C terms differs
    err = (got - want).abs().max().item()
    assert err <= 1e-3 * want.abs().max().item(), err


def _geometry(h, w, g, dev):
    from vidar_tpu_torch.models.latent_rendering import ray_geometry
    return ray_geometry(h, w, g, 0.5, dev)


@pytest.mark.parametrize('act', ['sigmoid', 'exp'])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_first_hit_kernel_matches_plain(dev, act, dtype):
    rng = np.random.default_rng(2)
    h = w = 60
    occ = _t(rng.standard_normal((1, h, w, 16)), dev, dtype)
    grids, rn, steps = _geometry(h, w, 77, dev)
    got = latent_render.ray_first_hit_cuda(occ, grids, rn, steps, act)
    want = latent_render.ray_first_hit_plain(occ, grids, rn, steps, act)
    torch.cuda.synchronize()
    # outputs in [0, 1]; a product of <= 78 factors in another order plus
    # the activation's last-bit rounding
    err = (got - want).abs().max().item()
    assert err <= 1e-4, err


@pytest.mark.parametrize('c_r,z', [(16, 16), (8, 4)])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_aggregate_kernel_matches_plain(dev, c_r, z, dtype):
    rng = np.random.default_rng(3)
    h = w = 60
    fmap = _t(np.concatenate([rng.standard_normal((1, h, w, c_r)),
                              rng.uniform(0, 1, (1, h, w, z))], -1), dev,
              dtype)
    grids, rn, steps = _geometry(h, w, 64, dev)
    got = latent_render.ray_aggregate_cuda(fmap, grids, rn, steps, c_r, z,
                                           1e-3)
    want = latent_render.ray_aggregate_plain(fmap, grids, rn, steps, c_r, z,
                                             1e-3)
    torch.cuda.synchronize()
    # two f32 sums over <= 64 waypoints in another order, then a division
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * max(1.0, want.abs().max().item()), err
