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


@pytest.mark.parametrize('c', [256, 512])
def test_dcn_sample_kernel_matches_plain(dev, c):
    rng = np.random.default_rng(8)
    b, h, w = 2, 13, 21
    q = h * w
    x = _t(rng.standard_normal((b, h, w, c)), dev)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    k = np.arange(3) - 1.0
    ky, kx = np.meshgrid(k, k, indexing='ij')
    sy = (gy.reshape(1, q, 1) + ky.reshape(1, 1, 9) +
          rng.normal(0, 1.5, (b, q, 9)))
    sx = (gx.reshape(1, q, 1) + kx.reshape(1, 1, 9) +
          rng.normal(0, 1.5, (b, q, 9)))
    # the zero ring and beyond: one corner on the map and one off, exact
    # edges, samples wholly off the map
    sx[0, 0] = [-1.0, -0.5, -0.25, 0.0, w - 1.0, w - 0.75, w - 0.5, w, -3.0]
    sy[0, 0] = [0.5, h - 0.5, -0.5, h - 1.0, -1.0, 2.0, h + 0.25, 1.0, -2.0]
    mask = _t(rng.uniform(size=(b, q, 9)), dev)
    sx, sy = _t(sx, dev), _t(sy, dev)
    before = dcn.SAMPLE.launches
    got = dcn.dcn_sample_cuda(x, sx, sy, mask)
    want = dcn.dcn_sample_plain(x, sx, sy, mask)
    torch.cuda.synchronize()
    assert dcn.SAMPLE.launches == before + 1
    # the plain version's products and sum order, without FMAs
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
    assert not bool(got[0, 0, 8].any())


def test_dcn_sample_kernel_rejects_misaligned_x(dev):
    """K9 reads x as float4: a contiguous view that starts off a 16-byte
    boundary is refused before the launch, with no sticky CUDA error."""
    x = torch.randn(1 * 3 * 4 * 8 + 1, device=dev)[1:].view(1, 3, 4, 8)
    sx = torch.rand(1, 12, 9, device=dev) * 3
    sy, mask = sx.clone(), torch.ones_like(sx)
    assert x.is_contiguous() and x.data_ptr() % 16
    before = dcn.SAMPLE.launches
    with pytest.raises(ValueError, match='16-byte'):
        dcn.dcn_sample_cuda(x, sx, sy, mask)
    assert dcn.SAMPLE.launches == before
    torch.cuda.synchronize()
    want = dcn.dcn_sample_plain(x, sx, sy, mask)
    got = dcn.dcn_sample_cuda(x.clone(), sx, sy, mask)
    torch.cuda.synchronize()
    assert dcn.SAMPLE.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_f32_deform_conv_launches_dcn_sample(dev):
    """An f32 DeformConv2d on CUDA tensors runs K9 (and no K2); a bf16 one
    runs K2."""
    from vidar_tpu_torch.models.resnet import DeformConv2d
    torch.manual_seed(0)
    mod = DeformConv2d(256, 256, device=dev)
    for p in mod.parameters():
        torch.nn.init.normal_(p, std=0.02)
    x = torch.randn(1, 256, 9, 11, device=dev).contiguous(
        memory_format=torch.channels_last)
    counts = (dcn.SAMPLE.launches, dcn.KERNEL.launches)
    with torch.inference_mode():
        out = mod(x)
        mod(x.to(torch.bfloat16))
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert (dcn.SAMPLE.launches, dcn.KERNEL.launches) == (counts[0] + 1,
                                                          counts[1] + 1)


def _dcn_taps(rng, b, h, w, dev):
    """Tap coordinates around each pixel with offsets of ~1.5 px, the zero
    ring and beyond written into the first pixel's taps, and masks."""
    q = h * w
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    k = np.arange(3) - 1.0
    ky, kx = np.meshgrid(k, k, indexing='ij')
    sy = (gy.reshape(1, q, 1) + ky.reshape(1, 1, 9) +
          rng.normal(0, 1.5, (b, q, 9)))
    sx = (gx.reshape(1, q, 1) + kx.reshape(1, 1, 9) +
          rng.normal(0, 1.5, (b, q, 9)))
    sx[0, 0] = [-1.0, -0.5, -0.25, 0.0, w - 1.0, w - 0.75, w - 0.5, w, -3.0]
    sy[0, 0] = [0.5, h - 0.5, -0.5, h - 1.0, -1.0, 2.0, h + 0.25, 1.0, -2.0]
    return (_t(sx, dev), _t(sy, dev),
            _t(rng.uniform(size=(b, q, 9)), dev))


@pytest.mark.parametrize('c', [64, 256, 20])
def test_dcn_sample16_kernel_matches_plain(dev, c):
    """K10 against its plain version, bit for bit: C = 64 and 256 take the
    16-byte path, C = 20 and an x off a 16-byte boundary the scalar one."""
    rng = np.random.default_rng(9)
    b, h, w = 2, 13, 21
    x = _t(rng.standard_normal((b, h, w, c)), dev, torch.bfloat16)
    sx, sy, mask = _dcn_taps(rng, b, h, w, dev)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
    shifted = shifted.view(x.shape).copy_(x)
    assert shifted.data_ptr() % 16
    before = dcn.SAMPLE16.launches
    want = dcn.dcn_sample16_plain(x, sx, sy, mask)
    for xi in (x, shifted):
        got = dcn.dcn_sample16_cuda(xi, sx, sy, mask)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == (b, h * w, 9 * c)
        # K2's tap arithmetic without FMAs and one round to nearest even:
        # equal (but for a sign of zero)
        assert torch.equal(got, want)
        assert not bool(got[0, 0, 8 * c:].any())
    assert dcn.SAMPLE16.launches == before + 2


def test_dcn_sample16_kernel_rejects_bad_input(dev):
    x = torch.randn(1, 5, 6, 64, device=dev, dtype=torch.bfloat16)
    sx = torch.rand(1, 30, 9, device=dev) * 5
    sy, mask = sx.clone(), torch.ones_like(sx)
    before = dcn.SAMPLE16.launches
    with pytest.raises(TypeError):
        dcn.dcn_sample16_cuda(x.float(), sx, sy, mask)
    with pytest.raises(TypeError):
        dcn.dcn_sample16_cuda(x, sx.double(), sy, mask)
    with pytest.raises(ValueError, match='contiguous'):
        dcn.dcn_sample16_cuda(x.transpose(1, 2), sx[:, :30], sy, mask)
    sx_t = (torch.rand(1, 9, 30, device=dev) * 5).transpose(1, 2)
    with pytest.raises(ValueError, match='contiguous'):
        dcn.dcn_sample16_cuda(x, sx_t, sy, mask)
    with pytest.raises(ValueError):
        dcn.dcn_sample16_cuda(x, sx[..., :8], sy, mask)
    assert dcn.SAMPLE16.launches == before


@pytest.mark.parametrize('c,co,route', [(64, 64, 'K10'), (128, 128, 'K2'),
                                        (256, 64, 'K10')])
def test_bf16_deform_conv_routes(dev, c, co, route):
    """A bf16 DeformConv2d runs K2 where it takes the shape (C % 32 == 0 and
    CO % 128 == 0), else K10 and a bf16 product; its output and its input
    gradient agree with the same module on the CPU."""
    from vidar_tpu_torch.models.resnet import DeformConv2d
    torch.manual_seed(0)
    mod = DeformConv2d(c, co, dtype=torch.bfloat16, device=dev)
    # the offsets from the offset conv's bias alone (its kernel zero, as it
    # is initialised): the same bf16 offsets on both devices, whose bf16
    # convolutions round differently (tests/test_torch_dcn_sample16.py)
    torch.nn.init.zeros_(mod.conv_offset.weight)
    torch.nn.init.normal_(mod.conv_offset.bias, std=1.5)
    torch.nn.init.normal_(mod.kernel, std=1 / (9 * c) ** 0.5)
    x = torch.randn(2, c, 9, 11, device=dev, dtype=torch.bfloat16
                    ).contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    counts = (dcn.SAMPLE16.launches, dcn.KERNEL.launches)
    out = mod(x)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    want = (counts[0] + 1, counts[1]) if route == 'K10' else (counts[0],
                                                              counts[1] + 1)
    assert (dcn.SAMPLE16.launches, dcn.KERNEL.launches) == want
    assert out.dtype == torch.bfloat16 and out.shape == (2, co, 9, 11)
    assert bool(torch.isfinite(out).all()) and x.grad is not None
    cpu = DeformConv2d(c, co, dtype=torch.bfloat16, device='cpu')
    cpu.load_state_dict({k: v.cpu() for k, v in mod.state_dict().items()})
    xc = x.detach().cpu().requires_grad_()
    ref = cpu(xc)
    ref.float().square().sum().backward()
    # the same bf16 taps on both devices; the product's f32 sums in another
    # order (cuBLAS vs the CPU) before the rounding to bf16: within 2e-2, as
    # the CPU tests hold the port to JAX
    torch.testing.assert_close(out.detach().cpu().float(), ref.float(),
                               atol=2e-2, rtol=2e-2)
    cos = torch.nn.functional.cosine_similarity(
        x.grad.cpu().float().reshape(-1), xc.grad.float().reshape(-1), 0)
    assert cos.item() > 0.99, cos.item()


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


def _plain_grads(fn, inputs, g):
    """Autograd of a plain version in f32 (a bf16 input is upcast: the same
    values, the gradient summed in f32): the gradient of <fn(*inputs), g>
    against every input."""
    leaves = [x.detach().float().requires_grad_() for x in inputs]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, [x for x in leaves if x.requires_grad],
                                g)
    return list(grads)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize('case', ['tsa', 'sca', 'sca_f32'])
def test_msda_backward_kernel_matches_plain(dev, case):
    rng = np.random.default_rng(4)
    if case == 'tsa':
        shapes, b, q, heads, dim, p = [(50, 50)], 2, 2500, 8, 32, 4
    else:
        shapes = [(29, 50), (15, 25), (8, 13), (4, 7)]
        b, q, heads, dim, p = 6, 600, 8, 32, 8
    v_len = sum(h * w for h, w in shapes)
    dtype = torch.bfloat16 if case != 'sca_f32' else torch.float32
    value = _t(rng.standard_normal((b, v_len, heads, dim)), dev, dtype)
    # locations on and off the border: the validity rule is exercised
    loc = _t(rng.uniform(-0.1, 1.1, (b, q, heads, len(shapes), p, 2)), dev)
    w = _t(rng.uniform(size=(b, q, heads, len(shapes), p)), dev)
    g = _t(rng.standard_normal((b, q, heads * dim)), dev)
    before = msda.BACKWARD.launches
    dv, dl, dw = msda.msda_backward_cuda(value, shapes, loc, w, g)
    want = _plain_grads(
        lambda v, lo, aw: msda.msdeform_attn_plain(v, shapes, lo, aw),
        (value, loc, w), g)
    torch.cuda.synchronize()
    assert msda.BACKWARD.launches == before + 1
    assert dv.dtype == value.dtype
    # f32 atomic sums in another order; the kernel rounds dvalue of a bf16
    # value to bf16 (2^-9 relative)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert _rel_err(dv, want[0]) <= tol
    assert _rel_err(dl, want[1]) <= 1e-4
    assert _rel_err(dw, want[2]) <= 1e-4


@pytest.mark.parametrize('act', ['sigmoid', 'exp'])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_first_hit_backward_kernel_matches_plain(dev, act, dtype):
    rng = np.random.default_rng(5)
    h = w = 60
    occ = _t(2.0 * rng.standard_normal((1, h, w, 16)), dev, dtype)
    grids, rn, steps = _geometry(h, w, 77, dev)
    g = _t(rng.standard_normal((1, h * w, 16)), dev)
    before = latent_render.FIRST_HIT_BACKWARD.launches
    got = latent_render.ray_first_hit_backward_cuda(occ, grids, rn, steps,
                                                    act, g)
    (want,) = _plain_grads(
        lambda o: latent_render.ray_first_hit_plain(o, grids, rn, steps,
                                                    act), (occ,), g)
    torch.cuda.synchronize()
    assert latent_render.FIRST_HIT_BACKWARD.launches == before + 1
    # f32 atomic sums over the rays crossing a cell in another order
    # (bf16: the kernel rounds the gradient to bf16, 2^-9 relative)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert _rel_err(got, want) <= tol


@pytest.mark.parametrize('c_r,z', [(16, 16), (8, 4)])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_aggregate_backward_kernel_matches_plain(dev, c_r, z, dtype):
    rng = np.random.default_rng(6)
    h = w = 60
    fmap = _t(np.concatenate([rng.standard_normal((1, h, w, c_r)),
                              rng.uniform(0, 1, (1, h, w, z))], -1), dev,
              dtype)
    grids, rn, steps = _geometry(h, w, 64, dev)
    g = _t(rng.standard_normal((1, h * w, c_r)), dev)
    before = latent_render.AGGREGATE_BACKWARD.launches
    got = latent_render.ray_aggregate_backward_cuda(fmap, grids, rn, steps,
                                                    c_r, z, 1e-3, g)
    (want,) = _plain_grads(
        lambda f: latent_render.ray_aggregate_plain(f, grids, rn, steps, c_r,
                                                    z, 1e-3), (fmap,), g)
    torch.cuda.synchronize()
    assert latent_render.AGGREGATE_BACKWARD.launches == before + 1
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert _rel_err(got, want) <= tol


def test_train_path_uses_the_backward_kernels(dev):
    """One autograd pass through each wrapper on the card launches its
    backward kernel."""
    rng = np.random.default_rng(7)
    value = _t(rng.standard_normal((1, 64, 8, 32)), dev).requires_grad_()
    loc = _t(rng.uniform(size=(1, 16, 8, 1, 4, 2)), dev).requires_grad_()
    w = _t(rng.uniform(size=(1, 16, 8, 1, 4)), dev).requires_grad_()
    before = msda.BACKWARD.launches
    msda.msdeform_attn(value, [(8, 8)], loc, w).sum().backward()
    assert msda.BACKWARD.launches == before + 1
    assert value.grad is not None and loc.grad is not None
    grids, rn, steps = _geometry(16, 16, 8, dev)
    occ = _t(rng.standard_normal((1, 16, 16, 4)), dev).requires_grad_()
    before = latent_render.FIRST_HIT_BACKWARD.launches
    latent_render.ray_first_hit(occ, grids, rn, steps,
                                'sigmoid').sum().backward()
    assert latent_render.FIRST_HIT_BACKWARD.launches == before + 1
    fmap = _t(rng.uniform(size=(1, 16, 16, 8)), dev).requires_grad_()
    before = latent_render.AGGREGATE_BACKWARD.launches
    latent_render.ray_aggregate(fmap, grids, rn, steps, 4, 4,
                                1e-3).sum().backward()
    assert latent_render.AGGREGATE_BACKWARD.launches == before + 1
    assert occ.grad.abs().sum() > 0 and fmap.grad.abs().sum() > 0
