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


@pytest.mark.parametrize('case', ['tsa', 'sca'])
@pytest.mark.parametrize('dim', [8, 16, 32, 20])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_msda_kernel_paths_match_plain(dev, case, dim, dtype):
    """K1's vector path (dims 8, 16, 32: rows of 1, 2 or 4 16-byte chunks in
    bf16, 2, 4 or 8 in f32) and its scalar path (dim 20, and a value off a
    16-byte boundary) against the plain version: P = 4 on one level (TSA)
    and P = 8 on four levels (SCA), a Q that leaves the last block ragged,
    and samples off the map on every level."""
    rng = np.random.default_rng(10)
    if case == 'tsa':
        shapes, b, q, heads, p = [(40, 50)], 2, 1001, 8, 4
    else:
        shapes, b, q, heads, p = [(29, 50), (15, 25), (8, 13), (4, 7)], 3, \
            777, 8, 8
    v_len = sum(h * w for h, w in shapes)
    value = _t(rng.standard_normal((b, v_len, heads, dim)), dev, dtype)
    # samples off the map on every level: every 7th query's wholly (x =
    # -3), and about half of the rest in part
    loc = rng.uniform(-0.2, 1.2, (b, q, heads, len(shapes), p, 2))
    loc[:, ::7, ..., 0] = -3.0
    loc = _t(loc, dev)
    w = rng.uniform(size=(b, q, heads, len(shapes) * p))
    w = _t((w / w.sum(-1, keepdims=True)).reshape(b, q, heads, len(shapes),
                                                  p), dev)
    shifted = torch.empty(value.numel() + 1, dtype=dtype, device=dev)[1:]
    shifted = shifted.view(value.shape).copy_(value)
    assert shifted.data_ptr() % 16
    want = msda.msdeform_attn_plain(value, shapes, loc, w)
    before = msda.KERNEL.launches
    for v in (value, shifted):
        got = msda.msda_forward_cuda(v, shapes, loc, w)
        torch.cuda.synchronize()
        assert got.shape == (b, q, heads * dim)
        # f32 sums of <= 32 samples x 4 corners in another order
        err = (got - want).abs().max().item()
        assert err <= 1e-5 + 1e-4 * want.abs().max().item(), err
        assert not bool(got.reshape(b, q, heads, dim)[:, ::7].any())
    assert msda.KERNEL.launches == before + 2


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


@pytest.mark.parametrize('case', [
    # (images, h, w, C, CO): the tile K2 picks for the 132-SM card
    (1, 5, 7, 256, 256),      # one image, Q under one tile: 64 x 128
    (1, 58, 100, 256, 256),   # one stage-3 image: 64 x 128, 182 tiles
    (2, 67, 127, 256, 256),   # ragged Q: 128 x 256
    (3, 60, 97, 128, 128),    # 128 x 128
    (1, 70, 123, 512, 512),   # two 256-channel tiles
    (1, 50, 115, 96, 384),    # 9 * C = 864: a half K slice; 128 x 128
])
def test_dcn_kernel_tiles_match_plain(dev, case):
    """K2 at every tile shape it picks, with a ragged Q, taps off the map,
    a K that ends inside a slice and C, CO = 96, 384, against the plain
    version."""
    b, h, w, c, co = case
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((b, h, w, c)), dev, torch.bfloat16)
    sx, sy, mask = _dcn_taps(rng, b, h, w, dev)
    weight = _t(rng.standard_normal((9 * c, co)) / np.sqrt(9 * c), dev,
                torch.bfloat16)
    before = dcn.KERNEL.launches
    got = dcn.dcn_conv_cuda(x, sx, sy, mask, weight)
    want = dcn.dcn_conv_plain(x, sx, sy, mask, weight)
    torch.cuda.synchronize()
    assert dcn.KERNEL.launches == before + 1
    assert got.shape == (b, h * w, co)
    # same bf16 taps and exact bf16 products; only the f32 accumulation
    # order over 9*C terms differs
    err = (got - want).abs().max().item()
    assert err <= 1e-3 * want.abs().max().item(), err


def test_dcn_kernel_taps_equal_plain(dev):
    """With the identity as its weight, K2's output is its bf16 taps: equal,
    bit for bit, to ``_taps16_plain`` (but for a sign of zero)."""
    rng = np.random.default_rng(12)
    b, h, w, c = 2, 40, 70, 256
    x = _t(rng.standard_normal((b, h, w, c)), dev, torch.bfloat16)
    sx, sy, mask = _dcn_taps(rng, b, h, w, dev)
    eye = torch.eye(9 * c, dtype=torch.bfloat16, device=dev)
    got = dcn.dcn_conv_cuda(x, sx, sy, mask, eye)
    torch.cuda.synchronize()
    for i in range(b):
        want = dcn._taps16_plain(x, sx, sy, mask, i).float()
        assert torch.equal(got[i], want)


def test_dcn_kernel_rejects_misaligned_x(dev):
    """K2 reads x in 16-byte chunks: a contiguous view that starts off a
    16-byte boundary is refused before the launch, with no CUDA error."""
    rng = np.random.default_rng(13)
    x = torch.randn(2 * 5 * 7 * 32 + 1, device=dev,
                    dtype=torch.bfloat16)[1:].view(2, 5, 7, 32)
    sx, sy, mask = _dcn_taps(rng, 2, 5, 7, dev)
    weight = torch.randn(9 * 32, 128, device=dev, dtype=torch.bfloat16)
    assert x.is_contiguous() and x.data_ptr() % 16
    before = dcn.KERNEL.launches
    with pytest.raises(ValueError, match='16-byte'):
        dcn.dcn_conv_cuda(x, sx, sy, mask, weight)
    assert dcn.KERNEL.launches == before
    got = dcn.dcn_conv_cuda(x.clone(), sx, sy, mask, weight)
    want = dcn.dcn_conv_plain(x, sx, sy, mask, weight)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()


@pytest.mark.parametrize('c', [256, 512, 6, 66])
def test_dcn_sample_kernel_matches_plain(dev, c):
    """K9 against its plain version: C = 256 and 512 take the float4
    kernel, C = 6 and 66 (not multiples of 4) the scalar one, and a view
    off a 16-byte boundary the scalar one at every C."""
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
    shifted = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    before = dcn.SAMPLE.launches
    want = dcn.dcn_sample_plain(x, sx, sy, mask)
    for xi in (x, shifted):
        got = dcn.dcn_sample_cuda(xi, sx, sy, mask)
        torch.cuda.synchronize()
        # the plain version's products and sum order, without FMAs
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err
        assert not bool(got[0, 0, 8].any())
    assert dcn.SAMPLE.launches == before + 2


def test_dcn_sample_kernel_rejects_misaligned_x(dev):
    """K9 used to refuse a contiguous view of x that starts off a 16-byte
    boundary; its scalar kernel now takes it: the view and a fresh copy of
    it both launch K9 and give the plain version's taps."""
    x = torch.randn(1 * 3 * 4 * 8 + 1, device=dev)[1:].view(1, 3, 4, 8)
    sx = torch.rand(1, 12, 9, device=dev) * 3
    sy, mask = sx.clone(), torch.ones_like(sx)
    assert x.is_contiguous() and x.data_ptr() % 16
    before = dcn.SAMPLE.launches
    want = dcn.dcn_sample_plain(x, sx, sy, mask)
    for xi in (x, x.clone()):
        got = dcn.dcn_sample_cuda(xi, sx, sy, mask)
        torch.cuda.synchronize()
        # the plain version's products and sum order, without FMAs
        assert (got - want).abs().max().item() <= \
            1e-5 * want.abs().max().item()
    assert dcn.SAMPLE.launches == before + 2


def _dcn_sample_inputs(rng, b, h, w, q, sigma, dev):
    """Taps of a 3x3 conv at stride 1 on an h x w map (q = h*w), displaced
    by N(0, sigma) pixels, or, for another q, anywhere on and around the
    map; plus exact zero-ring edges and samples wholly off the map."""
    if q == h * w:
        gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
        k = np.arange(3) - 1.0
        ky, kx = np.meshgrid(k, k, indexing='ij')
        sy = (gy.reshape(1, q, 1) + ky.reshape(1, 1, 9) +
              rng.normal(0, sigma, (b, q, 9)))
        sx = (gx.reshape(1, q, 1) + kx.reshape(1, 1, 9) +
              rng.normal(0, sigma, (b, q, 9)))
    else:
        sy = rng.uniform(-2, h + 1, (b, q, 9))
        sx = rng.uniform(-2, w + 1, (b, q, 9))
    sx[0, 0] = [-1.0, -0.5, -0.25, 0.0, w - 1.0, w - 0.75, w - 0.5, w, -3.0]
    sy[0, 0] = [0.5, h - 0.5, -0.5, h - 1.0, -1.0, 2.0, h + 0.25, 1.0, -2.0]
    sx[b - 1, q - 1] = w + 5.0
    mask = _t(rng.uniform(size=(b, q, 9)), dev)
    return _t(sx, dev), _t(sy, dev), mask


@pytest.mark.parametrize('sigma', [0.5, 4.0])
@pytest.mark.parametrize('layout', ['conv', 'other'])
@pytest.mark.parametrize('c', [256, 512, 6, 66])
def test_dcn_sample_kernel_routes_equal_plain(dev, c, layout, sigma):
    """K9 on both kernels, at B = 2 on an 11 x 37 map, which the 2 x 16
    tiles do not divide: a conv's Q = H*W taps displaced by N(0, 0.5) px
    keep their corners inside the staged windows, by N(0, 4) px send many
    outside them (read from x); C = 256 and 512 run the staged kernel, C =
    6 and 66, another Q and a view of x off a 16-byte boundary the scalar
    one. The taps equal the plain version's (the same products and sum
    order, no FMAs): == holds, which takes -0 for 0."""
    rng = np.random.default_rng(21)
    b, h, w = 2, 11, 37
    q = h * w if layout == 'conv' else 150
    x = _t(rng.standard_normal((b, h, w, c)), dev)
    sx, sy, mask = _dcn_sample_inputs(rng, b, h, w, q, sigma, dev)
    shifted = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    assert dcn.dcn_sample_route(x, q) == (
        'staged' if c % 4 == 0 and layout == 'conv' else 'scalar')
    assert dcn.dcn_sample_route(shifted, q) == 'scalar'
    want = dcn.dcn_sample_plain(x, sx, sy, mask)
    before = dcn.SAMPLE.launches
    for xi in (x, shifted):
        got = dcn.dcn_sample_cuda(xi, sx, sy, mask)
        torch.cuda.synchronize()
        assert bool((got == want).all()), (got - want).abs().max().item()
        assert not bool(got[0, 0, 8].any())
        assert not bool(got[b - 1, q - 1].any())
    assert dcn.SAMPLE.launches == before + 2


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


def test_f32_deform_conv_any_channels(dev):
    """An f32 DeformConv2d with C = 6 (K9's scalar kernel) runs on the card
    and agrees with the same module on the CPU."""
    from vidar_tpu_torch.models.resnet import DeformConv2d
    torch.manual_seed(0)
    mod = DeformConv2d(6, 64, device=dev)
    torch.nn.init.normal_(mod.conv_offset.weight, std=0.1)
    torch.nn.init.normal_(mod.conv_offset.bias, std=1.5)
    torch.nn.init.normal_(mod.kernel, std=1 / 54 ** 0.5)
    x = torch.randn(1, 6, 8, 8, device=dev)
    before = dcn.SAMPLE.launches
    with torch.no_grad():
        out = mod(x)
    torch.cuda.synchronize()
    assert dcn.SAMPLE.launches == before + 1
    assert out.shape == (1, 64, 8, 8)
    cpu = DeformConv2d(6, 64, device='cpu')
    cpu.load_state_dict({k: v.cpu() for k, v in mod.state_dict().items()})
    with torch.no_grad():
        ref = cpu(x.cpu())
    # f32 throughout, TF32 off: the offset conv and the product sum in
    # another order on the two devices
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-4)


def test_dcn_conv_copies_misaligned_inputs(dev):
    """``dcn_conv`` on a bf16 x and a weight that start off a 16-byte
    boundary: the wrapper copies them, K2 runs once and meets the plain
    version, and the input gradient flows back to the views."""
    rng = np.random.default_rng(14)
    b, h, w, c, co = 2, 5, 7, 32, 128
    x = torch.randn(b * h * w * c + 1, device=dev,
                    dtype=torch.bfloat16)[1:].view(b, h, w, c)
    weight = torch.empty(9 * c * co + 1, device=dev,
                         dtype=torch.bfloat16)[1:].view(9 * c, co)
    weight.copy_(torch.randn(9 * c, co, device=dev) * (9 * c) ** -0.5)
    assert x.data_ptr() % 16 and weight.data_ptr() % 16
    sx, sy, mask = _dcn_taps(rng, b, h, w, dev)
    before = dcn.KERNEL.launches
    xg = x.detach().requires_grad_()
    got = dcn.dcn_conv(xg, sx, sy, mask, weight)
    want = dcn.dcn_conv_plain(x, sx, sy, mask, weight)
    got.sum().backward()
    torch.cuda.synchronize()
    assert dcn.KERNEL.launches == before + 1
    # same bf16 taps and exact bf16 products; only the f32 accumulation
    # order over 9*C terms differs
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())


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


@pytest.mark.parametrize('sigma', [0.5, 4.0])
@pytest.mark.parametrize('layout', ['conv', 'other'])
@pytest.mark.parametrize('c', [64, 128, 256, 20])
def test_dcn_sample16_kernel_routes_equal_plain(dev, c, layout, sigma):
    """K10 on each of its kernels, at B = 2 on an 11 x 37 map, which the 2 x
    16 tiles do not divide: a conv's Q = H*W taps displaced by N(0, 0.5) px
    keep their corners inside the staged windows, by N(0, 4) px send many
    outside them (read from x); C = 64, 128 and 256 run the staged kernel
    for Q = H*W and the vector one for another Q, C = 20 and a view of x off
    a 16-byte boundary the scalar one. Zero-ring edges and taps wholly off
    the map are written in. The taps equal the plain version's bit for bit
    (the same products and sum order, no FMAs, one rounding to bf16)."""
    rng = np.random.default_rng(24)
    b, h, w = 2, 11, 37
    q = h * w if layout == 'conv' else 150
    x = _t(rng.standard_normal((b, h, w, c)), dev, torch.bfloat16)
    sx, sy, mask = _dcn_sample_inputs(rng, b, h, w, q, sigma, dev)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
    shifted = shifted.view(x.shape).copy_(x)
    assert shifted.data_ptr() % 16
    assert dcn.dcn_sample16_route(x, q) == (
        'scalar' if c % 8 else 'staged' if layout == 'conv' else 'vector')
    assert dcn.dcn_sample16_route(shifted, q) == 'scalar'
    want = dcn.dcn_sample16_plain(x, sx, sy, mask)
    before = dcn.SAMPLE16.launches
    for xi in (x, shifted):
        got = dcn.dcn_sample16_cuda(xi, sx, sy, mask)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == (b, q, 9 * c)
        assert torch.equal(got, want), (got.float() -
                                        want.float()).abs().max().item()
        assert not bool(got[0, 0, 8 * c:].any())
        assert not bool(got[b - 1, q - 1].any())
    assert dcn.SAMPLE16.launches == before + 2


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


@pytest.mark.parametrize('z', [16, 4, 5])
@pytest.mark.parametrize('act', ['sigmoid', 'exp'])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_first_hit_kernel_paths_match_plain(dev, dtype, act, z):
    """K3 at the presets' geometry (200 x 200 cells, G = 256 waypoints):
    Z = 16 and 4 run the vector kernel, Z = 5 and a map view off a 16-byte
    boundary the first design."""
    rng = np.random.default_rng(22)
    h = w = 200
    occ = _t(2.0 * rng.standard_normal((1, h, w, z)), dev, dtype)
    shifted = torch.empty(occ.numel() + 1, dtype=dtype, device=dev)[1:]
    shifted = shifted.view(occ.shape).copy_(occ)
    assert shifted.data_ptr() % 16
    assert latent_render.ray_first_hit_route(occ) == (
        'first design' if z == 5 else 'vector')
    assert latent_render.ray_first_hit_route(shifted) == 'first design'
    grids, rn, steps = _geometry(h, w, 256, dev)
    want = latent_render.ray_first_hit_plain(occ, grids, rn, steps, act)
    before = latent_render.FIRST_HIT.launches
    for o in (occ, shifted):
        got = latent_render.ray_first_hit_cuda(o, grids, rn, steps, act)
        torch.cuda.synchronize()
        # outputs in [0, 1]; a product of <= 257 factors in another order
        # plus the activation's last-bit rounding
        err = (got - want).abs().max().item()
        assert err <= 1e-4, err
    assert latent_render.FIRST_HIT.launches == before + 2


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_first_hit_kernel_any_step_order(dev, dtype):
    """The vector K3 stops a ray at the first batch of waypoints outside the
    cell only when the steps ascend from zero; steps in another order (here
    shuffled) walk every waypoint and give the plain version's result."""
    rng = np.random.default_rng(23)
    h = w = 60
    occ = _t(rng.standard_normal((1, h, w, 16)), dev, dtype)
    grids, rn, steps = _geometry(h, w, 77, dev)
    steps = steps[torch.from_numpy(rng.permutation(77)).to(dev)]
    assert latent_render.ray_first_hit_route(occ) == 'vector'
    got = latent_render.ray_first_hit_cuda(occ, grids, rn, steps, 'exp')
    want = latent_render.ray_first_hit_plain(occ, grids, rn, steps, 'exp')
    torch.cuda.synchronize()
    # a product of <= 78 factors in another order
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


@pytest.mark.parametrize('c_r,z', [(16, 16), (8, 4), (16, 1), (4, 4),
                                    (16, 8)])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_aggregate_kernel_paths_match_plain(dev, c_r, z, dtype):
    """K4 at groups c_r / Z of 1, 2, 16 and 2 more shapes: the vector kernel
    runs the presets' shapes where c_r and Z are whole 16-byte chunks (f32
    (16, 16) with four lanes a waypoint, bf16 (16, 16) with two, f32 (4, 4)
    with one), the scalar one every other shape and a map off a 16-byte
    boundary; 256 waypoints, as the flagship's rays."""
    rng = np.random.default_rng(18)
    h, w = 50, 70
    fmap = _t(np.concatenate([rng.standard_normal((2, h, w, c_r)),
                              rng.uniform(0, 1, (2, h, w, z))], -1), dev,
              dtype)
    shifted = torch.empty(fmap.numel() + 1, dtype=dtype, device=dev)[1:]
    shifted = shifted.view(fmap.shape).copy_(fmap)
    assert shifted.data_ptr() % 16
    grids, rn, steps = _geometry(h, w, 256, dev)
    want = latent_render.ray_aggregate_plain(fmap, grids, rn, steps, c_r, z,
                                             1e-3)
    before = latent_render.AGGREGATE.launches
    for fm in (fmap, shifted):
        got = latent_render.ray_aggregate_cuda(fm, grids, rn, steps, c_r, z,
                                               1e-3)
        torch.cuda.synchronize()
        assert got.shape == (2, h * w, c_r)
        # two f32 sums over <= 256 waypoints in another order, then a
        # division
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * max(1.0, want.abs().max().item()), err
    assert latent_render.AGGREGATE.launches == before + 2


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


def _motion_msda_inputs(rng, dev, q=64872):
    """UniAD's motion-head call: 901 agents x 6 modes x 12 steps folded
    into one query axis over one 200x200 BEV level, 8 heads x 32 dims, 4
    points; endpoints near and off the map's border."""
    shapes, heads, dim, p = [(200, 200)], 8, 32, 4
    value = _t(rng.standard_normal((1, 40000, heads, dim)), dev)
    loc = _t(rng.uniform(-0.05, 1.05, (1, q, heads, 1, p, 2)), dev)
    w = rng.uniform(size=(1, q, heads, p))
    w = _t((w / w.sum(-1, keepdims=True)).reshape(1, q, heads, 1, p), dev)
    g = _t(rng.standard_normal((1, q, heads * dim)), dev)
    return shapes, value, loc, w, g


def test_msda_kernels_at_the_motion_shape(dev):
    """K1 and K5 at one level with more than 60,000 queries (UniAD's
    motion head, 64,872), against the plain version and its autograd."""
    shapes, value, loc, w, g = _motion_msda_inputs(
        np.random.default_rng(21), dev)
    before = (msda.KERNEL.launches, msda.BACKWARD.launches)
    got = msda.msda_forward_cuda(value, shapes, loc, w)
    want = msda.msdeform_attn_plain(value, shapes, loc, w)
    torch.cuda.synchronize()
    # f32 sums of 4 samples x 4 corners in another order
    err = (got - want).abs().max().item()
    assert err <= 1e-5 + 1e-4 * want.abs().max().item(), err
    dv, dl, dw = msda.msda_backward_cuda(value, shapes, loc, w, g)
    want = _plain_grads(
        lambda v, lo, aw: msda.msdeform_attn_plain(v, shapes, lo, aw),
        (value, loc, w), g)
    torch.cuda.synchronize()
    assert (msda.KERNEL.launches, msda.BACKWARD.launches) == (
        before[0] + 1, before[1] + 1)
    # f32 atomic sums in another order
    for got_g, want_g in zip((dv, dl, dw), want):
        assert _rel_err(got_g, want_g) <= 1e-4


def _msda_inputs(rng, case, dim, dtype, dev, b=None):
    """A TSA-like (one level, P = 4) or SCA-like (four levels, P = 8) call
    with a Q that leaves the last block ragged, samples off the map on every
    level (every 7th query's wholly), and unit-scale dout."""
    if case == 'tsa':
        shapes, b0, q, heads, p = [(40, 50)], 2, 1001, 8, 4
    else:
        shapes, b0, q, heads, p = [(29, 50), (15, 25), (8, 13), (4, 7)], 3, \
            777, 8, 8
    b = b or b0
    v_len = sum(h * w for h, w in shapes)
    value = _t(rng.standard_normal((b, v_len, heads, dim)), dev, dtype)
    loc = rng.uniform(-0.2, 1.2, (b, q, heads, len(shapes), p, 2))
    loc[:, ::7, ..., 0] = -3.0
    w = rng.uniform(size=(b, q, heads, len(shapes), p))
    g = _t(rng.standard_normal((b, q, heads * dim)), dev)
    return shapes, value, _t(loc, dev), _t(w, dev), g


def _check_msda_backward(got, want, dtype):
    dv, dl, dw = got
    assert dv.dtype == dtype
    # f32 atomic sums in another order; the kernel rounds dvalue of a bf16
    # value to bf16 (2^-9 relative)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert _rel_err(dv, want[0]) <= tol
    assert _rel_err(dl, want[1]) <= 1e-4
    assert _rel_err(dw, want[2]) <= 1e-4


@pytest.mark.parametrize('case', ['tsa', 'sca'])
@pytest.mark.parametrize('dim', [8, 16, 32, 20])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_msda_backward_kernel_paths_match_plain(dev, case, dim, dtype):
    """K5's vector kernel (dims 8, 16, 32: 1, 2 or 4 lanes a row) and its
    scalar one (dim 20, and a value off a 16-byte boundary) against autograd
    of the plain version."""
    rng = np.random.default_rng(15)
    shapes, value, loc, w, g = _msda_inputs(rng, case, dim, dtype, dev)
    shifted = torch.empty(value.numel() + 1, dtype=dtype, device=dev)[1:]
    shifted = shifted.view(value.shape).copy_(value)
    assert shifted.data_ptr() % 16
    want = _plain_grads(
        lambda v, lo, aw: msda.msdeform_attn_plain(v, shapes, lo, aw),
        (value, loc, w), g)
    before = msda.BACKWARD.launches
    for v in (value, shifted):
        got = msda.msda_backward_cuda(v, shapes, loc, w, g)
        torch.cuda.synchronize()
        _check_msda_backward(got, want, dtype)
        # every 7th query's samples are off the map: no gradient
        assert not bool(got[1].reshape(
            value.shape[0], -1, *loc.shape[2:])[:, ::7].any())
    assert msda.BACKWARD.launches == before + 2


@pytest.mark.parametrize('case', ['tsa', 'sca'])
@pytest.mark.parametrize('dim', [48, 64])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_msda_wide_heads_match_plain(dev, case, dim, dtype):
    """Head dims above 32 through ``msdeform_attn`` on the card (K1 forward,
    K5 backward through autograd): dim 64 takes the vector kernels (K1: 8
    lanes a bf16 row, 16 an f32 one; K5: 8 in both), dim 48 (6 or 12
    lanes, not a power of two) the scalar ones; both against the plain
    version and its autograd."""
    rng = np.random.default_rng(16)
    shapes, value, loc, w, g = _msda_inputs(rng, case, dim, dtype, dev)
    want = msda.msdeform_attn_plain(value, shapes, loc, w)
    want_grads = _plain_grads(
        lambda v, lo, aw: msda.msdeform_attn_plain(v, shapes, lo, aw),
        (value, loc, w), g)
    leaves = [x.clone().requires_grad_() for x in (value, loc, w)]
    counts = (msda.KERNEL.launches, msda.BACKWARD.launches)
    got = msda.msdeform_attn(leaves[0], shapes, leaves[1], leaves[2])
    got.backward(g)
    torch.cuda.synchronize()
    assert (msda.KERNEL.launches, msda.BACKWARD.launches) == (
        counts[0] + 1, counts[1] + 1)
    assert got.shape == want.shape
    # f32 sums of <= 32 samples x 4 corners in another order
    err = (got - want).abs().max().item()
    assert err <= 1e-5 + 1e-4 * want.abs().max().item(), err
    _check_msda_backward([x.grad for x in leaves], want_grads, dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_msda_backward_kernel_shared_corners(dev, dtype):
    """Every sample of every query and head in one 3x3-pixel patch of each
    level: a block's atomic updates pile onto the same few value rows."""
    rng = np.random.default_rng(17)
    shapes, b, q, heads, dim, p = [(20, 30), (10, 15)], 2, 600, 8, 32, 8
    v_len = sum(h * w for h, w in shapes)
    value = _t(rng.standard_normal((b, v_len, heads, dim)), dev, dtype)
    loc = np.empty((b, q, heads, len(shapes), p, 2))
    for lvl, (h, w_) in enumerate(shapes):
        loc[..., lvl, :, 0] = rng.uniform(5.0, 8.0, loc.shape[:3] + (p,)) / w_
        loc[..., lvl, :, 1] = rng.uniform(4.0, 7.0, loc.shape[:3] + (p,)) / h
    loc = _t(loc, dev)
    w = _t(rng.uniform(size=(b, q, heads, len(shapes), p)), dev)
    g = _t(rng.standard_normal((b, q, heads * dim)), dev)
    want = _plain_grads(
        lambda v, lo, aw: msda.msdeform_attn_plain(v, shapes, lo, aw),
        (value, loc, w), g)
    got = msda.msda_backward_cuda(value, shapes, loc, w, g)
    torch.cuda.synchronize()
    # sample points in 3 x 3 pixels have their corners in 5 x 5 rows: at
    # most 25 rows of each (image, head, level) are touched
    touched = (want[0] != 0).any(-1).sum().item()
    assert touched <= b * heads * len(shapes) * 25
    _check_msda_backward(got, want, dtype)


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


# the gradient's tolerance against autograd of the plain version in f32,
# relative to its largest element: f32 atomic sums in another order, and a
# bf16 gradient rounded once to bf16 (chip_smoke.py's BACKWARD_RTOL)
_FIRST_HIT_BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 4e-3}


def _shifted(t):
    """A copy of t in a view off a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    out = out.view(t.shape).copy_(t)
    assert out.data_ptr() % 16
    return out


def _check_first_hit_backward(occ, geo, act, g, routes):
    """K6/K7 on occ and on a view of it off a 16-byte boundary, against
    autograd of ``ray_first_hit_plain``; ``routes`` the kernels they take."""
    shifted = _shifted(occ)
    (want,) = _plain_grads(
        lambda o: latent_render.ray_first_hit_plain(o, *geo, act), (occ,), g)
    before = latent_render.FIRST_HIT_BACKWARD.launches
    for o, route in zip((occ, shifted), routes):
        assert latent_render.ray_first_hit_backward_route(o, g) == route
        got = latent_render.ray_first_hit_backward_cuda(o, *geo, act, g)
        torch.cuda.synchronize()
        assert got.dtype == occ.dtype and got.shape == occ.shape
        assert bool(torch.isfinite(got).all())
        err = _rel_err(got, want)
        assert err <= _FIRST_HIT_BWD_RTOL[occ.dtype], (route, err)
    assert latent_render.FIRST_HIT_BACKWARD.launches == before + 2


@pytest.mark.parametrize('z', [16, 4, 5])
@pytest.mark.parametrize('act', ['sigmoid', 'exp'])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_first_hit_backward_kernel_routes_match_plain(dev, dtype, act, z):
    """K6/K7 at the presets' geometry (200 x 200 cells, G = 256): Z = 16 and
    4 run the vector kernel, Z = 5 and a map view off a 16-byte boundary the
    scalar one. The map holds a block of logits +30 right of the centre,
    which saturates the rays through it (P = 0 in f32), and a block of -30;
    g has zero rows (every third cell) and scattered zero bins."""
    rng = np.random.default_rng(25)
    h = w = 200
    occ = 2.0 * rng.standard_normal((1, h, w, z))
    occ[:, 95:105, 104:124] = 30.0
    occ[:, 40:60, 40:60] = -30.0
    occ = _t(occ, dev, dtype)
    geo = _geometry(h, w, 256, dev)
    g = rng.standard_normal((1, h * w, z))
    g[:, ::3] = 0.0
    g[rng.uniform(size=g.shape) < 0.2] = 0.0
    vec = 'scalar' if z == 5 else 'vector'
    _check_first_hit_backward(occ, geo, act, _t(g, dev), (vec, 'scalar'))


@pytest.mark.parametrize('act', ['sigmoid', 'exp'])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_first_hit_backward_kernel_any_waypoint_count(dev, dtype, act):
    """G = 1100 waypoints, more than the first design's checkpoint table
    held (1024), 0.04 px apart on a 64 x 64 map, so the cells near the
    corners have over 1024 inside their radius; both kernels."""
    from vidar_tpu_torch.models.latent_rendering import ray_geometry
    rng = np.random.default_rng(26)
    h = w = 64
    occ = _t(0.3 * rng.standard_normal((1, h, w, 16)), dev, dtype)
    geo = ray_geometry(h, w, 1100, 0.02, dev)
    g = _t(rng.standard_normal((1, h * w, 16)), dev)
    _check_first_hit_backward(occ, geo, act, g, ('vector', 'scalar'))


@pytest.mark.parametrize('act', ['sigmoid', 'exp'])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_first_hit_backward_kernel_any_step_order(dev, dtype, act):
    """The vector K6/K7 stops its walks at the first batch of waypoints
    outside the cell only when the steps ascend from zero; shuffled steps
    walk every waypoint, on both kernels."""
    rng = np.random.default_rng(27)
    h = w = 60
    occ = _t(2.0 * rng.standard_normal((1, h, w, 16)), dev, dtype)
    grids, rn, steps = _geometry(h, w, 77, dev)
    steps = steps[torch.from_numpy(rng.permutation(77)).to(dev)]
    g = _t(rng.standard_normal((1, h * w, 16)), dev)
    _check_first_hit_backward(occ, (grids, rn, steps), act, g,
                              ('vector', 'scalar'))


def _aggregate_map(rng, b, h, w, c_r, z, dtype, dev):
    """Features N(0, 1) and probabilities U(0, 1), as K4's tests."""
    return _t(np.concatenate([rng.standard_normal((b, h, w, c_r)),
                              rng.uniform(0, 1, (b, h, w, z))], -1), dev,
              dtype)


def _check_aggregate_backward(fmap, geo, c_r, z, g, route):
    """K8 on (fmap, g), which take ``route``, and with either one in a view
    off a 16-byte boundary, which take the scalar kernel, against autograd
    of ``ray_aggregate_plain`` (relative to the largest element: f32 atomic
    sums in another order; a bf16 gradient is also rounded once to bf16,
    2^-9 relative)."""
    (want,) = _plain_grads(
        lambda f: latent_render.ray_aggregate_plain(f, *geo, c_r, z, 1e-3),
        (fmap,), g)
    tol = 1e-2 if fmap.dtype == torch.bfloat16 else 1e-4
    before = latent_render.AGGREGATE_BACKWARD.launches
    for fm, gg, r in ((fmap, g, route), (_shifted(fmap), g, 'scalar'),
                      (fmap, _shifted(g), 'scalar')):
        assert latent_render.ray_aggregate_backward_route(fm, gg) == r
        got = latent_render.ray_aggregate_backward_cuda(fm, *geo, c_r, z,
                                                        1e-3, gg)
        torch.cuda.synchronize()
        assert got.dtype == fmap.dtype and got.shape == fmap.shape
        assert bool(torch.isfinite(got).all())
        err = _rel_err(got, want)
        assert err <= tol, (r, err)
    assert latent_render.AGGREGATE_BACKWARD.launches == before + 3


@pytest.mark.parametrize('c_r,z', [(16, 16), (8, 4), (4, 4)])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_aggregate_backward_kernel_matches_plain(dev, c_r, z, dtype):
    """K8 on both kernels: the presets' (16, 16) and (4, 4) take the vector
    one, group size 2 ((8, 4)) the scalar one, as every misaligned map or
    gradient does."""
    rng = np.random.default_rng(6)
    h = w = 60
    fmap = _aggregate_map(rng, 1, h, w, c_r, z, dtype, dev)
    g = _t(rng.standard_normal((1, h * w, c_r)), dev)
    route = 'scalar' if c_r != z else 'vector'
    _check_aggregate_backward(fmap, _geometry(h, w, 64, dev), c_r, z, g,
                              route)


@pytest.mark.parametrize('c_r,z', [(16, 16), (4, 4)])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_aggregate_backward_kernel_routes_match_plain(dev, dtype, c_r, z):
    """K8 at the presets' geometry (200 x 200 cells, G = 256, a batch of 2)
    with g zero in every third cell and in scattered channels: the vector
    kernel skips the zero cells."""
    rng = np.random.default_rng(28)
    h = w = 200
    fmap = _aggregate_map(rng, 2, h, w, c_r, z, dtype, dev)
    g = rng.standard_normal((2, h * w, c_r))
    g[:, ::3] = 0.0
    g[rng.uniform(size=g.shape) < 0.2] = 0.0
    _check_aggregate_backward(fmap, _geometry(h, w, 256, dev), c_r, z,
                              _t(g, dev), 'vector')


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_aggregate_backward_kernel_mostly_zero_cells(dev, dtype):
    """g zero in all but 1% of the cells, as on the fine-tune step: the
    skipped cells send nothing, the others their full gradient."""
    rng = np.random.default_rng(29)
    h = w = 100
    fmap = _aggregate_map(rng, 1, h, w, 16, 16, dtype, dev)
    g = rng.standard_normal((1, h * w, 16))
    g[:, rng.uniform(size=h * w) >= 0.01] = 0.0
    _check_aggregate_backward(fmap, _geometry(h, w, 256, dev), 16, 16,
                              _t(g, dev), 'vector')


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_aggregate_backward_kernel_any_waypoint_count(dev, dtype):
    """G = 1100 waypoints, 0.04 px apart on a 64 x 64 map, so every cell
    lists over 32 batches of them; both kernels."""
    from vidar_tpu_torch.models.latent_rendering import ray_geometry
    rng = np.random.default_rng(30)
    h = w = 64
    fmap = _aggregate_map(rng, 1, h, w, 16, 16, dtype, dev)
    geo = ray_geometry(h, w, 1100, 0.02, dev)
    g = _t(rng.standard_normal((1, h * w, 16)), dev)
    _check_aggregate_backward(fmap, geo, 16, 16, g, 'vector')


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_aggregate_backward_kernel_any_step_order(dev, dtype):
    """The vector K8 stops its walks at the first batch of waypoints
    outside the boundary square only when the steps ascend from zero;
    shuffled steps walk every waypoint, on both kernels."""
    rng = np.random.default_rng(31)
    h = w = 60
    fmap = _aggregate_map(rng, 1, h, w, 16, 16, dtype, dev)
    grids, rn, steps = _geometry(h, w, 150, dev)
    steps = steps[torch.from_numpy(rng.permutation(150)).to(dev)]
    g = _t(rng.standard_normal((1, h * w, 16)), dev)
    _check_aggregate_backward(fmap, (grids, rn, steps), 16, 16, g, 'vector')


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


@pytest.mark.parametrize('factor', [720 / 900, 1080 / 900, 2 / 3],
                         ids=['720', '1080', '2_3'])
def test_native_resize_equals_numpy_on_flagship_image(dev, factor):
    # the loader's host library, built on the card's machine with its own
    # g++: the C++ resize, crop and flip against the numpy versions (both
    # equal to Pillow's, tests/test_torch_data.py) on a 900x1600 camera
    from vidar_tpu_torch import native
    from vidar_tpu_torch.data import pipeline
    assert native.available(), native.build_error
    img = np.random.default_rng(0).integers(0, 256, (900, 1600, 3),
                                            np.uint8)
    size = (int(1600 * factor), int(900 * factor))
    want = pipeline.resize_bicubic(img, size)
    np.testing.assert_array_equal(native.resize_bicubic(img, size), want)
    box = (10, -4, size[0] - 10, size[1] + 4)
    np.testing.assert_array_equal(native.crop_flip(want, box, True),
                                  pipeline.crop_flip(want, box, True))


@pytest.mark.parametrize('g', [40, 200])
def test_auction_on_the_card_equals_the_cpu(dev, g):
    """``auction_assign`` (plain PyTorch, no kernel of its own) on the card
    at the fine-tune's cost shape [900, G]: the same owners as on the CPU,
    every GT owned once."""
    from vidar_tpu_torch.core import bbox
    rng = np.random.default_rng(g)
    cost = torch.from_numpy(rng.uniform(0, 3, (900, g)).astype(np.float32))
    cpu = bbox.auction_assign(cost, g)
    card = bbox.auction_assign(cost.to(dev), g)
    assert card.device.type == 'cuda'
    assert torch.equal(card.cpu(), cpu)
    assert sorted(cpu[cpu >= 0].tolist()) == list(range(g))


@pytest.mark.parametrize('case', ['stage1', 'stride2', 'dilation2',
                                  'past-border'])
def test_dcnv3_msda_route_matches_plain(dev, case):
    """InternImage's DCNv3 core through K1 (forward) and K5 (backward)
    against its plain gather, forward and gradients."""
    from vidar_tpu_torch.ops.dcnv3 import (_sample_points, dcnv3_core,
                                           dcnv3_core_plain)
    stride, dilation, scale = {
        'stage1': ((1, 1), (1, 1), 2.0), 'stride2': ((2, 2), (1, 1), 1.0),
        'dilation2': ((1, 1), (2, 2), 1.0),
        'past-border': ((1, 1), (1, 1), 8.0)}[case]
    rng = np.random.default_rng(1)
    b, h, w, groups, gc = 2, 58, 100, 4, 16
    ho, wo = -(-h // stride[0]), -(-w // stride[1])
    x = _t(rng.standard_normal((b, h, w, groups * gc)), dev)
    offset = _t(rng.standard_normal((b, ho, wo, groups * 18)) * scale, dev)
    mask = _t(rng.standard_normal((b, ho, wo, groups * 9)), dev)
    g = _t(rng.standard_normal((b, ho, wo, groups * gc)), dev)
    kw = dict(stride=stride, dilation=dilation, groups=groups)
    sides = []
    before = (msda.KERNEL.launches, msda.BACKWARD.launches)
    for fn in (dcnv3_core, dcnv3_core_plain):
        ins = [t.clone().requires_grad_() for t in (x, offset, mask)]
        out = fn(*ins, **kw)
        out.backward(g)
        sides.append([out.detach()] + [t.grad for t in ins])
    torch.cuda.synchronize()
    assert (msda.KERNEL.launches, msda.BACKWARD.launches) == (
        before[0] + 1, before[1] + 1)
    # bilinear sampling has a kink at each integer pixel coordinate: where
    # the (pixel + 0.5) / size round trip moves a sample across one, the
    # two routes take the offset's derivative from opposite sides. Such
    # samples (within 1e-3 pixel) are left out of d offset, and are few
    sx, sy, _ = _sample_points(offset, mask, (3, 3), stride, dilation,
                               groups)
    kink = (((sx - sx.round()).abs() < 1e-3) |
            ((sy - sy.round()).abs() < 1e-3))
    assert kink.float().mean().item() < 1e-2
    keep = ~kink[..., None].expand(*kink.shape, 2).reshape(offset.shape)
    sides = [[out, dx, doff * keep, dmask]
             for out, dx, doff, dmask in sides]
    # f32 sums in other orders (K5 scatters dx with atomics), and the
    # round trip of each sample coordinate
    for name, got, want in zip(('out', 'dx', 'doffset', 'dmask'), *sides):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), (name, err)
