"""The port's bf16 deformable-conv taps (``dcn_sample16``, the CPU side of
kernel K10) against the JAX package's ``dcn_sample16``: its Pallas kernel
``dcn16_gather`` in interpret mode and its XLA reference
``_dcn_sample16_ref_perm``; the bf16 ``DeformConv2d`` whose shape the fused
conv does not take against the JAX module's ``dcn16_gather`` route and its
XLA take route (output and parameter gradients); and the bf16 forecast with a
deformable conv in every backbone stage against the JAX forecast.

PyTorch runs on one thread here (as in tests/test_torch_train.py), and every
JAX reference runs under ``jax.jit``: one compile, not one per operation.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidar_tpu.configs import vidar_dryrun as jax_vidar_dryrun
from vidar_tpu.data import make_synthetic_batch as jax_synthetic_batch
from vidar_tpu.evals.forecast_runner import ForecastRunner as JaxRunner
from vidar_tpu.models import ViDAR as JaxViDAR
from vidar_tpu.models.resnet import DeformConv2d as JaxDeformConv2d
from vidar_tpu.ops import dcn_pallas

from vidar_tpu_torch.configs import vidar_dryrun
from vidar_tpu_torch.convert import state_dict_from_jax
from vidar_tpu_torch.data import make_synthetic_batch
from vidar_tpu_torch.evals.forecast_runner import ForecastRunner
from vidar_tpu_torch.models import ViDAR, resnet
from vidar_tpu_torch.ops import dcn

ALL_DCN = (True, True, True, True)
# the bf16 forecast, relative to the largest output of each compared tensor:
# each side rounds its bf16 activations (2^-9 relative) after every conv,
# norm and attention, at other places (PyTorch's CPU kernels accumulate in
# f32 and round once per op, XLA may keep fused intermediates in f32), and
# the differences carry through ~50 conv layers, the encoder and the BEV
# recurrence: 1e-3, the f32 tolerance of tests/test_torch_vidar.py, is far
# below one bf16 rounding step, so the bf16 forecast is held at 5e-2
BF16_REL_TOL = 5e-2


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(a):
    """a rounded to bf16 values, kept as f32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _inputs(b=2, h=8, w=10, c=256, seed=0):
    """bf16-valued x and coordinates over and around the map, with the edge
    cases written in: exact pixel centres, the zero ring (one corner on the
    map, one off), and samples wholly off the map."""
    rng = np.random.default_rng(seed)
    q = h * w
    x = _bf16(rng.standard_normal((b, h, w, c)).astype(np.float32))
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


def test_plain_matches_dcn16_gather_and_reference():
    x, sx, sy, mask = _inputs()
    b, _, _, c = x.shape
    q = sx.shape[1]
    jargs = [jnp.asarray(a) for a in (x, sx, sy, mask)]
    # on the CPU the JAX dcn_sample16 runs dcn16_gather in interpret mode;
    # both emit each tap's channels evens || odds: undo that
    inv = np.argsort(dcn_pallas.dcn16_channel_perm(c))

    def natural(taps):
        return np.asarray(taps).reshape(b, q, 9, c)[..., inv].reshape(
            b, q, 9 * c)

    kernel = natural(jax.jit(dcn_pallas.dcn_sample16)(*jargs))
    ref = natural(jax.jit(dcn_pallas._dcn_sample16_ref_perm)(*jargs))
    targs = [torch.from_numpy(a) for a in (sx, sy, mask)]
    # the f32 sums before the rounding: x held as f32 is not rounded
    taps32 = dcn.dcn_sample16_plain(torch.from_numpy(x), *targs).numpy()
    taps16 = dcn.dcn_sample16_plain(torch.from_numpy(x).to(torch.bfloat16),
                                    *targs)
    assert taps16.dtype == torch.bfloat16 and taps16.shape == (b, q, 9 * c)
    # the same corner weights (bilinear x mask, folded first) and the same
    # f32 sum order as the Pallas fold: within 1e-6 (taps up to ~4 in size)
    assert np.abs(taps32 - kernel).max() <= 1e-6
    want16 = torch.from_numpy(kernel).to(torch.bfloat16).float().numpy()
    assert np.abs(taps16.float().numpy() - want16).max() <= 1e-6
    # the XLA reference folds the mask after the corner sum: other roundings
    assert np.abs(taps32 - ref).max() <= 1e-6
    # a sample wholly off the map is an exact zero
    taps32 = taps32.reshape(b, q, 9, c)
    assert not np.any(taps32[0, 0, 8]) and not np.any(taps32[1, 1, 8])


def _grad_cosines(got, want):
    """Cosine similarity of each parameter gradient, by torch key."""
    out = {}
    for k, w in want.items():
        a = got[k].float().reshape(-1).double()
        b_ = w.reshape(-1).double()
        out[k] = float(a @ b_ / (a.norm() * b_.norm()))
    return out


@pytest.mark.parametrize('c,co,jax_route', [(256, 64, 'dcn16_gather'),
                                            (64, 64, 'take')])
def test_module_bf16_matches_jax(monkeypatch, c, co, jax_route):
    """C = 256, CO = 64 (tests/models/test_deform_conv.py's shape): JAX with
    ``VIDAR_TPU_DCN16=force`` samples with ``dcn16_gather`` (interpret mode)
    and multiplies outside; C = CO = 64: JAX's XLA take path. The port runs
    ``dcn_sample16`` (K10's plain version) and a bf16 product at both."""
    monkeypatch.setenv('VIDAR_TPU_DCN16', 'force')
    jax_calls, port_calls = [], []
    real16 = dcn_pallas.dcn_sample16
    monkeypatch.setattr(dcn_pallas, 'dcn_sample16',
                        lambda *a: jax_calls.append(1) or real16(*a))
    for name in ('dcn_sample16', 'dcn_conv'):
        real = getattr(resnet, name)
        monkeypatch.setattr(resnet, name, lambda *a, _n=name, _r=real:
                            port_calls.append(_n) or _r(*a))
    rng = np.random.default_rng(c)
    x = _bf16(rng.standard_normal((2, 8, 10, c)).astype(np.float32))
    mod = JaxDeformConv2d(features=co, dtype=jnp.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), xj))
    # the kernel N(0, 0.05^2), as tests/models/test_deform_conv.py perturbs
    # it. Each side runs the offset conv in bf16 with its own accumulation
    # and rounding: with a random offset kernel a quarter of the offsets
    # differ by one bf16 step (up to 1/16 px), which moves the samples, and
    # the comparison would hold the two frameworks' bf16 convolutions, not
    # the deformable conv. So the offset conv's kernel is zero, as both
    # packages initialise it, and its bias sets per-tap offsets of ~1.5 px
    # and the masks: the same bf16 values on both sides; taps leave the map
    # and cross the ring at the borders
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: (rng.standard_normal(s.shape) * {
            'kernel': 0.0 if 'conv_offset' in str(path) else 0.05,
            'bias': 1.5}[path[-1].key]).astype(np.float32), shapes)

    def loss(p):
        return (mod.apply(p, xj).astype(jnp.float32) ** 2).sum()

    want = np.asarray(jax.jit(mod.apply)(params, xj).astype(jnp.float32))
    want_g = state_dict_from_jax(jax.tree_util.tree_map(
        np.array, jax.jit(jax.grad(loss))(params)))
    assert bool(jax_calls) == (jax_route == 'dcn16_gather')

    port = resnet.DeformConv2d(c, co, dtype=torch.bfloat16, device='cpu')
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    out = port(xt)
    (out.float() ** 2).sum().backward()
    assert port_calls == ['dcn_sample16']
    got = out.detach().float().permute(0, 2, 3, 1).numpy()
    # bf16 outputs of a product over 9*C bf16 taps: as
    # tests/models/test_deform_conv.py:33 holds the JAX routes to each other
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    # the taps' cotangent is rounded through the bf16 product on both
    # sides, in other orders: direction agreement, as
    # tests/models/test_deform_conv.py:69-79
    cos = _grad_cosines({k: p.grad for k, p in port.named_parameters()},
                        want_g)
    assert set(cos) == {'conv_offset.weight', 'conv_offset.bias', 'kernel'}
    assert min(cos.values()) > 0.999, cos


SHAPES = dict(bs=1, queue_length=2, future_length=2, num_cams=3, img_h=64,
              img_w=64, max_points=128)


def _random_params(shapes, seed=0):
    """Numpy-seeded weights with unit-scale activations, as
    tests/test_torch_vidar.py makes them."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == 'kernel':
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == 'scale':
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == 'bias':
            v = 0.1 * rng.standard_normal(s.shape)
        else:
            v = rng.standard_normal(s.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def test_all_dcn_forecast_bf16_matches_jax(monkeypatch):
    """``vidar_dryrun`` with a deformable conv in every ResNet stage, in
    bf16: stage 1 (C = CO = 64) takes K10's route in the port, stages 2-4
    K2's; the JAX package takes its XLA take path on the CPU."""
    port_calls = []
    for name in ('dcn_sample16', 'dcn_conv'):
        real = getattr(resnet, name)
        monkeypatch.setattr(resnet, name, lambda *a, _n=name, _r=real:
                            port_calls.append(_n) or _r(*a))
    cfg = vidar_dryrun(backbone_dcn=ALL_DCN)
    jax_model = JaxViDAR(**jax_vidar_dryrun(backbone_dcn=ALL_DCN),
                         dtype=jnp.bfloat16)
    jbatch = jax_synthetic_batch(np.random.default_rng(0), **SHAPES)
    key = jax.random.PRNGKey(0)
    params = _random_params(jax.eval_shape(lambda: jax_model.init(
        {'params': key, 'dropout': key}, jbatch, train=False)))
    model = ViDAR(**cfg, dtype=torch.bfloat16, device='cpu').eval()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    tbatch = make_synthetic_batch(np.random.default_rng(0), **SHAPES,
                                  device='cpu')
    img_hw = (SHAPES['img_h'], SHAPES['img_w'])
    num_future = cfg['test_future_frame_num']
    jr = JaxRunner(jax_model, params, img_hw, num_future=num_future)

    # the backbone and FPN, where the deformable convs are
    bs, t, cams, h, w, _ = jbatch.images.shape
    j_feats = jr._backbone(params, jbatch.images.reshape(bs * t * cams, h, w,
                                                         3))
    with torch.inference_mode():
        t_feats = model.backbone_forward(
            tbatch.images.reshape(bs * t * cams, h, w, 3))
    # 3 + 4 + 6 + 3 ResNet-50 blocks: K10's route in stage 1, K2's after
    assert port_calls == ['dcn_sample16'] * 3 + ['dcn_conv'] * 13
    for i, (a, b) in enumerate(zip(t_feats, j_feats)):
        err = _rel_err(a.float(), jnp.asarray(b, jnp.float32))
        assert err <= BF16_REL_TOL, (f'fpn level {i}', err)

    # the whole forecast, down to the depth decode
    want = jr(jbatch)
    got = ForecastRunner(model, img_hw, num_future=num_future,
                         device='cpu')(tbatch)
    valid = np.asarray(want['frame_idx']) >= 0
    assert valid.sum() > 0
    np.testing.assert_array_equal(got['frame_idx'].numpy(),
                                  np.asarray(want['frame_idx']))
    # gt distances are f32 geometry on both sides
    np.testing.assert_allclose(got['gt_dist'].numpy()[valid],
                               np.asarray(want['gt_dist'])[valid],
                               rtol=0, atol=1e-5)
    pred, pred_want = (got['pred_dist'].numpy()[valid],
                       np.asarray(want['pred_dist'])[valid])
    assert np.isfinite(pred).all()
    assert _rel_err(pred, pred_want) <= BF16_REL_TOL
