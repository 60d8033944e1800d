"""The port's V2-family backbones and their optimizer against the JAX
package's, on the CPU in f32: ``dcnv3_core`` (its plain version against
JAX with stride, dilation and offsets past the border, its forward and
gradients; the msda route, which the card runs on K1/K5, against the plain
version), a tiny ``InternImage``, ``VoVNet('V-39-eSE')``, the layer-decay
multipliers of every parameter name, and one ``make_layer_decay_optimizer``
step against optax."""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp
import optax

from vidar_tpu.models.internimage import InternImage as JaxInternImage
from vidar_tpu.models.vovnet import VoVNet as JaxVoVNet
from vidar_tpu.ops import dcnv3_core as jax_dcnv3_core
from vidar_tpu.train.optim import \
    layer_decay_lr_mult as jax_layer_decay_lr_mult
from vidar_tpu.train.optim import \
    make_layer_decay_optimizer as jax_make_layer_decay_optimizer

from vidar_tpu_torch.convert import state_dict_from_jax
from vidar_tpu_torch.models.internimage import InternImage
from vidar_tpu_torch.models.layers import Dense
from vidar_tpu_torch.models.vovnet import VoVNet
from vidar_tpu_torch.ops.dcnv3 import (_sample_points, dcnv3_core,
                                       dcnv3_core_msda, dcnv3_core_plain)
from vidar_tpu_torch.train import (layer_decay_lr_mult,
                                   make_layer_decay_optimizer)

# f32 sums in other orders; the msda route also rounds the
# (pixel + 0.5) / size round trip of each sample coordinate
TOL = 1e-4
TINY_INTERN = dict(channels=16, depths=(1, 1, 2, 1), groups=(2, 2, 4, 4))
# (kernel, stride, dilation, offset scale in pixels, H, W)
DCN_CASES = {
    'plain': ((3, 3), (1, 1), (1, 1), 2.0, 9, 11),
    'stride2': ((3, 3), (2, 2), (1, 1), 1.0, 12, 10),
    'dilation2': ((3, 3), (1, 1), (2, 2), 1.0, 10, 12),
    'past-border': ((3, 3), (1, 1), (1, 1), 8.0, 7, 9),
}


def _close(got, want, what, tol=TOL):
    if torch.is_tensor(got):
        got = got.detach().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-12), (
        what, err, np.abs(want).max())


def _random_params(shapes, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == 'kernel':
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ('scale', 'gamma1', 'gamma2'):
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _dcn_inputs(case, seed=0):
    kernel, stride, _, scale, h, w = DCN_CASES[case]
    rng = np.random.default_rng(seed)
    groups, gc, b = 2, 4, 2
    k = kernel[0] * kernel[1]
    ho, wo = -(-h // stride[0]), -(-w // stride[1])
    x = rng.standard_normal((b, h, w, groups * gc)).astype(np.float32)
    offset = (rng.standard_normal((b, ho, wo, groups * k * 2)) *
              scale).astype(np.float32)
    mask = rng.standard_normal((b, ho, wo, groups * k)).astype(np.float32)
    return x, offset, mask, groups


@pytest.mark.parametrize('case', sorted(DCN_CASES))
def test_dcnv3_plain_matches_jax(case):
    kernel, stride, dilation = DCN_CASES[case][:3]
    x, offset, mask, groups = _dcn_inputs(case)
    kw = dict(kernel=kernel, stride=stride, dilation=dilation, groups=groups)
    g = np.random.default_rng(1).standard_normal(
        offset.shape[:3] + (x.shape[-1],)).astype(np.float32)

    @jax.jit
    def value_and_vjp(*a):
        out, vjp = jax.vjp(lambda *b: jax_dcnv3_core(*b, **kw), *a)
        return out, vjp(jnp.asarray(g))

    want, want_grads = value_and_vjp(x, offset, mask)
    ins = [torch.from_numpy(a.copy()).requires_grad_() for a in
           (x, offset, mask)]
    got = dcnv3_core_plain(*ins, **kw)
    _close(got, want, case)
    got.backward(torch.from_numpy(g))
    for name, t, w in zip(('x', 'offset', 'mask'), ins, want_grads):
        _close(t.grad, w, f'{case}: d{name}')
    # on a CPU tensor the dispatching entry point is the plain version
    _close(dcnv3_core(*ins, **kw), got.detach().numpy(),
           f'{case}: dcnv3_core', 0.0)


@pytest.mark.parametrize('case', sorted(DCN_CASES))
def test_dcnv3_msda_route_matches_plain(case):
    kernel, stride, dilation = DCN_CASES[case][:3]
    x, offset, mask, groups = _dcn_inputs(case, seed=2)
    kw = dict(kernel=kernel, stride=stride, dilation=dilation, groups=groups)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        offset.shape[:3] + (x.shape[-1],)).astype(np.float32))
    sides = []
    for fn in (dcnv3_core_plain, dcnv3_core_msda):
        ins = [torch.from_numpy(a.copy()).requires_grad_() for a in
               (x, offset, mask)]
        out = fn(*ins, **kw)
        out.backward(g)
        sides.append([out] + [t.grad for t in ins])
    # bilinear sampling has a kink at each integer pixel coordinate: where
    # the (pixel + 0.5) / size round trip moves a sample across one, the
    # routes take the offset's derivative from opposite sides. Such
    # samples (within 1e-3 pixel) are left out of d offset
    sx, sy, _ = _sample_points(torch.from_numpy(offset),
                               torch.from_numpy(mask), kernel, stride,
                               dilation, groups)
    kink = (((sx - sx.round()).abs() < 1e-3) |
            ((sy - sy.round()).abs() < 1e-3))
    keep = ~kink[..., None].expand(*kink.shape, 2).reshape(offset.shape)
    for side in sides:
        side[2] = side[2] * keep
    for name, got, want in zip(('out', 'dx', 'doffset', 'dmask'), sides[1],
                               sides[0]):
        _close(got, want.detach().numpy(), f'{case}: {name}')


@pytest.fixture(scope='module')
def intern():
    x = np.random.default_rng(4).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    jmod = JaxInternImage(**TINY_INTERN)
    params = _random_params(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), x)), seed=5)

    def loss(p):
        outs = jmod.apply(p, x)
        return sum((o * o).sum() for o in outs), outs

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return x, params, want, grads


def test_internimage_matches_jax(intern):
    x, params, want, grads = intern
    model = InternImage(**TINY_INTERN, device='cpu')
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    outs = model(torch.from_numpy(x))
    assert [tuple(o.shape[1:3]) for o in outs] == [(8, 8), (4, 4), (2, 2)]
    for i, (o, w) in enumerate(zip(outs, want)):
        _close(o, w, f'level {i}')
    sum((o * o).sum() for o in outs).backward()
    want_g = state_dict_from_jax(grads)
    for name, p in model.named_parameters():
        _close(p.grad, want_g[name], f'd {name}', 1e-3)


def test_vovnet_matches_jax():
    x = np.random.default_rng(6).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    jmod = JaxVoVNet(spec='V-39-eSE')
    params = _random_params(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), x)), seed=7)
    want = jax.jit(jmod.apply)(params, x)
    model = VoVNet('V-39-eSE', device='cpu')
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    # the frozen BatchNorms are buffers, as ResNet's
    assert 'stem1_bn.scale' in dict(model.named_buffers())
    with torch.inference_mode():
        outs = model(torch.from_numpy(x))
    assert [tuple(o.shape[1:]) for o in outs] == [
        (8, 8, 512), (4, 4, 768), (2, 2, 1024)]
    for i, (o, w) in enumerate(zip(outs, want)):
        _close(o, w, f'stage {i + 1}')


class _Detector(nn.Module):
    """An InternImage under ``img_backbone`` and a head beside it."""

    def __init__(self):
        super().__init__()
        self.img_backbone = InternImage(**TINY_INTERN, device='cpu')
        self.det_head = Dense(16, 4)


def _detector_params(intern):
    head = {'kernel': np.random.default_rng(8).standard_normal(
        (16, 4)).astype(np.float32), 'bias': np.zeros(4, np.float32)}
    return {'img_backbone': intern[1]['params'], 'det_head': head}


def test_layer_decay_multipliers_match_jax(intern):
    depths, rate = TINY_INTERN['depths'], 0.9
    params = _detector_params(intern)
    names = state_dict_from_jax(params)
    paths = ['/'.join(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    assert len(paths) == len(names)
    # the port's names (dotted, leaves renamed) and JAX's paths give one
    # multiplier set, and every stage block keeps its own
    got = sorted(layer_decay_lr_mult(n, depths=depths, decay_rate=rate)
                 for n in names)
    want = sorted(jax_layer_decay_lr_mult(p, depths=depths, decay_rate=rate)
                  for p in paths)
    np.testing.assert_array_equal(got, want)
    for p in paths:
        torch_name = p.replace('/', '.').replace('kernel', 'weight').replace(
            'scale', 'weight')
        assert layer_decay_lr_mult(torch_name, depths=depths,
                                   decay_rate=rate) == \
            jax_layer_decay_lr_mult(p, depths=depths, decay_rate=rate), p


def test_layer_decay_step_matches_optax(intern):
    depths, rate = TINY_INTERN['depths'], 0.9
    params = _detector_params(intern)
    rng = np.random.default_rng(9)
    grads = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 10).astype(np.float32),
        params)
    tx, _ = jax_make_layer_decay_optimizer(params, depths=depths,
                                           decay_rate=rate, total_steps=10,
                                           warmup_iters=2)
    want = state_dict_from_jax(jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(grads, params))
    model = _Detector()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    opt = make_layer_decay_optimizer(model, depths=depths, decay_rate=rate,
                                     total_steps=10, warmup_iters=2,
                                     device='cpu')
    # one group per multiplier, the head's at 1.0
    mults = sorted(g['lr_mult'] for g in opt.param_groups)
    assert len(set(mults)) == len(mults) and mults[-1] == 1.0
    for name, g in state_dict_from_jax(grads).items():
        model.get_parameter(name).grad = g
    norm = opt.step()
    assert float(norm) > opt.grad_clip_norm       # the clip acted
    for name, p in model.named_parameters():
        _close(p, want[name], name, 1e-5)
