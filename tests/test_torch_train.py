"""The port's pre-training step against the JAX package's, on the CPU in f32.

``vidar_dryrun`` with two supervised futures under a fixed frame gate
(1, 0), no grid mask, no Gumbel noise and no dropout on either side (the
JAX dropout is switched off in this test by patching
``flax.linen.Dropout.__call__``; the port's follows ``eval()``), the same
numpy-seeded weights carried over with ``state_dict_from_jax`` and the same
synthetic batch. Held: the loss dict against ``ViDAR.apply(train=True)``,
every parameter gradient against ``jax.grad``, and one ``make_optimizer``
update against optax's on the same gradients. Dropout itself (rate,
train/eval) and the entry points' device rule are tested on their own.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from vidar_tpu.configs import vidar_dryrun
from vidar_tpu.data import make_synthetic_batch as jax_synthetic_batch
from vidar_tpu.models import ViDAR as JaxViDAR
from vidar_tpu.train.optim import make_optimizer as jax_make_optimizer

from vidar_tpu_torch.convert import state_dict_from_jax
from vidar_tpu_torch.data import make_synthetic_batch
from vidar_tpu_torch.models import ViDAR
from vidar_tpu_torch.models.grid_mask import grid_mask
from vidar_tpu_torch.models.layers import DROPOUT, FFN
from vidar_tpu_torch.train import TrainStep, make_optimizer

SHAPES = dict(bs=1, queue_length=2, future_length=2, num_cams=3, img_h=64,
              img_w=64, max_points=128)
GATE = (1.0, 0.0)
# losses and gradients: the same f32 arithmetic in other orders through
# ~50 conv layers, the BEV recurrence, the rollout and the ray sums, and
# back; 1e-3 of the reference's largest magnitude (per loss, per parameter
# tensor), as in test_torch_vidar.py
REL_TOL = 1e-3
# one optimizer update from identical gradients: the new parameters agree
# to 1e-4 of the update (the moments' f32 rounding) plus two f32 roundings
# of the parameter itself
UPDATE_TOL = 1e-4
F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture
def one_thread():
    """PyTorch on one thread: several test workers share the machine, and
    one thread per core in each of them slows every one of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_params(shapes, seed=0):
    """Numpy-seeded weights with unit-scale activations: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1), biases N(0, 0.1),
    embeddings N(0, 1)."""
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


@pytest.fixture(scope='module')
def run():
    cfg = vidar_dryrun(future_pred_frame_num=2, use_grid_mask=False)
    jmodel = JaxViDAR(**cfg)
    jbatch = jax_synthetic_batch(np.random.default_rng(0), **SHAPES)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': key, 'dropout': key}, jbatch, train=False))
    # seed 1: with seed 0 (gradient taken op by op, under the XLA flags of
    # the repository's conftest.py) JAX's gradient of backbone layer4_1
    # moved by 5e-3 of its size against 3e-6 under default flags: a sample
    # within rounding of a jump of the bilinear gradient
    params = _random_params(shapes, seed=1)

    def loss_fn(p):
        losses, _ = jmodel.apply(p, jbatch, train=True,
                                 rngs={'dropout': key}, gumbel_rng=None,
                                 train_frame_gate=jnp.asarray(GATE))
        return sum(jax.tree.leaves(losses)), losses

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, '__call__', lambda self, x, **kw: x)
        (_, jlosses), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)

    model = ViDAR(**cfg, device='cpu')
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.eval()                                   # dropout off
    batch = make_synthetic_batch(np.random.default_rng(0), **SHAPES,
                                 device='cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)                       # as one_thread does
    try:
        losses = model(batch, gumbel_generator=None, train_frame_gate=GATE)
        sum(losses.values()).backward()
    finally:
        torch.set_num_threads(threads)
    return dict(cfg=cfg, params=params, jlosses=jlosses, jgrads=jgrads,
                model=model, losses=losses, batch=batch)


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def test_losses_match_jax(run):
    jl, tl = run['jlosses'], run['losses']
    assert set(tl) == set(jl)
    assert 'frame.1.loss.dense_voxel.loss' in tl
    for k in sorted(jl):
        _close(tl[k].detach(), jl[k], REL_TOL, k)


def test_param_grads_match_jax(run):
    want = state_dict_from_jax(run['jgrads'])
    zero, checked = 0, 0
    for name, p in run['model'].named_parameters():
        ref = want[name].numpy()
        got = (p.grad if p.grad is not None else torch.zeros_like(p))
        if not np.abs(ref).max() > 0:
            # frozen stages, and the decoder's second future under gate 0
            assert p.grad is None or float(p.grad.abs().max()) == 0, name
            zero += 1
            continue
        _close(got.detach(), ref, REL_TOL, name)
        checked += 1
    assert checked > 100 and zero > 0, (checked, zero)
    # the stem and stage 1 are cut off by frozen_stages=1
    model = run['model']
    assert model.img_backbone.conv1.weight.grad is None
    assert model.img_backbone.layer1_0.conv1.weight.grad is None
    assert model.img_backbone.layer2_0.conv1.weight.grad is not None


def test_optimizer_update_matches_optax(run):
    params, jgrads = run['params'], run['jgrads']
    tx, _ = jax_make_optimizer(params)

    @jax.jit
    def update(g, p):
        return optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])

    jnew = state_dict_from_jax(update(jgrads, params))
    jold = state_dict_from_jax(params)

    cfg = run['cfg']
    model = ViDAR(**cfg, device='cpu')
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    grads = state_dict_from_jax(jgrads)
    for name, p in model.named_parameters():
        # an all-zero gradient stays None, as autograd leaves a cut-off
        # weight: it must still decay
        g = grads[name]
        p.grad = g.clone() if float(g.abs().max()) > 0 else None
    opt = make_optimizer(model, device='cpu')
    norm = opt.step()
    # the frozen BatchNorms are buffers in the port: their JAX gradients
    # (which optax's norm counts) are not the port's
    want_norm = np.sqrt(sum(float((grads[n] ** 2).sum())
                            for n, _ in model.named_parameters()))
    _close(norm, want_norm, 1e-5, 'global norm')
    assert want_norm < 35.0       # below the clip: the updates must agree
    for name, p in model.named_parameters():
        want = jnew[name].numpy().astype(np.float64)
        old = jold[name].numpy()
        err = np.abs(p.detach().numpy() - want).max()
        tol = (UPDATE_TOL * np.abs(want - old).max() +
               2 * F32_EPS * np.abs(old).max())
        assert err <= tol, (name, err, tol)
    stem = dict(model.named_parameters())['img_backbone.conv1.weight']
    assert float((stem.detach() - jold['img_backbone.conv1.weight'])
                 .abs().max()) > 0, 'a frozen-stage weight did not decay'


def test_train_step_updates_and_reports(one_thread):
    model = ViDAR(**vidar_dryrun(), device='cpu')
    model.randomize_(torch.Generator().manual_seed(0), 0.05)
    batch = make_synthetic_batch(np.random.default_rng(1), **SHAPES,
                                 device='cpu')
    before = [p.detach().clone() for p in model.parameters()]
    step = TrainStep(model, make_optimizer(model, device='cpu'),
                     supervise_all_future=False,
                     generator=torch.Generator().manual_seed(2),
                     device='cpu')
    metrics = step(batch)
    assert model.training
    assert np.isfinite(metrics['loss']) and metrics['grad_norm'] > 0
    assert metrics['sca_overflow'] >= 0
    assert metrics['loss'] == pytest.approx(sum(
        v for k, v in metrics.items() if k.startswith('frame.')), rel=1e-6)
    moved = sum(bool((p.detach() != q).any())
                for p, q in zip(model.parameters(), before))
    assert moved == len(before)


def test_dropout_rate_and_mode():
    torch.manual_seed(0)
    ffn = FFN(64, 32, device='cpu')
    for p in ffn.parameters():
        torch.nn.init.normal_(p)
    x = torch.randn(4000, 32)
    ffn.eval()
    with torch.no_grad():
        ref = ffn(x)
        assert torch.equal(ffn(x), ref)
        drop = ffn.drop.train()
        kept = (drop(torch.ones(100_000)) != 0).float().mean().item()
        assert abs(kept - (1 - DROPOUT)) < 0.01
        ffn.train()
        assert not torch.equal(ffn(x), ref)


def test_grid_mask_keeps_the_bars():
    images = torch.ones(2, 40, 48, 3)
    out = grid_mask(torch.Generator().manual_seed(3), images, prob=1.0)
    assert out.shape == images.shape
    kept = out[0, :, :, 0]
    assert 0 < float(kept.mean()) < 1
    # one mask for every image and channel; rows kept whole form the bars
    assert torch.equal(out[0], out[1])
    assert torch.equal(grid_mask(torch.Generator().manual_seed(3), images,
                                 prob=0.0), images)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ViDAR(**vidar_dryrun())
    with pytest.raises(RuntimeError, match='no CUDA device'):
        make_synthetic_batch(np.random.default_rng(0), **SHAPES)
    model = ViDAR(**vidar_dryrun(), device='cpu')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        make_optimizer(model)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TrainStep(model, make_optimizer(model, device='cpu'))


def test_optimizer_clips_like_optax():
    """Above the clip norm (35), over two steps: optax's ``g * 35 / norm``,
    the bias correction at counts 1 and 2, the schedule at steps 0 and 1,
    and the backbone group's lr x 0.1."""
    rng = np.random.default_rng(5)
    w = {'a': rng.normal(size=(4, 3)), 'img_backbone': {'b': rng.normal(
        size=(5,))}}
    w = jax.tree.map(lambda x: np.asarray(x, np.float32), w)
    grads = [jax.tree.map(lambda x: np.asarray(
        rng.normal(size=x.shape) * 30, np.float32), w) for _ in range(2)]
    tx, _ = jax_make_optimizer(w, warmup_iters=2)

    @jax.jit
    def update(g, state, p):
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state

    state, jw = tx.init(w), w
    for g in grads:
        jw, state = update(g, state, jw)

    model = torch.nn.Module()
    model.a = torch.nn.Parameter(torch.from_numpy(w['a'].copy()))
    model.img_backbone = torch.nn.Module()
    model.img_backbone.b = torch.nn.Parameter(
        torch.from_numpy(w['img_backbone']['b'].copy()))
    opt = make_optimizer(model, warmup_iters=2, device='cpu')
    for g in grads:
        model.a.grad = torch.from_numpy(g['a'].copy())
        model.img_backbone.b.grad = torch.from_numpy(
            g['img_backbone']['b'].copy())
        norm = opt.step()
        assert float(norm) > 35.0
    for got, want, old in ((model.a, jw['a'], w['a']),
                           (model.img_backbone.b, jw['img_backbone']['b'],
                            w['img_backbone']['b'])):
        err = np.abs(got.detach().numpy() - np.asarray(want)).max()
        tol = (UPDATE_TOL * np.abs(np.asarray(want) - old).max() +
               2 * F32_EPS * np.abs(old).max())
        assert err <= tol, (err, tol)
