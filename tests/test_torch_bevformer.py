"""The port's BEVFormer detection fine-tune against the JAX package's, on the
CPU in f32.

The fine-tune smoke's ``TINY`` config and batch (tests/e2e/
test_finetune_smoke.py:16-48), without the grid mask, the same
numpy-seeded weights carried over with ``state_dict_from_jax``. Held: the
eval forward and its NMS-free decode, two streaming frames that carry the
``StreamState``, and, dropout off on both sides (flax's ``Dropout`` patched
out, the port in ``eval()``), the train forward's Hungarian assignment,
losses and parameter gradients. One module-scoped fixture does all the JAX
work: one init trace and three jitted functions.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from vidar_tpu.core import bbox as jax_bbox
from vidar_tpu.models import BEVFormer as JaxBEVFormer
from vidar_tpu.models.bevformer import StreamState as JaxStreamState

from vidar_tpu_torch import configs
from vidar_tpu_torch.convert import state_dict_from_jax
from vidar_tpu_torch.core import bbox
from vidar_tpu_torch.data import make_synthetic_det_batch
from vidar_tpu_torch.evals.det_runner import DetectionRunner
from vidar_tpu_torch.models import BEVFormer, BEVFormerFP16
from vidar_tpu_torch.models.layers import MultiHeadDotProductAttention
from vidar_tpu_torch.train import DetTrainStep, make_optimizer

SMOKE = pathlib.Path(__file__).resolve().parent / 'e2e' / \
    'test_finetune_smoke.py'
# the same f32 arithmetic in other orders through ~50 conv layers, the BEV
# recurrence and the decoder, and back: 1e-3 of the reference's largest
# magnitude, as tests/test_torch_vidar.py
REL_TOL = 1e-3


@pytest.fixture
def one_thread():
    """PyTorch on one thread, as in test_torch_train.py: several test
    workers share the machine, and one thread per core in each of them
    slows every one of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke():
    spec = importlib.util.spec_from_file_location('finetune_smoke', SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def _second_frame(frames, lib):
    """The next streamed frame: another current image and a moved ego."""
    t = frames.images.shape[1] - 1
    if lib is jnp:
        return frames.replace(
            images=frames.images[:, ::-1],
            can_bus=frames.can_bus.at[:, t, 0].set(3.0),
            shift=frames.shift.at[:, t, 1].set(0.05),
            rotate_angle=frames.rotate_angle.at[:, t].set(4.0))
    import dataclasses
    can_bus, shift, angle = (frames.can_bus.clone(), frames.shift.clone(),
                             frames.rotate_angle.clone())
    can_bus[:, t, 0], shift[:, t, 1], angle[:, t] = 3.0, 0.05, 4.0
    return dataclasses.replace(frames, images=frames.images.flip(1),
                               can_bus=can_bus, shift=shift,
                               rotate_angle=angle)


@pytest.fixture(scope='module')
def run():
    smoke = _smoke()
    cfg = configs.vidar_finetune_tiny(use_grid_mask=False)
    # the preset builds the smoke's TINY model
    assert JaxBEVFormer(**cfg) == JaxBEVFormer(**smoke.TINY,
                                               use_grid_mask=False)
    jbatch = smoke.make_det_batch(np.random.default_rng(0))
    jmodel = JaxBEVFormer(**cfg)
    key = jax.random.PRNGKey(0)
    n, c = cfg['bev_h'] * cfg['bev_w'], cfg['embed_dims']
    state = JaxStreamState(prev_bev=jnp.zeros((1, n, c)),
                           has_prev=jnp.zeros((1,), bool))
    # a streamed frame calls every module once: the full window's
    # parameters from a third of its trace
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': key}, jbatch.frames, state,
        method=jmodel.streaming_test))
    params = _random_params(shapes)

    @jax.jit
    def evaluate(p, frames):
        preds = jmodel.apply(p, frames, train=False)
        return preds, jmodel.apply(p, preds, method=jmodel.get_bboxes)

    @jax.jit
    def stream(p, frames, state):
        return jmodel.apply(p, frames, state, method=jmodel.streaming_test)

    def loss_fn(p):
        preds = jmodel.apply(p, jbatch.frames, train=True,
                             rngs={'dropout': key, 'aug': key})
        losses = jmodel.apply(p, preds, jbatch.gt_bboxes, jbatch.gt_labels,
                              jbatch.num_valid_gt, method=jmodel.loss)
        return sum(jax.tree.leaves(losses)), (losses, preds)

    jpreds, jdet = evaluate(params, jbatch.frames)
    jstream = []
    for frames in (jbatch.frames, _second_frame(jbatch.frames, jnp)):
        preds, state = stream(params, frames, state)
        jstream.append((preds, state))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, '__call__', lambda self, x, **kw: x)
        (_, (jlosses, jtrain)), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)

    model = BEVFormer(**cfg, device='cpu')
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.eval()                                   # dropout off
    tbatch = make_synthetic_det_batch(np.random.default_rng(0),
                                      device='cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)                       # as one_thread does
    try:
        with torch.inference_mode():
            tpreds = model(tbatch.frames, train=False)
            tdet = model.get_bboxes(tpreds)
            tstate = model.init_stream(1, 'cpu')
            tstream = []
            for frames in (tbatch.frames,
                           _second_frame(tbatch.frames, torch)):
                preds, tstate = model.streaming_test(frames, tstate)
                tstream.append((preds, tstate))
        train_preds = model(tbatch.frames, train=True)
        losses = model.loss(train_preds, tbatch.gt_bboxes, tbatch.gt_labels,
                            tbatch.num_valid_gt)
        sum(losses.values()).backward()
    finally:
        torch.set_num_threads(threads)
    return dict(cfg=cfg, params=params, jbatch=jbatch, jpreds=jpreds,
                jdet=jdet, jstream=jstream, jlosses=jlosses, jtrain=jtrain,
                jgrads=jgrads, model=model, tbatch=tbatch, tpreds=tpreds,
                tdet=tdet, tstream=tstream, train_preds=train_preds,
                losses=losses)


def _close(got, want, what, tol=REL_TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def test_batch_and_weights_carry_over(run):
    jb, tb = run['jbatch'], run['tbatch']
    for name in ('images', 'lidar2img', 'can_bus', 'shift', 'rotate_angle',
                 'prev_bev_exists'):
        np.testing.assert_array_equal(getattr(tb.frames, name).numpy(),
                                      np.asarray(getattr(jb.frames, name)))
    for name in ('gt_bboxes', 'gt_labels', 'num_valid_gt'):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    sd = state_dict_from_jax(run['params'])
    assert len(sd) == len(jax.tree_util.tree_leaves(run['params']))
    assert set(sd) == set(run['model'].state_dict())
    assert 'pts_bbox_head_det.layers_0.self_attn.key.weight' in sd


def test_eval_matches_jax(run):
    for key in ('all_cls_scores', 'all_bbox_preds'):
        _close(run['tpreds'][key], run['jpreds'][key], key)


def test_get_bboxes_matches_jax(run):
    got, want = run['tdet'], run['jdet']
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(want['labels']))
    np.testing.assert_array_equal(got['valid'].numpy(),
                                  np.asarray(want['valid']))
    _close(got['scores'], want['scores'], 'scores')
    _close(got['bboxes'], want['bboxes'], 'bboxes')


def test_streaming_frames_match_jax(run):
    for i, ((tp, ts), (jp, js)) in enumerate(zip(run['tstream'],
                                                 run['jstream'])):
        for key in ('all_cls_scores', 'all_bbox_preds'):
            _close(tp[key], jp[key], f'frame {i}: {key}')
        _close(ts.prev_bev, js.prev_bev, f'frame {i}: carried BEV')
        assert bool(ts.has_prev.all()) and bool(np.asarray(js.has_prev).all())
    # the second frame used the carried BEV: it differs from a fresh start
    assert not np.allclose(run['tstream'][1][1].prev_bev.numpy(),
                           run['tstream'][0][1].prev_bev.numpy())


def test_losses_and_assignment_match_jax(run):
    jl, tl = run['jlosses'], run['losses']
    assert set(tl) == set(jl) and 'd0.loss_cls' in tl
    for k in sorted(jl):
        _close(tl[k].detach(), jl[k], k)
    # the Hungarian match of every decoder layer, JAX's own functions on
    # JAX's predictions against the port's on the port's
    jb, tb, head = run['jbatch'], run['tbatch'], run['model'].pts_bbox_head_det
    n_valid = int(jb.num_valid_gt[0])

    @jax.jit
    def costs(cls_s, bbox_p):
        """Every decoder layer's matching cost [L, Q, G], as the JAX head
        builds it for the first sample."""
        gt_norm = jax_bbox.normalize_bbox(jb.gt_bboxes)[0]
        cost = jax.vmap(lambda c, b: jax_bbox.focal_loss_cost(
            c, jb.gt_labels[0]) + jax_bbox.bbox3d_l1_cost(b, gt_norm))(
                cls_s, bbox_p)
        g = gt_norm.shape[0]
        return jnp.where(jnp.arange(g)[None, None] >= n_valid, 1e8, cost)

    all_costs = np.asarray(costs(run['jtrain']['all_cls_scores'][:, 0],
                                 run['jtrain']['all_bbox_preds'][:, 0]))
    for lid in range(all_costs.shape[0]):
        want = np.asarray(jax_bbox._lap_host(all_costs[lid], n_valid))
        got = head.assign(
            run['train_preds']['all_cls_scores'][lid],
            run['train_preds']['all_bbox_preds'][lid],
            bbox.normalize_bbox(tb.gt_bboxes), tb.gt_labels, tb.num_valid_gt)
        np.testing.assert_array_equal(got[0].numpy(), want)
        assert (want >= 0).sum() == n_valid


def test_param_grads_match_jax(run):
    want = state_dict_from_jax(run['jgrads'])
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in run['model'].named_parameters()}
    zero, checked = 0, 0
    for name, got in grads.items():
        ref = want[name].numpy()
        if name.endswith('self_attn.key.bias'):
            # zero in exact arithmetic (the softmax over keys ignores a
            # shift shared by all keys): both sides are rounding noise,
            # far below the query bias's gradient
            floor = 1e-5 * np.abs(want[name.replace('key', 'query')]
                                  .numpy()).max()
            assert np.abs(ref).max() <= floor, name
            assert float(got.abs().max()) <= floor, name
            continue
        if not np.abs(ref).max() > 0:
            # the frozen stem and stage 1
            assert float(got.abs().max()) == 0, name
            zero += 1
            continue
        _close(got.detach(), ref, name)
        checked += 1
    assert checked > 300 and zero > 0, (checked, zero)
    model = run['model']
    assert model.img_backbone.conv1.weight.grad is None
    assert model.img_backbone.layer2_0.conv1.weight.grad is not None


def test_mha_matches_flax(one_thread):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, n, 32)).astype(np.float32)
               for n in (5, 7, 7))
    mod = fnn.MultiHeadDotProductAttention(num_heads=8, qkv_features=32,
                                           out_features=32)
    params = _random_params(jax.eval_shape(lambda: mod.init(
        jax.random.PRNGKey(0), q, k, v)), seed=5)
    want = np.asarray(mod.apply(params, q, k, v))
    port = MultiHeadDotProductAttention(32, 8)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = port(*map(torch.from_numpy, (q, k, v))).numpy()
    _close(got, want, 'attention', tol=1e-5)


def test_det_train_step_and_runner(run, one_thread):
    """One ``DetTrainStep`` (grid mask and dropout on) moves every
    parameter outside the frozen stages; ``DetectionRunner`` decodes the
    batch both ways."""
    cfg = dict(run['cfg'], use_grid_mask=True)
    model = BEVFormer(**cfg, device='cpu')
    model.randomize_(torch.Generator().manual_seed(0), 0.05)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = DetTrainStep(model, make_optimizer(model, device='cpu'),
                        generator=torch.Generator().manual_seed(1),
                        device='cpu')
    metrics = step(run['tbatch'])
    assert model.training
    assert np.isfinite(metrics['loss']) and metrics['grad_norm'] > 0
    assert metrics['loss'] == pytest.approx(sum(
        v for k, v in metrics.items() if 'loss_' in k), rel=1e-6)
    moved = [n for n, p in model.named_parameters()
             if bool((p.detach() != before[n]).any())]
    assert len(moved) == len(before)        # frozen weights still decay
    meta = dict(can_bus=np.zeros(18), scene_token='a', l2g_rot=np.eye(3))
    for streaming in (False, True):
        runner = DetectionRunner(model, streaming=streaming, device='cpu')
        pred, gt = runner(run['tbatch'], meta)
        assert pred['boxes'].shape[1:] == (9,) and len(pred['attrs']) == len(
            pred['labels']) == len(pred['scores'])
        assert gt['boxes'].shape == (3, 9)
    # the runner decodes with dropout off and gives the model back as it was
    assert bool(runner.state.has_prev.all()) and model.training


def test_fp16_variant_computes_in_bf16(run, one_thread):
    """``BEVFormerFP16``: the same weights, bf16 compute (the bf16 DCN, K2's
    plain version here), f32 parameters and an f32 BEV carry."""
    model = BEVFormerFP16(**run['cfg'], device='cpu').eval()
    model.load_state_dict(run['model'].state_dict())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.inference_mode():
        preds, state = model.streaming_test(run['tbatch'].frames,
                                            model.init_stream(1, 'cpu'))
    assert preds['all_cls_scores'].dtype == torch.bfloat16
    assert state.prev_bev.dtype == torch.float32
    for key in ('all_cls_scores', 'all_bbox_preds'):
        assert bool(torch.isfinite(preds[key]).all()), key


def test_entry_points_default_to_the_card(run):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        BEVFormer(**run['cfg'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        make_synthetic_det_batch(np.random.default_rng(0))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        DetTrainStep(run['model'], None)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        DetectionRunner(run['model'])
