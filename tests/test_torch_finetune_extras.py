"""The rest of the fine-tune against the JAX package, on the CPU in f32:
``auction_assign`` (and ``hungarian_assign``'s ``impl``),
``BEVFormerHeadGroupDETR``, ``label_smoothing_loss`` and the video-replay
train step (``train/video_runner.py``); and the detection eval of the bf16
``BEVFormerFP16``.

The heads and models take the same numpy-seeded weights on both sides,
carried over with ``state_dict_from_jax``. The auction on the card is a
card test (``tests/test_torch_cuda_kernels.py``). The video step's one JAX
compile is module-scoped; both sides decode the dense loss at the argmax
(JAX's Gumbel draw is patched to take no noise: the two packages' random
streams differ), and neither runs dropout (JAX's step is deterministic).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.optimize import linear_sum_assignment

from vidar_tpu.core import bbox as jax_bbox
from vidar_tpu.data import make_synthetic_batch as jax_synthetic_batch
from vidar_tpu.models import ViDAR as JaxViDAR
from vidar_tpu.models import ray_loss as jax_ray_loss
from vidar_tpu.models.detection import \
    BEVFormerHeadGroupDETR as JaxGroupDETR
from vidar_tpu.train.losses import \
    label_smoothing_loss as jax_label_smoothing
from vidar_tpu.train.optim import make_optimizer as jax_make_optimizer
from vidar_tpu.train.step import create_train_state
from vidar_tpu.train.video_runner import \
    make_video_train_step as jax_video_step

from vidar_tpu_torch.configs import vidar_finetune_tiny
from vidar_tpu_torch.convert import state_dict_from_jax
from vidar_tpu_torch.core import bbox
from vidar_tpu_torch.core.config import load_config
from vidar_tpu_torch.data import (make_synthetic_batch,
                                  make_synthetic_det_batch)
from vidar_tpu_torch.evals.det_runner import DetectionRunner
from vidar_tpu_torch.models import BEVFormerFP16, ViDAR
from vidar_tpu_torch.models.detection import BEVFormerHeadGroupDETR
from vidar_tpu_torch.train import make_optimizer
from vidar_tpu_torch.train.losses import label_smoothing_loss
from vidar_tpu_torch.train.video_runner import make_video_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = str(ROOT / 'configs' / 'tiny' / 'vidar_tiny.py')
# the head alone: six decoder layers at width 32 and 16 BEV cells, f32
# sums in other orders; the loss to rel 1e-5 of itself
HEAD_RTOL = 1e-5
# label smoothing: one log-softmax and a weighted sum of 5 x 7 terms
SMOOTH_TOL = 1e-6
# the video step: losses to 1e-4 of each (the same f32 arithmetic in other
# orders through ~50 conv layers, the BEV encoder and the ray sums), and
# the updates at cosine 0.9999
VIDEO_LOSS_RTOL = 1e-4
VIDEO_MIN_COSINE = 0.9999


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


# ---------------------------------------------------------------- auction

def _costs():
    """(name, cost [Q, G] f32, num_valid_gt): uniform costs; costs whose
    GTs all prefer the same few queries (many rounds, displaced owners);
    integer costs (ties in the bids and the best queries); no valid GT;
    the fine-tune's shape with padded columns."""
    rng = np.random.default_rng(0)
    crowded = (rng.uniform(0, 1, (30, 12)) +
               np.where(np.arange(30) < 3, 0.0, 5.0)[:, None])
    padded = rng.uniform(0, 10, (900, 16))
    padded[:, 11:] = 1e8
    return [('uniform', rng.uniform(0, 10, (40, 7)), 7),
            ('crowded', crowded, 12),
            ('ties', np.round(rng.uniform(0, 4, (25, 10))), 10),
            ('partial', rng.uniform(0, 10, (20, 9)), 5),
            ('none', rng.uniform(0, 10, (10, 4)), 0),
            ('padded', padded, 11)]


@pytest.mark.parametrize('case', [c[0] for c in _costs()])
def test_auction_owners_equal_jax_and_cost_near_scipy(case):
    _, cost, n = next(c for c in _costs() if c[0] == case)
    cost = cost.astype(np.float32)
    want = np.asarray(jax_bbox.auction_assign(jnp.asarray(cost),
                                              jnp.asarray(n)))
    got, iters = bbox.auction_assign(torch.from_numpy(cost), n,
                                     return_iters=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert iters < 512
    assigned = got[got >= 0].numpy()
    assert sorted(assigned.tolist()) == list(range(n))
    if n:
        rows, cols = linear_sum_assignment(cost[:, :n])
        opt = float(cost[rows, cols].astype(np.float64).sum())
        total = float(sum(cost[q, g] for q, g in enumerate(got.tolist())
                          if g >= 0))
        span = max(float(cost.max() - cost.min()), 1.0)
        assert total <= opt + n * span * 1e-3 + 1e-3 * abs(opt), (total, opt)
    via = bbox.hungarian_assign(torch.from_numpy(cost), n, impl='auction')
    assert torch.equal(via, got)


def test_hungarian_impls():
    cost = np.random.default_rng(1).uniform(0, 1, (12, 5)).astype(np.float32)
    c = torch.from_numpy(cost)
    exact = bbox.hungarian_assign(c, 4, impl='scipy')
    assert torch.equal(bbox.hungarian_assign(c, 4), exact)  # 'auto'
    np.testing.assert_array_equal(
        exact.numpy(), np.asarray(jax_bbox._lap_host(cost, np.int32(4))))
    with pytest.raises(ValueError):
        bbox.hungarian_assign(c, 4, impl='lap')


# -------------------------------------------------------------- GroupDETR

def test_group_detr_head_matches_jax():
    kw = dict(num_classes=10, num_query=32, embed_dims=32, bev_h=4, bev_w=4)
    jhead = JaxGroupDETR(group_detr=2, **kw)
    rng = np.random.default_rng(3)
    bev = rng.standard_normal((1, 16, 32)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0),
                                               jnp.asarray(bev)))
    params = _random_params(shapes, seed=4)
    gt = np.zeros((1, 6, 9), np.float32)
    gt[0, :4, :2] = rng.uniform(-40, 40, (4, 2))
    gt[0, :, 3:6] = rng.uniform(0.5, 4.0, (6, 3))
    gt[0, :4, 6] = rng.uniform(-3, 3, 4)
    labels = np.array([[1, 4, 7, 9, 0, 0]], np.int32)
    nv = np.array([4], np.int32)

    @jax.jit
    def jax_side(p, b):
        preds = jhead.apply(p, b)
        losses = jhead.apply(p, preds, jnp.asarray(gt), jnp.asarray(labels),
                             jnp.asarray(nv), method=jhead.loss)
        return preds, losses, jhead.apply(p, preds, method=jhead.get_bboxes)

    jpreds, jlosses, jdet = jax_side(params, jnp.asarray(bev))
    head = BEVFormerHeadGroupDETR(group_detr=2, device='cpu', **kw).eval()
    head.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        preds = head(torch.from_numpy(bev))
        losses = head.loss(preds, torch.from_numpy(gt),
                           torch.from_numpy(labels), torch.from_numpy(nv))
        det = head.get_bboxes(preds)
    for k in ('all_cls_scores', 'all_bbox_preds'):
        want = np.asarray(jpreds[k])
        assert np.abs(preds[k].numpy() - want).max() <= \
            HEAD_RTOL * np.abs(want).max(), k
    assert set(losses) == set(jlosses) and 'd0.loss_cls' in losses
    for k, v in jlosses.items():
        assert float(losses[k]) == pytest.approx(float(v), rel=HEAD_RTOL), k
    # the first group's 16 queries x 10 classes, all decoded
    assert det['bboxes'].shape == (1, 160, 9)
    np.testing.assert_array_equal(det['labels'].numpy(),
                                  np.asarray(jdet['labels']))
    for k in ('scores', 'bboxes'):
        want = np.asarray(jdet[k])
        assert np.abs(det[k].numpy() - want).max() <= \
            HEAD_RTOL * np.abs(want).max(), k


def test_detection_runner_takes_a_bf16_model():
    """``BEVFormerFP16`` decodes bf16 boxes and scores; the eval runner
    hands them on as f32 numpy arrays (numpy has no bf16), window and
    streaming."""
    model = BEVFormerFP16(**vidar_finetune_tiny(), device='cpu').eval()
    model.randomize_(torch.Generator().manual_seed(0), 0.05)
    batch = make_synthetic_det_batch(np.random.default_rng(0), device='cpu')
    for streaming in (False, True):
        runner = DetectionRunner(model, streaming=streaming, device='cpu')
        meta = dict(can_bus=np.zeros(18), scene_token='s',
                    l2g_rot=np.eye(3)) if streaming else None
        pred, gt = runner(batch, meta)
        assert pred['boxes'].dtype == pred['scores'].dtype == np.float32
        assert len(gt['boxes']) == 3


# --------------------------------------------------------- label smoothing

@pytest.mark.parametrize('weighted', [False, True])
def test_label_smoothing_matches_jax(weighted):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((5, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, 5).astype(np.int32)
    w = rng.uniform(0, 2, 5).astype(np.float32) if weighted else None
    want = float(jax_label_smoothing(
        jnp.asarray(logits), jnp.asarray(labels), 0.2,
        None if w is None else jnp.asarray(w)))
    got = float(label_smoothing_loss(
        torch.from_numpy(logits), torch.from_numpy(labels), 0.2,
        None if w is None else torch.from_numpy(w)))
    assert abs(got - want) <= SMOOTH_TOL * max(abs(want), 1.0)


# --------------------------------------------------------- the video step

SHAPES = dict(bs=1, queue_length=1, future_length=1, num_cams=3, img_h=64,
              img_w=64, max_points=128)


@pytest.fixture(scope='module')
def video():
    m = dict(load_config(TINY)['model'])
    m.pop('type')
    jmodel = JaxViDAR(**m)
    jbatch = jax_synthetic_batch(np.random.default_rng(0), **SHAPES)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': key, 'dropout': key}, jbatch, train=False))
    params = _random_params(shapes, seed=2)
    tx, _ = jax_make_optimizer(params)
    gumbel = jax_ray_loss.gumbel_softmax_distance
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ray_loss, 'gumbel_softmax_distance',
                   lambda feats, lengths, rng: gumbel(feats, lengths, None))
        new_state, jmetrics = jax_video_step(jmodel, tx)(
            create_train_state(params, tx), jbatch, key)
    jax.block_until_ready(new_state)
    return dict(m=m, params=params, jnew=new_state.params,
                jmetrics={k: float(v) for k, v in jmetrics.items()})


def _port_video_step(video, eval_params=None):
    model = ViDAR(**video['m'], device='cpu')
    model.load_state_dict(state_dict_from_jax(video['params']), strict=True)
    step = make_video_train_step(model, make_optimizer(model, device='cpu'),
                                 device='cpu')
    batch = make_synthetic_batch(np.random.default_rng(0), **SHAPES,
                                 device='cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        metrics = step(batch, eval_params=eval_params)
    finally:
        torch.set_num_threads(threads)
    return model, metrics


@pytest.fixture(scope='module')
def port_video(video):
    return _port_video_step(video)


def test_video_train_step_matches_jax(video, port_video):
    model, metrics = port_video
    jm = video['jmetrics']
    assert set(metrics) == set(jm) | {'grad_norm'}
    for k, v in jm.items():
        assert abs(metrics[k] - v) <= VIDEO_LOSS_RTOL * max(abs(v), 1e-6), k
    old = state_dict_from_jax(video['params'])
    new = state_dict_from_jax(video['jnew'])
    got, want = [], []
    for name, p in model.named_parameters():
        got.append((p.detach() - old[name]).reshape(-1).double())
        want.append((new[name] - old[name]).reshape(-1).double())
    got, want = torch.cat(got), torch.cat(want)
    cos = float(got @ want / (got.norm() * want.norm()))
    assert cos >= VIDEO_MIN_COSINE, cos
    assert float(want.abs().max()) > 0


def test_video_train_step_replays_with_eval_params(video, port_video):
    """History replayed by other weights changes the step's loss, and the
    model keeps its own weights: it takes the same update from them."""
    sd = state_dict_from_jax(video['params'])
    frozen = {k: v * 0.5 if k.startswith('pts_bbox_head.') else v
              for k, v in sd.items()}
    model, metrics = _port_video_step(video, eval_params=frozen)
    assert metrics['loss'] != pytest.approx(port_video[1]['loss'], rel=1e-3)
    head = 'pts_bbox_head.'
    for (name, p), q in zip(model.named_parameters(),
                            port_video[0].parameters()):
        if not name.startswith(head):
            continue
        # the update moved it from the original weights, not the halved
        assert float((p.detach() - sd[name]).abs().max()) < \
            float((p.detach() - frozen[name]).abs().max()) or \
            float(sd[name].abs().max()) == 0, name
