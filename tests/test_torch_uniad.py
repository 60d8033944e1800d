"""The port's UniAD against the JAX package's, on the CPU in f32.

``configs/tiny/uniad_tiny.py``'s model (embed 32, BEV 8x8, 16 track
queries, 12 map queries, 3 cameras, R50 with DCN in stages 3-4, one
latent-render layer) on 2-frame synthetic batches, numpy-seeded weights
carried over with ``state_dict_from_jax``. Held:

* the eval forward (``deterministic``: the planner's collision
  optimisation on) over 3 streamed frames at bs 1: every head's outputs,
  and the tracker's state after each frame (``obj_idxes`` exactly);
* with dropout off on both sides (flax's ``Dropout`` and its attention
  dropout patched out, the port in ``eval()``), the train-time clip
  (``clip_forward``, ``with_masks``) at bs 2, whose samples differ in
  their gt, map and valid plan-step counts (JAX normalises over its one
  global batch), with the port's checkpoints on: its matches, every term
  of ``uniad_clip_loss`` and every parameter gradient (JAX's compiled at
  XLA's default optimisation level);
* one ``UniADTrainStep`` against JAX's ``make_uniad_train_step`` (its loss
  gradient and ``apply_gradients`` on the same optimizer) on that batch.

One module-scoped fixture does all the JAX work: one ``eval_shape`` trace,
a jitted forward and a jitted ``value_and_grad`` of the clip loss, whose
compile runs beside the forward.
"""

import concurrent.futures
import dataclasses
import inspect
import pathlib

import numpy as np
import pytest
import torch

import flax.linen as fnn
import flax.linen.attention as flax_attention
import jax
import jax.numpy as jnp

from vidar_tpu.core.builder import build_model as jax_build_model
from vidar_tpu.core.config import load_config as jax_load_config
from vidar_tpu.data import make_synthetic_batch as jax_synthetic_batch
from vidar_tpu.train.optim import make_optimizer as jax_make_optimizer
from vidar_tpu.train.step import create_train_state
from vidar_tpu.uniad.clip_matcher import FrameGT as JaxFrameGT
from vidar_tpu.uniad.loss import UniADTargets as JaxTargets
from vidar_tpu.uniad.loss import uniad_clip_loss as jax_clip_loss

from vidar_tpu_torch.convert import state_dict_from_jax
from vidar_tpu_torch.core.builder import build_model
from vidar_tpu_torch.core.config import load_config
from vidar_tpu_torch.data import make_synthetic_batch
from vidar_tpu_torch.train import UniADTrainStep, make_optimizer
from vidar_tpu_torch.uniad import UniAD
from vidar_tpu_torch.uniad.clip_matcher import FrameGT
from vidar_tpu_torch.uniad.loss import UniADTargets, uniad_clip_loss

CONFIG = str(pathlib.Path(__file__).resolve().parents[1] / 'configs' /
             'tiny' / 'uniad_tiny.py')
# the same f32 arithmetic in other orders: 1e-4 of the reference's largest
# magnitude (per output, per loss term)
REL_TOL = 1e-4
# gradients: the same sums in other orders through two frames of backbone,
# encoder and heads and back
MIN_GRAD_COSINE = 0.999
SHAPES = dict(bs=1, queue_length=1, future_length=1, num_cams=3, img_h=64,
              img_w=64, max_points=32)
CLIP_SHAPES = dict(SHAPES, bs=2)
# the clip's samples: gt boxes, map elements, valid plan steps
NUM_GT, NUM_MAP, PLAN_STEPS = (5, 3), (3, 1), (6, 4)
# the tracker's birth and death thresholds (RuntimeTracker's defaults)
THRESHOLDS = (0.4, 0.35)
# flax paths of parameters under each of JAX's optimizer labels: the
# backbone (a deformable conv with its offset conv, a conv), frozen (a
# GroupNorm named bn_*), main
OPTIMIZER_LEAVES = (
    ('track', 'img_backbone', 'layer4_0', 'conv2', 'kernel'),
    ('track', 'img_backbone', 'layer4_0', 'conv2', 'conv_offset', 'kernel'),
    ('track', 'img_backbone', 'layer2_0', 'conv1', 'kernel'),
    ('occ_head', 'base_downscale_0', 'bn_skip_proj', 'scale'),
    ('occ_head', 'base_downscale_0', 'bn_skip_proj', 'bias'),
    ('occ_head', 'base_downscale_0', 'abn_down', 'scale'),
    ('planning_head', 'reg_fc1', 'linear', 'kernel'),
    ('track', 'sdc_query'), ('seg_head', 'query_embedding'))


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


def _targets(rng, tc, g=6, gm=4, t_m=4, tp=6, to_=1, hw=(8, 8)):
    """A bs-2 clip's targets as numpy arrays: per sample, instances
    drifting 1 m a frame with consistent ids; the samples' counts of gt
    (the rest of the G slots padding), map elements and valid plan steps
    are ``NUM_GT``, ``NUM_MAP`` and ``PLAN_STEPS``. Every box, padding
    included, has a non-zero size: a zero-size box normalises to -inf,
    which JAX's loss multiplies by its mask into NaN (ROADMAP.md §3)."""
    bs = len(NUM_GT)
    hh, ww = hw
    boxes = np.zeros((bs, g, 9), np.float32)
    boxes[..., :2] = rng.uniform(-20, 20, (bs, g, 2))
    boxes[..., 3:6] = rng.uniform(1, 4, (bs, g, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (bs, g))
    labels = rng.integers(0, 10, (bs, g)).astype(np.int32)
    tb = np.zeros((bs, tc, g, 10), np.float32)
    for t in range(tc):
        b9 = boxes.copy()
        b9[..., 0] += t * 1.0
        tb[:, t] = np.concatenate(
            [b9[..., 0:2], np.log(b9[..., 3:5]), b9[..., 2:3],
             np.log(b9[..., 5:6]), np.sin(b9[..., 6:7]),
             np.cos(b9[..., 6:7]), b9[..., 7:9]], -1)
    num_gt = np.array(NUM_GT, np.int32)
    sdc_mask = (np.arange(tp)[None] < np.array(PLAN_STEPS)[:, None]).astype(
        np.float32)
    return dict(
        gt_boxes=boxes, gt_labels=labels, num_valid_gt=num_gt,
        map_boxes=rng.uniform(0.2, 0.8, (bs, gm, 4)).astype(np.float32),
        map_labels=rng.integers(0, 3, (bs, gm)).astype(np.int32),
        num_valid_map=np.array(NUM_MAP, np.int32),
        gt_traj=rng.normal(size=(bs, g, t_m, 2)).astype(np.float32),
        gt_traj_valid=np.ones((bs, g, t_m), np.float32),
        sdc_traj=rng.normal(size=(bs, tp, 3)).astype(np.float32),
        sdc_mask=sdc_mask,
        gt_occ=(rng.uniform(size=(bs, g, to_, hh, ww)) > 0.7).astype(
            np.float32),
        map_masks=(rng.uniform(size=(bs, gm, hh, ww)) > 0.6).astype(
            np.float32),
        track_boxes=tb, track_labels=np.repeat(labels[:, None], tc, 1),
        track_ids=np.tile(np.arange(g, dtype=np.int32) + 100, (bs, tc, 1)),
        track_num=np.repeat(num_gt[:, None], tc, 1),
        l2g_r=np.tile(np.eye(3, dtype=np.float32), (bs, tc, 1, 1)),
        l2g_t=np.zeros((bs, tc, 3), np.float32),
        timestamp=np.tile(np.arange(tc, dtype=np.float32) * 0.5, (bs, 1)))


def _stream_frames(frames, k):
    """Streamed frame k as numpy fields: other current images, a moved and
    turned ego."""
    f = {n: np.array(getattr(frames, n)) for n in (
        'images', 'can_bus', 'shift', 'rotate_angle', 'prev_bev_exists')}
    t = f['images'].shape[1] - 1
    f['images'][:, t] = np.roll(f['images'][:, t], k, axis=1)
    f['can_bus'][:, t, 0] += 2.0 * k
    f['shift'][:, t, 1] = 0.05 * k
    f['rotate_angle'][:, t] = 3.0 * k
    return f


def _no_attention_dropout(*args, **kwargs):
    bound = inspect.signature(_ATTENTION_WEIGHTS).bind(*args, **kwargs)
    bound.arguments['deterministic'] = True
    return _ATTENTION_WEIGHTS(*bound.args, **bound.kwargs)


_ATTENTION_WEIGHTS = flax_attention.dot_product_attention_weights


@pytest.fixture(scope='module')
def run():
    return _jax_side(alongside=_port_side)


def _jax_side(alongside=None):
    """The JAX package's forward over 3 streamed frames, and its clip
    loss, matches and gradients, as numpy; with ``alongside`` (the port's
    side), its results too, computed while XLA compiles the gradient."""
    cfg = load_config(CONFIG)['model']
    jmodel = jax_build_model(jax_load_config(CONFIG)['model'])
    jframes = jax_synthetic_batch(np.random.default_rng(0), **SHAPES)
    jclip = jax_synthetic_batch(np.random.default_rng(0), **CLIP_SHAPES)
    tc = jclip.images.shape[1]
    tnp = _targets(np.random.default_rng(1), tc)
    jt = JaxTargets(**{k: jnp.asarray(v) for k, v in tnp.items()})
    command = np.array([1], np.int32)
    clip_command = np.array([1, 2], np.int32)
    n, c = cfg['bev_h'] * cfg['bev_w'], cfg['embed_dims']
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': key, 'dropout': key, 'aug': key}, jframes, None,
        jnp.zeros((1, n, c)), jnp.zeros((1,), bool), jnp.asarray(command),
        with_masks=True))
    params = _random_params(shapes)

    gt = JaxFrameGT(boxes=jt.track_boxes, labels=jt.track_labels,
                    ids=jt.track_ids, num_valid=jt.track_num)

    def clip_loss(p):
        track_losses, out, matched = jmodel.apply(
            p, jclip, gt, jt.l2g_r, jt.l2g_t, jt.timestamp,
            jnp.asarray(clip_command), deterministic=False, with_masks=True,
            method=jmodel.clip_forward, rngs={'dropout': key, 'aug': key})
        total, losses = jax_clip_loss(track_losses, out, jt, matched,
                                      task_loss_weight=cfg[
                                          'task_loss_weight'])
        return total, (losses, track_losses, matched, out['det'],
                       out['motion']['all_traj_preds'],
                       out['occ']['ins_occ_logits'], out['tracks'])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, '__call__', lambda self, x, **kw: x)
        mp.setattr(flax_attention, 'dot_product_attention_weights',
                   _no_attention_dropout)
        grad_fn = jax.jit(jax.value_and_grad(clip_loss, has_aux=True)).lower(
            params)

    @jax.jit
    def forward(p, frames, tracks, prev_bev, exists):
        return jmodel.apply(p, frames, tracks, prev_bev, exists,
                            jnp.asarray(command))

    # XLA compiles the gradient (the longest step of the file) on a thread
    # of its own while the forward is traced, compiled and run. It compiles
    # at XLA's default optimisation level: under the test configuration's
    # --xla_backend_optimization_level=0 (conftest.py) this gradient
    # differs from the same program un-jitted or compiled at the default
    # level (ROADMAP.md §3), which the port's equals
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        grad_exe = pool.submit(grad_fn.compile, compiler_options=dict(
            xla_backend_optimization_level=3))
        jtracks = jmodel.apply(params, method=lambda m: m.track.init_tracks(
            batch_shape=(1,)))
        prev_bev, jstream = jnp.zeros((1, n, c)), []
        for k in range(3):
            f = _stream_frames(jframes, k)
            f['prev_bev_exists'][:] = k > 0
            frames = jframes.replace(**{n_: jnp.asarray(v)
                                        for n_, v in f.items()})
            out = forward(params, frames, jtracks, prev_bev,
                          jnp.full((1,), k > 0))
            jtracks, prev_bev = out['tracks'], out['bev']
            jstream.append(jax.tree.map(np.asarray, out))
        j = dict(cfg=cfg, tnp=tnp, command=command,
                 clip_command=clip_command,
                 params=jax.tree.map(np.asarray, params))
        port = alongside(j) if alongside else {}
        (jtotal, jaux), jgrads = grad_exe.result()(params)

    j.update(port, **jax.tree.map(np.asarray, dict(
        jframes=jframes, jclip=jclip, jstream=jstream, jtotal=jtotal,
        jaux=jaux, jgrads=jgrads)))
    return j


def _port_side(j):
    """The port on the same inputs and weights."""
    cfg, params, tnp, command = j['cfg'], j['params'], j['tnp'], j['command']
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = build_model(cfg, device='cpu')
        model.load_state_dict(state_dict_from_jax(params), strict=True)
        model.eval()                                  # dropout off
        tframes = make_synthetic_batch(np.random.default_rng(0), **SHAPES,
                                       device='cpu')
        tclip = make_synthetic_batch(np.random.default_rng(0),
                                     **CLIP_SHAPES, device='cpu')
        tt = UniADTargets(**{k: torch.from_numpy(v) for k, v in tnp.items()})
        tcommand = torch.from_numpy(command)
        tclip_command = torch.from_numpy(j['clip_command'])
        tstream = []
        with torch.inference_mode():
            tracks, tprev = model.init_stream(1, 'cpu')
            for k in range(3):
                f = _stream_frames(tframes, k)
                f['prev_bev_exists'][:] = k > 0
                frames = dataclasses.replace(
                    tframes, **{n_: torch.from_numpy(v)
                                for n_, v in f.items()})
                out = model(frames, tracks, tprev, torch.full((1,), k > 0),
                            tcommand)
                tracks, tprev = out['tracks'], out['bev']
                tstream.append(out)
        tgt = FrameGT(boxes=tt.track_boxes, labels=tt.track_labels,
                      ids=tt.track_ids, num_valid=tt.track_num)
        track_losses, tout, matched = model.clip_forward(
            tclip, tgt, tt.l2g_r, tt.l2g_t, tt.timestamp, tclip_command,
            deterministic=False, with_masks=True)
        total, losses = uniad_clip_loss(track_losses, tout, tt, matched,
                                        task_loss_weight=cfg[
                                            'task_loss_weight'])
        total.backward()
    finally:
        torch.set_num_threads(threads)
    return dict(model=model, tframes=tframes, tclip=tclip, tt=tt,
                tclip_command=tclip_command, tstream=tstream, total=total,
                losses=losses, track_losses=track_losses, tout=tout,
                matched=matched)


def _close(got, want, what, tol=REL_TOL):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def test_weights_and_batch_carry_over(run):
    sd = state_dict_from_jax(run['params'])
    assert len(sd) == len(jax.tree_util.tree_leaves(run['params']))
    assert set(sd) == set(run['model'].state_dict())
    for name in ('track.sdc_query', 'seg_head.encoder_0.attn.proj.'
                 'sampling_offsets.weight', 'occ_head.base_downscale_0.'
                 'abn_down.weight', 'motion_head.bev_interaction_2.'
                 'cross_attn.sampling_offsets.weight'):
        assert name in sd, name
    for name in ('images', 'lidar2img', 'can_bus', 'shift', 'rotate_angle'):
        for port, jax_side in (('tframes', 'jframes'), ('tclip', 'jclip')):
            np.testing.assert_array_equal(
                getattr(run[port], name).numpy(),
                np.asarray(getattr(run[jax_side], name)))


@pytest.mark.parametrize('frame', range(3))
def test_streamed_forward_matches_jax(run, frame):
    want, got = run['jstream'][frame], run['tstream'][frame]
    for key in ('all_cls_scores', 'all_bbox_preds', 'query_feats',
                'last_ref_points'):
        _close(got['det'][key], want['det'][key], f'det.{key}')
    for key in ('outputs_classes', 'outputs_coords', 'reference'):
        _close(got['seg'][key], want['seg'][key], f'seg.{key}')
    for key in ('all_traj_scores', 'all_traj_preds', 'traj_query',
                'track_query', 'track_query_pos', 'inter_references'):
        _close(got['motion'][key], want['motion'][key], f'motion.{key}')
    for key in ('mask_preds', 'ins_occ_logits'):
        _close(got['occ'][key], want['occ'][key], f'occ.{key}')
    # the binary occupancy: equal wherever a logit is not at the threshold
    logit = want['occ']['ins_occ_logits']
    prob = 1.0 / (1.0 + np.exp(-logit))
    clear = (np.abs(prob - 0.1) > 1e-4).all(1)
    np.testing.assert_array_equal(got['occ']['seg_out'].numpy()[clear],
                                  want['occ']['seg_out'][clear])
    _close(got['plan']['sdc_traj'], want['plan']['sdc_traj'], 'plan')
    _close(got['bev'], want['bev'], 'bev')
    np.testing.assert_array_equal(got['active'].numpy(), want['active'])
    _close(got['vehicle_mask'], want['vehicle_mask'], 'vehicle_mask')


@pytest.mark.parametrize('frame', range(3))
def test_tracker_state_matches_jax(run, frame):
    want, got = run['jstream'][frame]['tracks'], run['tstream'][frame][
        'tracks']
    scores = np.asarray(want.scores)
    # no score sits at a birth or death threshold, where the sums' order
    # could decide a birth
    assert min(np.abs(scores - th).min() for th in THRESHOLDS) > 1e-3
    for name in ('obj_idxes', 'disappear_time', 'next_obj_id'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      name)
    for name in ('query', 'ref_points', 'scores', 'pred_boxes',
                 'pred_logits', 'memory'):
        _close(getattr(got, name), getattr(want, name), name)
    if frame == 2:
        # the stream gave birth to tracks and carried them
        assert (np.asarray(want.obj_idxes) >= 0).any()


def test_clip_matches_and_track_losses_match_jax(run):
    losses, track_losses, matched = run['jaux'][:3]
    np.testing.assert_array_equal(run['matched'].numpy(),
                                  np.asarray(matched))
    np.testing.assert_array_equal(run['tout']['tracks'].obj_idxes.numpy(),
                                  np.asarray(run['jaux'][6].obj_idxes))
    # every valid gt of the last frame is tracked by exactly one slot
    for m, n in zip(np.asarray(matched), run['tnp']['track_num'][:, -1]):
        assert sorted(m[m >= 0].tolist()) == list(range(int(n)))
    for k in ('loss_cls', 'loss_bbox'):
        _close(run['track_losses'][k], track_losses[k], k)


@pytest.mark.parametrize('term', ['track.loss', 'map.loss', 'motion.loss',
                                  'occ.loss', 'planning.loss', 'total'])
def test_clip_loss_terms_match_jax(run, term):
    if term == 'total':
        _close(run['total'], run['jtotal'], term)
    else:
        _close(run['losses'][term], run['jaux'][0][term], term)
    assert np.isfinite(float(run['jtotal']))


def test_clip_outputs_match_jax(run):
    jdet, jtraj, jocc = run['jaux'][3:6]
    for key in ('all_cls_scores', 'all_bbox_preds'):
        _close(run['tout']['det'][key], jdet[key], key)
    _close(run['tout']['motion']['all_traj_preds'], jtraj, 'traj')
    _close(run['tout']['occ']['ins_occ_logits'], jocc, 'occ')


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_param_grads_match_jax(run):
    want = state_dict_from_jax(run['jgrads'])
    # a sum that is zero in exact arithmetic (a key bias, which the softmax
    # over keys ignores; the memory bank's query at its first refresh,
    # when every memory slot is equal) rounds to this on either side
    floor = 1e-8 * max(float(v.abs().max()) for v in want.values())
    checked, zero = 0, 0
    for name, p in run['model'].named_parameters():
        ref = want[name].numpy()
        got = (np.zeros_like(ref) if p.grad is None
               else p.grad.detach().numpy())
        if np.abs(ref).max() <= floor:
            assert np.abs(got).max() <= floor, name
            zero += 1
            continue
        assert _cosine(got, ref) >= MIN_GRAD_COSINE, (name, _cosine(got,
                                                                    ref))
        checked += 1
    assert checked > 800 and zero > 0, (checked, zero)


def test_train_step_matches_jax(run):
    """``UniADTrainStep`` (dropout off) against JAX's step on the same
    weights and batch. The optimizer on JAX's gradients first: unclipped,
    each leaf's update is its own, against JAX's optimizer on a few leaves
    of each of its labels (the backbone's rate, the decay, a parameter its
    labels freeze; the whole tree takes a minute to trace). Then the step:
    its losses, its gradient norm over the port's parameters, and its
    update against that optimizer's on JAX's gradients. AdamW's first step
    moves a weight by about its rate in the sign of its gradient, so a
    gradient entry at rounding level may flip: that update is held by its
    direction (cosine above 0.99)."""
    params, jgrads, cfg = run['params'], run['jgrads'], run['cfg']
    old = state_dict_from_jax(params)
    grads = state_dict_from_jax(jgrads)

    def fresh():
        model = build_model(cfg, device='cpu')
        model.load_state_dict(old, strict=True)
        return model

    def stepped_on_jax_grads(**kw):
        model = fresh()
        for name, p in model.named_parameters():
            g = grads[name]
            p.grad = g.clone() if float(g.abs().max()) > 0 else None
        make_optimizer(model, device='cpu', **kw).step()
        return dict(model.named_parameters())

    sub_p, sub_g = {}, {}
    for path in OPTIMIZER_LEAVES:
        for tree, src in ((sub_p, params), (sub_g, jgrads)):
            node, leaf = tree.setdefault('params', {}), src['params']
            for k in path[:-1]:
                node, leaf = node.setdefault(k, {}), leaf[k]
            node[path[-1]] = leaf[path[-1]]
    tx, _ = jax_make_optimizer(sub_p, grad_clip_norm=1e30)
    jsub = state_dict_from_jax(create_train_state(sub_p, tx).apply_gradients(
        grads=sub_g).params)
    assert len(jsub) == len(OPTIMIZER_LEAVES)
    params_now = stepped_on_jax_grads(grad_clip_norm=1e30)
    for name, want in jsub.items():
        want = want.numpy().astype(np.float64)
        err = np.abs(params_now[name].detach().numpy() - want).max()
        tol = (1e-4 * np.abs(want - old[name].numpy()).max() +
               2 * np.finfo(np.float32).eps * np.abs(want).max())
        assert err <= tol, (name, err, tol)
    # the occupancy head's bn_skip_proj GroupNorm: JAX's labels freeze it
    # by its name, and it did not move
    for leaf in ('weight', 'bias'):
        name = f'occ_head.base_downscale_0.bn_skip_proj.{leaf}'
        assert name in jsub
        assert bool((params_now[name] == old[name]).all()), name

    model = fresh()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    step = UniADTrainStep(model, make_optimizer(model, device='cpu'),
                          task_loss_weight=cfg['task_loss_weight'],
                          device='cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        metrics = step((run['tclip'], run['tt'], run['tclip_command']))
    finally:
        torch.set_num_threads(threads)
    for k, v in run['jaux'][0].items():
        _close(metrics[k], v, k)
    _close(metrics['loss'], run['jtotal'], 'loss')
    names = [n for n, _ in model.named_parameters()]
    want_norm = np.sqrt(sum(float((grads[n].double() ** 2).sum())
                            for n in names))
    _close(metrics['grad_norm'], want_norm, 'grad_norm', tol=1e-3)
    ref = stepped_on_jax_grads()
    got = dict(model.named_parameters())
    got_upd = np.concatenate([(got[n].detach() - old[n]).numpy().ravel()
                              for n in names])
    want_upd = np.concatenate([(ref[n].detach() - old[n]).numpy().ravel()
                               for n in names])
    assert _cosine(got_upd, want_upd) >= 0.99


def test_entry_points_default_to_the_card(run):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        UniAD(**{k: v for k, v in run['cfg'].items() if k != 'type'})
    with pytest.raises(RuntimeError, match='no CUDA device'):
        UniADTrainStep(run['model'], None)
