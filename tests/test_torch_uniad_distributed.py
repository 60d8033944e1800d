"""UniAD across processes on the CPU: two Gloo ranks against the port's own
one-process step on the global batch (no JAX here: tests/test_torch_uniad.py
holds that step to JAX's on a bs-2 batch).

* (i) ``UniADTrainStep`` at ``configs/tiny/uniad_tiny.py`` (its 2-frame
  clip, dropout off, unit-scale weights), one clip sample a rank, against
  ``UniADTrainStep`` at bs 2 in this process: each loss, the gradients
  summed over the ranks and the updated parameters, at 1e-5 of each
  reference's largest magnitude (a loss's; the largest gradient
  element's, each gradient tensor also at 1e-4 of its own, since an
  attention's query and key weights sum in other orders at bs 1 and 2,
  4e-5 of their largest; the largest parameter's, wherever the sign of
  the gradient element is decided). The update is also bit-identical to
  the optimizer on the ranks' summed gradients. The samples differ
  wherever a normaliser counts: sample 0 has no track gt in its first
  frame, the two differ in their valid agents and the ego's valid plan
  steps, and sample 1's map has no element. The per-rank normalised
  losses and gradients (each rank alone, summed or averaged over the
  ranks, as a plain all-reduce or DistributedDataParallel would) miss
  that tolerance.
* (ii) the train CLI (2 steps) and then the test CLI (UniAD's eval of its
  checkpoint) at two ranks on the fake nuScenes dataset: rank 0 returns
  exactly the metrics of the same eval in one process, rank 1 None; rank
  0 alone writes the checkpoints, and the two ranks' trained parameters
  are bit-identical.
* The clip's checkpoints (the backbone camera by camera, every frame's
  BEV encoder) change no loss and no gradient: bit-identical to a run
  whose ``checkpoint`` calls the function straight through.

Both rank groups are one spawn of two worker processes
(tests/_torch_dist_worker.py ``uniad``).
"""

import json
import os

import numpy as np
import pytest
import torch

from tests._torch_dist_spawn import ROOT, _free_port, _spawn, _wait
from tests._torch_dist_worker import uniad_clip_loss_of, uniad_model
from tests.data.fake_nuscenes import make_fake_nuscenes
from vidar_tpu_torch.core.builder import build_model
from vidar_tpu_torch.core.config import load_config
from vidar_tpu_torch.data import make_synthetic_batch
from vidar_tpu_torch.models import vidar as vidar_module
from vidar_tpu_torch.tools import test as test_cli
from vidar_tpu_torch.train import UniADTrainStep, make_optimizer
from vidar_tpu_torch.uniad import uniad as uniad_module
from vidar_tpu_torch.uniad.loss import UniADTargets

CONFIG = str(ROOT / 'configs' / 'tiny' / 'uniad_tiny.py')
# the same f32 arithmetic at bs 1 a rank and bs 2 in one process: of the
# reference's largest magnitude, and of each gradient tensor's own
REL_TOL = 1e-5
TENSOR_TOL = 1e-4
SHAPES = dict(bs=2, queue_length=1, future_length=1, num_cams=3, img_h=64,
              img_w=64, max_points=32)


def _targets(rng, tc, g=6, gm=4, t_m=4, tp=6, to_=1, hw=(8, 8)):
    """The bs-2 clip's targets: per sample, instances drifting 1 m a frame
    with consistent ids; sample 0 without track gt in frame 0, sample 1
    with 2 agents of no valid future step, 3 valid plan steps and no map
    element."""
    bs = 2
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
             np.log(b9[..., 5:6]), np.sin(b9[..., 6:7]), np.cos(b9[..., 6:7]),
             b9[..., 7:9]], -1)
    num_gt = np.array([g - 1, g - 2], np.int32)
    track_num = np.repeat(num_gt[:, None], tc, 1)
    track_num[0, 0] = 0
    traj_valid = np.ones((bs, g, t_m), np.float32)
    traj_valid[1, :2] = 0.0
    sdc_mask = np.ones((bs, tp), np.float32)
    sdc_mask[1, 3:] = 0.0
    arrays = dict(
        gt_boxes=boxes, gt_labels=labels, num_valid_gt=num_gt,
        map_boxes=rng.uniform(0.2, 0.8, (bs, gm, 4)).astype(np.float32),
        map_labels=rng.integers(0, 3, (bs, gm)).astype(np.int32),
        num_valid_map=np.array([gm - 1, 0], np.int32),
        gt_traj=rng.normal(size=(bs, g, t_m, 2)).astype(np.float32),
        gt_traj_valid=traj_valid,
        sdc_traj=rng.normal(size=(bs, tp, 3)).astype(np.float32),
        sdc_mask=sdc_mask,
        gt_occ=(rng.uniform(size=(bs, g, to_, hh, ww)) > 0.7).astype(
            np.float32),
        map_masks=(rng.uniform(size=(bs, gm, hh, ww)) > 0.6).astype(
            np.float32),
        track_boxes=tb, track_labels=np.repeat(labels[:, None], tc, 1),
        track_ids=np.tile(np.arange(g, dtype=np.int32) + 100, (bs, tc, 1)),
        track_num=track_num,
        l2g_r=np.tile(np.eye(3, dtype=np.float32), (bs, tc, 1, 1)),
        l2g_t=np.zeros((bs, tc, 3), np.float32),
        timestamp=np.tile(np.arange(tc, dtype=np.float32) * 0.5, (bs, 1)))
    return UniADTargets(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def _unit_scale(sd, seed=0):
    """Numpy-seeded weights with unit-scale activations, as
    tests/test_torch_uniad.py draws them: matrices and kernels
    N(0, 1/fan_in), norm scales (the frozen BatchNorms' too) 1 + N(0, 0.1),
    biases N(0, 0.1), embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in sd.items():
        leaf = name.rsplit('.', 1)[-1]
        z = rng.standard_normal(tuple(v.shape))
        if leaf == 'kernel':                    # a deformable conv's
            z = z / np.sqrt(v.shape[0])
        elif leaf == 'weight' and v.dim() >= 2:
            z = z / np.sqrt(np.prod(v.shape[1:]))
        elif leaf in ('weight', 'scale'):
            z = 1.0 + 0.1 * z
        elif leaf == 'bias':
            z = 0.1 * z
        out[name] = torch.from_numpy(z.astype(np.float32))
    return out


def _clip_inputs():
    """The tiny model's weights and the bs-2 clip."""
    model = build_model(load_config(CONFIG)['model'], device='cpu')
    frames = make_synthetic_batch(np.random.default_rng(0), **SHAPES,
                                  device='cpu')
    targets = _targets(np.random.default_rng(1), frames.images.shape[1])
    return dict(sd=_unit_scale(model.state_dict()), frames=frames,
                targets=targets,
                command=torch.tensor([1, 2], dtype=torch.int32))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)                 # as the workers
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Both rank groups in one spawn, while this process runs the bs-2
    step; then the test CLI in this process on the checkpoint the ranks
    trained."""
    root = tmp_path_factory.mktemp('uniad_dist')
    inputs = _clip_inputs()
    torch.save(inputs, str(root / 'uniad_inputs.pt'))
    pkl = make_fake_nuscenes(str(root / 'data'), num_samples=8, num_cams=3,
                             img_hw=(32, 64), num_scenes=2)
    data = [f'data.train.ann_file={pkl}', f'data.test.ann_file={pkl}']
    work = str(root / 'work')
    spec = dict(
        train=[CONFIG, '--work-dir', work, '--max-steps', '2', '--device',
               'cpu', '--cfg-options', *data, 'log_interval=1'],
        test=[CONFIG, os.path.join(work, 'latest'), '--max-samples', '4',
              '--device', 'cpu', '--cfg-options', *data])
    spec_file = str(root / 'spec.json')
    with open(spec_file, 'w') as f:
        json.dump(spec, f)
    ports = [str(_free_port()) for _ in range(3)]
    procs = _spawn([['uniad', str(root), str(r), *ports, spec_file]
                    for r in range(2)], [{}, {}], str(root))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = uniad_model(inputs['sd'])
        metrics = UniADTrainStep(
            model, make_optimizer(model, device='cpu'),
            task_loss_weight=model.task_loss_weight, device='cpu')(
                (inputs['frames'], inputs['targets'], inputs['command']))
        ref = (metrics, {n: p.grad for n, p in model.named_parameters()},
               model.state_dict())
    finally:
        _wait(procs, str(root))
    ranks = [torch.load(str(root / f'uniad_rank{r}.pt'), weights_only=False)
             for r in range(2)]
    for name in ('uniad_rank0.pt', 'uniad_rank1.pt', 'uniad_inputs.pt'):
        os.remove(root / name)               # 1.2 GB, read once
    try:
        # the optimizer in this process on the ranks' summed gradients
        model = uniad_model(inputs['sd'])
        for n, p in model.named_parameters():
            p.grad = ranks[0]['step'][1][n]
        make_optimizer(model, device='cpu').step()
        stepped = model.state_dict()
        single = test_cli.main(spec['test'])
    finally:
        torch.set_num_threads(threads)
    return dict(ranks=ranks, ref=ref, stepped=stepped, single=single,
                work=work, old=inputs['sd'])


def _largest(t):
    return float(t.abs().max()) if t is not None else 0.0


def _rel_err(got, want):
    got = np.asarray(torch.as_tensor(got), np.float64)
    want = np.asarray(torch.as_tensor(want), np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_two_ranks_equal_the_global_batch(runs):
    (m0, g0, p0), (m1, g1, p1) = (r['step'] for r in runs['ranks'])
    ref_m, ref_g, ref_p = runs['ref']
    # the ranks agree bit for bit
    assert m0 == m1
    for n in g0:
        assert (g0[n] is None) == (g1[n] is None), n
        assert g0[n] is None or torch.equal(g0[n], g1[n]), n
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
    # the global batch's losses and summed gradients; a gradient zero in
    # exact arithmetic (a key bias, which the softmax over keys ignores)
    # rounds to below this on either side
    assert set(m0) == set(ref_m)
    for k, want in ref_m.items():
        assert abs(m0[k] - want) <= REL_TOL * abs(want), (k, m0[k], want)
    largest = max(_largest(g) for g in ref_g.values())
    floor = 1e-8 * largest
    checked = 0
    for n, want in ref_g.items():
        got = g0[n]
        if _largest(want) <= floor:
            assert _largest(got) <= floor, n
            continue
        err = float((got - want).abs().max())
        assert err <= REL_TOL * largest, (n, err, largest)
        assert err <= TENSOR_TOL * _largest(want), (n, err, _largest(want))
        checked += 1
    assert checked > 800, checked
    # the update: the optimizer's on the summed gradients, and the bs-2
    # step's wherever the sign of a gradient element is decided (AdamW's
    # first step moves a weight by its rate in that sign, so an element
    # within the gradients' tolerance of 0 may move the other way)
    for n, p in runs['stepped'].items():
        assert torch.equal(p0[n], p), n
    biggest = max(_largest(p) for p in ref_p.values())
    for n, want in ref_p.items():
        err = (p0[n] - want).abs()
        g = ref_g.get(n)
        if g is not None:
            err = err * (g.abs() > TENSOR_TOL * _largest(g) + floor)
        assert float(err.max()) <= REL_TOL * biggest, (n, float(err.max()))


def test_per_rank_normalisers_miss_the_tolerance(runs):
    """Each rank's losses and gradients with its own normalisers, summed
    (an all-reduce without the global counts) or averaged (DDP), against
    the bs-2 step."""
    (l0, g0), (l1, g1) = (r['local'] for r in runs['ranks'])
    ref_m, ref_g, _ = runs['ref']
    largest = max(_largest(g) for g in ref_g.values())
    for name, combine in (('sum', lambda a, b: a + b),
                          ('mean', lambda a, b: (a + b) / 2)):
        loss_err = max(_rel_err(combine(l0[k], l1[k]), ref_m[k])
                       for k in l0)
        grad_err = max(float((combine(*(
            g[n] if g[n] is not None else torch.zeros_like(want)
            for g in (g0, g1))) - want).abs().max())
            for n, want in ref_g.items() if want is not None) / largest
        assert min(loss_err, grad_err) > 100 * REL_TOL, (name, loss_err,
                                                         grad_err)


def test_uniad_clis_two_ranks(runs):
    r0, r1 = runs['ranks']
    assert r1['metrics'] is None
    assert r0['metrics'] == runs['single']
    assert all(np.isfinite(float(v)) for v in r0['metrics'].values())
    assert r1['writes'] == [] and r0['writes']
    assert os.path.isfile(os.path.join(runs['work'], 'latest', 'model.pt'))
    assert len(r0['log']) == 2 and [m['loss'] for m in r0['log']] == [
        m['loss'] for m in r1['log']]
    assert r0['params'].keys() == r1['params'].keys()
    for n, t in r0['params'].items():
        assert torch.equal(t, r1['params'][n]), n


def test_clip_checkpoints_change_no_result(monkeypatch, one_thread):
    """Dropout on, the same seed: the clip's losses and gradients with the
    checkpoints and with every ``checkpoint`` calling straight through (the
    camera split stays, so only the recomputation goes)."""
    inputs = _clip_inputs()
    calls = []
    real = uniad_module.checkpoint

    def counted(fn, *args, **kwargs):
        calls.append(fn)
        return real(fn, *args, **kwargs)

    def straight(fn, *args, use_reentrant=None, **kwargs):
        return fn(*args, **kwargs)

    def clip(patch):
        for mod in (uniad_module, vidar_module):
            monkeypatch.setattr(mod, 'checkpoint', patch)
        model = build_model(load_config(CONFIG)['model'], device='cpu')
        model.load_state_dict(inputs['sd'])
        model.train()
        assert any(m.p > 0 for m in model.modules()
                   if isinstance(m, torch.nn.Dropout))
        torch.manual_seed(0)
        total, losses = uniad_clip_loss_of(
            model, inputs['frames'], inputs['targets'], inputs['command'])
        total.backward()
        return losses, {n: p.grad for n, p in model.named_parameters()}

    losses, grads = clip(counted)
    # 2 frames x 3 cameras of backbone, 2 frames' encoders
    assert len(calls) == 2 * 3 + 2, len(calls)
    plain_losses, plain_grads = clip(straight)
    assert losses.keys() == plain_losses.keys()
    for k, v in losses.items():
        assert torch.equal(v, plain_losses[k]), k
    for n, g in grads.items():
        assert (g is None) == (plain_grads[n] is None), n
        assert g is None or torch.equal(g, plain_grads[n]), n
