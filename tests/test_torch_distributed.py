"""The port's data parallelism on the CPU: two Gloo ranks against the JAX
package's step on the global batch of both ranks' samples.

* (i) ``TrainStep`` at ``vidar_dryrun`` (two futures, the fixed gate (1, 0)
  of test_torch_train.py, no grid mask, Gumbel noise or dropout), one
  sample a rank: the losses, the gradients summed over the ranks,
  ``grad_norm`` and the updated parameters against ``ViDAR.apply(train=
  True)`` + ``jax.grad`` + optax at bs 2. The two samples differ in their
  valid rays (half of sample 1's GT points are padding), and the ranks'
  per-rank normalised losses and gradients (each rank alone, summed or
  averaged over the ranks as a plain all-reduce or DDP would) miss the
  same tolerance.
* (ii) ``DetTrainStep`` at ``vidar_finetune_tiny`` with 0 GT boxes on rank
  0 and 3 on rank 1, against the JAX fine-tune loss + ``jax.grad`` + optax
  at bs 2: a per-rank clamp of ``num_pos`` shows most here.
* (iii) the test CLI's forecast eval at two ranks on the fake nuScenes
  dataset gathers on rank 0 exactly the per-sample metrics of the
  one-process run, in sample order; (iv) the train CLI at two ranks writes
  its checkpoints from rank 0 alone and leaves both ranks' parameters
  bit-identical.
* (v) no flag and no ``VIDAR_*`` variable: no process group.
* Two processes that build the host library at once build it once.

The updated parameters are held against optax applied to the ranks' summed
gradients (carried into the JAX tree), as test_torch_train.py holds the
optimizer: Adam's first step divides each gradient by its own magnitude,
so an element whose JAX and port gradients differ in sign at rounding
level moves by 2 x lr either way. Each rank group is one spawn of two
worker processes (tests/_torch_dist_worker.py); all JAX work is two jitted
functions of one module fixture.
"""

import json
import os
import pathlib
import subprocess
import sys
from collections.abc import Mapping

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from vidar_tpu.configs import vidar_dryrun
from vidar_tpu.data import make_synthetic_batch as jax_synthetic_batch
from vidar_tpu.data.structures import DetBatch as JaxDetBatch
from vidar_tpu.models import BEVFormer as JaxBEVFormer
from vidar_tpu.models import ViDAR as JaxViDAR
from vidar_tpu.train.optim import make_optimizer as jax_make_optimizer

from tests._torch_dist_spawn import _free_port, _spawn, _wait
from tests.data.fake_nuscenes import make_fake_nuscenes
from vidar_tpu_torch.configs import vidar_finetune_tiny
from vidar_tpu_torch.convert import state_dict_from_jax
from vidar_tpu_torch.data import (make_synthetic_batch,
                                  make_synthetic_det_batch)
from vidar_tpu_torch.models import BEVFormer
from vidar_tpu_torch.parallel import (initialized,
                                      maybe_initialize_distributed, rank,
                                      world_size)
from vidar_tpu_torch.tools import test as test_cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = str(ROOT / 'configs' / 'tiny' / 'vidar_tiny.py')
# test_torch_train.py's shapes, gate and tolerances, at one sample a rank
SHAPES = dict(queue_length=2, future_length=2, num_cams=3, img_h=64,
              img_w=64, max_points=128)
GATE = (1.0, 0.0)
REL_TOL = 1e-3
UPDATE_TOL = 1e-4
F32_EPS = float(np.finfo(np.float32).eps)


def _random_params(shapes, seed):
    """test_torch_train.py's numpy-seeded weights: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1), biases N(0, 0.1), embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        v = rng.standard_normal(s.shape)
        if name == 'kernel':
            v = v / np.sqrt(np.prod(s.shape[:-1]))
        elif name == 'scale':
            v = 1.0 + 0.1 * v
        elif name == 'bias':
            v = 0.1 * v
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _to_jax_tree(tensors, like):
    """A {torch key: tensor} of the port's parameters -> a tree shaped as
    the JAX parameter tree ``like`` (zeros where the port has no
    parameter: the frozen BatchNorms, buffers in the port). The layout
    transforms of ``state_dict_from_jax`` are permutations: carried out on
    each leaf's element indices, they say where each element goes back."""
    index = jax.tree.map(lambda x: np.arange(np.size(x), dtype=np.float32)
                         .reshape(np.shape(x)), like)
    where = state_dict_from_jax(index)
    keys = iter(where)          # in the order of state_dict_from_jax's walk

    def fill(node):             # the same walk
        out = {}
        for name, v in node.items():
            if isinstance(v, Mapping):
                out[name] = fill(v)
                continue
            k = next(keys)
            flat = np.zeros(np.size(v), np.float32)
            if k in tensors:
                idx = where[k].numpy().reshape(-1).astype(np.int64)
                flat[idx] = tensors[k].numpy().reshape(-1)
            out[name] = flat.reshape(np.shape(v))
        return out

    tree = fill(index['params'] if 'params' in index else index)
    return jax.tree.unflatten(jax.tree.structure(like), jax.tree.leaves(
        {'params': tree} if 'params' in index else tree))


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope='module')
def steps(tmp_path_factory):
    """Both models' global batches and weights; the two ranks' steps run in
    their processes while JAX computes the global-batch references here."""
    out = str(tmp_path_factory.mktemp('dist_steps'))
    key = jax.random.PRNGKey(0)

    pre_cfg = vidar_dryrun(future_pred_frame_num=2, use_grid_mask=False)
    jpre = JaxViDAR(**pre_cfg)
    pre_batch = make_synthetic_batch(np.random.default_rng(0), bs=2,
                                     **SHAPES, device='cpu')
    tindex = pre_batch.gt_tindex.clone()
    tindex[1, ::2] = -1                 # fewer valid rays in sample 1
    pre_batch.gt_tindex = tindex
    jpre_batch = jax_synthetic_batch(np.random.default_rng(0), bs=2,
                                     **SHAPES).replace(
        gt_tindex=jnp.asarray(tindex.numpy()))
    assert np.array_equal(np.asarray(jpre_batch.images),
                          pre_batch.images.numpy())
    # seed 2: under the XLA flags of the repository's conftest.py, JAX's
    # gradient at seeds 1, 3 and 4 moves by 1e-3 to 2.5e-2 of a backbone
    # tensor's size (a sample within rounding of a jump of the bilinear
    # DCN gradient; at seed 1 the port's two ranks agree with its own bs-2
    # process to 1e-6, and with JAX under default flags to 3e-6)
    pre_params = _random_params(jax.eval_shape(lambda: jpre.init(
        {'params': key, 'dropout': key}, jpre_batch, train=False)), seed=2)

    det_cfg = vidar_finetune_tiny(use_grid_mask=False)
    jdet = JaxBEVFormer(**det_cfg)
    det_batch = make_synthetic_det_batch(np.random.default_rng(0), bs=2,
                                         device='cpu')
    # rank 0: no GT box at all. Its padding keeps the boxes drawn for it:
    # a zero-size padding box normalises to -inf, and the JAX loss's
    # product of the targets with the mask turns that into NaN and the
    # whole batch's box loss into 0 (the port selects instead:
    # test_padding_boxes_do_not_enter_the_det_loss)
    det_batch.num_valid_gt[0] = 0
    jdet_batch = JaxDetBatch(
        frames=jax_synthetic_batch(np.random.default_rng(0), bs=2,
                                   queue_length=2, future_length=0,
                                   num_cams=3, img_h=64, img_w=64,
                                   max_points=64),
        gt_bboxes=jnp.asarray(det_batch.gt_bboxes.numpy()),
        gt_labels=jnp.asarray(det_batch.gt_labels.numpy()),
        num_valid_gt=jnp.asarray(det_batch.num_valid_gt.numpy()))
    det_params = _random_params(jax.eval_shape(lambda: jdet.init(
        {'params': key, 'dropout': key, 'aug': key}, jdet_batch.frames,
        train=False)), seed=2)

    torch.save(dict(pre_sd=state_dict_from_jax(pre_params),
                    pre_batch=pre_batch,
                    det_sd=state_dict_from_jax(det_params),
                    det_batch=det_batch), os.path.join(out, 'inputs.pt'))
    port = _free_port()
    procs = _spawn([['steps', out]] * 2, [
        dict(VIDAR_COORDINATOR=f'127.0.0.1:{port}', VIDAR_NUM_PROCESSES='2',
             VIDAR_PROCESS_ID=str(r)) for r in range(2)], out)
    try:
        def pre_loss(p):
            losses, _ = jpre.apply(p, jpre_batch, train=True,
                                   rngs={'dropout': key}, gumbel_rng=None,
                                   train_frame_gate=jnp.asarray(GATE))
            return sum(jax.tree.leaves(losses)), losses

        def det_loss(p):
            preds = jdet.apply(p, jdet_batch.frames, train=True,
                               rngs={'dropout': key, 'aug': key})
            losses = jdet.apply(p, preds, jdet_batch.gt_bboxes,
                                jdet_batch.gt_labels,
                                jdet_batch.num_valid_gt, method=jdet.loss)
            return sum(jax.tree.leaves(losses)), losses

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fnn.Dropout, '__call__', lambda self, x, **kw: x)
            ((_, jpre_losses), jpre_grads), ((_, jdet_losses), jdet_grads) = (
                jax.jit(lambda a, b: (
                    jax.value_and_grad(pre_loss, has_aux=True)(a),
                    jax.value_and_grad(det_loss, has_aux=True)(b)))(
                        pre_params, det_params))
    finally:
        _wait(procs, out)
    ranks = [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
             for r in range(2)]

    # optax on the ranks' summed gradients, both models in one function
    tx_pre, _ = jax_make_optimizer(pre_params)
    tx_det, _ = jax_make_optimizer(det_params)

    def update(tx, g, p):
        return jax.tree.map(lambda a, u: a + u, p,
                            tx.update(g, tx.init(p), p)[0])

    g_pre = _to_jax_tree({k: v for k, v in ranks[0]['pre'][1].items()
                          if v is not None}, pre_params)
    g_det = _to_jax_tree({k: v for k, v in ranks[0]['det'][1].items()
                          if v is not None}, det_params)
    new_pre, new_det = jax.jit(lambda a, b, c, d: (
        update(tx_pre, a, b), update(tx_det, c, d)))(
            g_pre, pre_params, g_det, det_params)
    return dict(
        pre=dict(jlosses=jpre_losses, jgrads=state_dict_from_jax(jpre_grads),
                 old=state_dict_from_jax(pre_params),
                 new=state_dict_from_jax(new_pre)),
        det=dict(jlosses=jdet_losses, jgrads=state_dict_from_jax(jdet_grads),
                 old=state_dict_from_jax(det_params),
                 new=state_dict_from_jax(new_det)),
        ranks=ranks, det_sd=state_dict_from_jax(det_params),
        det_batch=det_batch)


def _hold_step(run, model):
    """One model's two-rank step against JAX's on the global batch."""
    ref = run[model]
    (m0, g0, p0), (m1, g1, p1) = (r[model] for r in run['ranks'])
    # the ranks agree bit for bit: metrics, summed gradients, parameters
    assert m0 == m1
    assert g0.keys() == g1.keys() and p0.keys() == p1.keys()
    for n in g0:
        assert (g0[n] is None) == (g1[n] is None), n
        assert g0[n] is None or torch.equal(g0[n], g1[n]), n
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
    # the global batch's losses, gradients and gradient norm
    jl = ref['jlosses']
    assert set(jl) <= set(m0)
    for k in sorted(jl):
        _close(m0[k], jl[k], REL_TOL, k)
    _close(m0['loss'], sum(float(v) for v in jl.values()), REL_TOL, 'loss')
    want = ref['jgrads']
    checked = 0
    for n, g in g0.items():
        w = want[n].numpy()
        if n.endswith('self_attn.key.bias'):
            # zero in exact arithmetic (test_torch_bevformer.py): both sides
            # rounding noise far below the query bias's gradient
            floor = 1e-5 * np.abs(want[n.replace('key', 'query')]
                                  .numpy()).max()
            assert np.abs(w).max() <= floor, n
            assert float(g.abs().max()) <= floor, n
            continue
        if not np.abs(w).max() > 0:
            assert g is None or float(g.abs().max()) == 0, n
            continue
        _close(g if g is not None else torch.zeros_like(want[n]), w,
               REL_TOL, n)
        checked += 1
    norm = np.sqrt(sum(float((want[n].double() ** 2).sum()) for n in g0))
    _close(m0['grad_norm'], norm, REL_TOL, 'grad_norm')
    # the update: optax on the same (summed) gradients
    for n, p in p0.items():
        if n not in ref['new']:
            continue                       # a buffer
        new = ref['new'][n].numpy().astype(np.float64)
        old = ref['old'][n].numpy()
        err = np.abs(p.numpy() - new).max()
        tol = (UPDATE_TOL * np.abs(new - old).max() +
               2 * F32_EPS * np.abs(old).max())
        assert err <= tol, (n, err, tol)
    return checked


def _per_rank_errors(run, model):
    """The largest relative error against JAX of the per-rank normalised
    variant: losses and gradients summed over the ranks (an all-reduce
    without the global counts) and averaged (DistributedDataParallel)."""
    ref = run[model]
    (l0, g0), (l1, g1) = (r[f'{model}_local'] for r in run['ranks'])
    errors = {}
    for name, combine in (('sum', lambda a, b: a + b),
                          ('mean', lambda a, b: (a + b) / 2)):
        worst = max(_rel_err(combine(l0[k], l1[k]), ref['jlosses'][k])
                    for k in ref['jlosses'])
        for n, w in ref['jgrads'].items():
            if (n not in g0 or n.endswith('self_attn.key.bias') or
                    not float(w.abs().max()) > 0):
                continue
            a, b = (g[n] if g[n] is not None else torch.zeros_like(w)
                    for g in (g0, g1))
            worst = max(worst, _rel_err(combine(a, b), w))
        errors[name] = worst
    return errors


def test_pretrain_step_equals_jax_global_batch(steps):
    assert _hold_step(steps, 'pre') > 100
    # the gated-off future's decoder has no gradient on either rank
    assert any(g is None for g in steps['ranks'][0]['pre'][1].values())


def test_det_step_equals_jax_global_batch(steps):
    assert _hold_step(steps, 'det') > 100
    assert 'd0.loss_cls' in steps['ranks'][0]['det'][0]


@pytest.mark.parametrize('model', ['pre', 'det'])
def test_per_rank_normalisers_miss_the_tolerance(steps, model):
    errors = _per_rank_errors(steps, model)
    assert min(errors.values()) > 10 * REL_TOL, errors


def test_padding_boxes_do_not_enter_the_det_loss(steps):
    """A sample without GT boxes padded with zero-size boxes, as the
    loaders pad, gives the batch's losses of any other padding: the
    reference takes the finite matched targets by index."""
    model = BEVFormer(**vidar_finetune_tiny(use_grid_mask=False),
                      device='cpu')
    model.load_state_dict(steps['det_sd'], strict=True)
    model.eval()                                   # dropout off
    batch = steps['det_batch']
    zero_padded = batch.gt_bboxes.clone()
    zero_padded[0] = 0.0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            preds = model(batch.frames, train=True)
            drawn = model.loss(preds, batch.gt_bboxes, batch.gt_labels,
                               batch.num_valid_gt)
            zero = model.loss(preds, zero_padded, batch.gt_labels,
                              batch.num_valid_gt)
    finally:
        torch.set_num_threads(threads)
    assert float(drawn['loss_bbox']) > 0
    for k, v in drawn.items():
        assert torch.equal(zero[k], v), k


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    """The train CLI (2 steps) and then the test CLI (forecast eval of its
    checkpoint on 3 samples) at two ranks, one spawn; the same test CLI run
    in this process without a process group."""
    root = tmp_path_factory.mktemp('dist_cli')
    pkl = make_fake_nuscenes(str(root / 'data'), num_samples=6, num_cams=3,
                             img_hw=(64, 96))
    data = [f'data.train.ann_file={pkl}', f'data.test.ann_file={pkl}']
    work = str(root / 'work')
    spec = dict(
        train=[TINY, '--work-dir', work, '--max-steps', '2', '--device',
               'cpu', '--deterministic', '--cfg-options', *data,
               'log_interval=1'],
        # above max_points (the fake windows hold more lidar points), each
        # sample's subsample is drawn from (seed, frame index): a rank's
        # samples equal the one process's
        test=[TINY, os.path.join(work, 'latest'), '--max-samples', '3',
              '--device', 'cpu', '--cfg-options', *data])
    spec_file = str(root / 'spec.json')
    with open(spec_file, 'w') as f:
        json.dump(spec, f)
    ports = [str(_free_port()), str(_free_port())]
    _wait(_spawn([['cli', str(root), str(r), *ports, spec_file]
                  for r in range(2)], [{}, {}], str(root)), str(root))
    ranks = [torch.load(str(root / f'cli_rank{r}.pt'), weights_only=False)
             for r in range(2)]

    gathered = []
    aggregate = test_cli.aggregate_frame_metrics
    threads = torch.get_num_threads()
    torch.set_num_threads(1)               # as the workers
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(test_cli, 'aggregate_frame_metrics',
                       lambda results: gathered.extend(results) or
                       aggregate(results))
            single = test_cli.main(spec['test'])
    finally:
        torch.set_num_threads(threads)
    return dict(ranks=ranks, single=single, gathered=gathered, work=work)


def test_forecast_eval_gathers_the_one_process_metrics(cli_runs):
    r0, r1 = cli_runs['ranks']
    assert r1['metrics'] is None and r1['gathered'] == []
    assert len(cli_runs['gathered']) == 3
    # samples [0, 1] on rank 0 and [2] on rank 1, gathered in sample order
    assert r0['gathered'] == cli_runs['gathered']
    assert r0['metrics'] == cli_runs['single']


def test_train_cli_two_ranks(cli_runs):
    r0, r1 = cli_runs['ranks']
    assert r1['writes'] == []
    written = sorted(os.path.basename(os.path.dirname(p.split('.tmp')[0]))
                     for p in r0['writes'])
    assert r0['writes'] and all(p.endswith(('model.pt', 'optimizer.pt'))
                                for p in r0['writes']), written
    assert os.path.isfile(os.path.join(cli_runs['work'], 'latest',
                                       'model.pt'))
    # the metrics of the global batch on both ranks (their clocks apart)
    clocks = ('it/s', 'data_wait_s')
    assert len(r0['log']) == 2 and [
        {k: v for k, v in m.items() if k not in clocks}
        for m in r0['log']] == [
        {k: v for k, v in m.items() if k not in clocks} for m in r1['log']]
    assert all(np.isfinite(m['loss']) for m in r0['log'])
    assert r0['params'].keys() == r1['params'].keys()
    for n, t in r0['params'].items():
        assert torch.equal(t, r1['params'][n]), n


def test_no_flags_no_process_group(monkeypatch):
    for name in ('VIDAR_COORDINATOR', 'VIDAR_NUM_PROCESSES',
                 'VIDAR_PROCESS_ID'):
        monkeypatch.delenv(name, raising=False)
    assert maybe_initialize_distributed(device='cpu') is False
    assert not initialized()
    assert (rank(), world_size()) == (0, 1)
    with pytest.raises(ValueError, match='process id'):
        maybe_initialize_distributed('127.0.0.1:1', 2, device='cpu')
    assert not initialized()


def test_two_processes_build_the_host_library_once(tmp_path):
    """Two processes that need the host library at once, in a fresh build
    directory: one compiles, the other waits on the lock and loads it."""
    code = (
        'import ctypes, pathlib, subprocess, sys\n'
        'from vidar_tpu_torch.native import build\n'
        'from vidar_tpu_torch.ops import _build\n'
        '_build.BUILD_DIR = pathlib.Path(sys.argv[1])\n'
        'calls = []\n'
        'run = subprocess.run\n'
        'def counted(*a, **kw):\n'
        '    calls.append(a)\n'
        '    return run(*a, **kw)\n'
        'build.subprocess.run = counted\n'
        'ctypes.CDLL(build.build())\n'
        'print("COMPILES", len(calls))\n')
    procs = [subprocess.Popen([sys.executable, '-c', code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    compiles = [int(o.split('COMPILES')[1]) for o in outs]
    assert sorted(compiles) == [0, 1], outs
    assert [p.name for p in tmp_path.glob('hostops-*')] and not list(
        tmp_path.glob('*.tmp'))
