"""One rank of the port's two-process CPU runs (tests/test_torch_distributed.py,
tests/test_torch_uniad_distributed.py).

    python tests/_torch_dist_worker.py steps OUT
        The environment names the process group (``VIDAR_COORDINATOR``,
        ``VIDAR_NUM_PROCESSES``, ``VIDAR_PROCESS_ID``). ``OUT/inputs.pt``
        holds the weights and the global batch of each model; the rank takes
        its sample. First, before the group is joined (every normaliser
        local), one forward and backward of each model: the per-rank
        normalised variant. Then ``maybe_initialize_distributed()`` from
        the environment, and one ``TrainStep`` (fixed gate, no grid mask,
        Gumbel noise or dropout) and one ``DetTrainStep`` (the same) ->
        ``OUT/rank{R}.pt``: each step's metrics, summed gradients and
        updated parameters, and the variant's losses and gradients.

    python tests/_torch_dist_worker.py cli OUT RANK PORT1 PORT2 ARGS.json
        ``tools.train`` and then ``tools.test`` (forecast eval), each with
        ``--coordinator 127.0.0.1:PORT --num-processes 2 --process-id
        RANK`` -> ``OUT/cli_rank{R}.pt``: the trained parameters, the
        checkpoint files this rank wrote, the test CLI's return and, on
        rank 0, the per-sample metric dicts it aggregated.

    python tests/_torch_dist_worker.py uniad OUT RANK PORT1 PORT2 PORT3 ARGS.json
        UniAD at ``configs/tiny/uniad_tiny.py``. ``OUT/uniad_inputs.pt``
        holds the weights and the bs-2 clip (frames, targets, command); the
        rank takes its sample. First, with no process group, the clip loss's
        forward and backward (the per-rank normalised variant); then one
        ``UniADTrainStep`` in a Gloo group on PORT1 (dropout off); then
        ``tools.train`` and ``tools.test`` at two ranks on PORT2 and PORT3
        with the argv lists of ARGS.json -> ``OUT/uniad_rank{R}.pt``: the
        variant's losses and gradients, the step's metrics, summed
        gradients and updated parameters, the trained parameters, the
        checkpoint files this rank wrote and the test CLI's return.

PyTorch runs on one thread, as the tests' in-process runs do.
"""

import dataclasses
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from vidar_tpu_torch.configs import vidar_dryrun, vidar_finetune_tiny  # noqa: E402
from vidar_tpu_torch.models import BEVFormer, ViDAR  # noqa: E402
from vidar_tpu_torch.parallel import (maybe_initialize_distributed,  # noqa: E402
                                      rank, shutdown)
from vidar_tpu_torch.train import (DetTrainStep, TrainStep,  # noqa: E402
                                   make_optimizer)

GATE = (1.0, 0.0)


def pretrain_cfg():
    return vidar_dryrun(future_pred_frame_num=2, use_grid_mask=False)


def det_cfg():
    return vidar_finetune_tiny(use_grid_mask=False)


def take(batch, r):
    """Sample r of a batch dataclass, as a batch of one (a field None
    stays None)."""
    return type(batch)(**{
        f.name: (take(v, r) if dataclasses.is_dataclass(v) else
                 None if v is None else v[r:r + 1])
        for f in dataclasses.fields(batch)
        for v in (getattr(batch, f.name),)})


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _grads(model):
    return {n: (p.grad.clone() if p.grad is not None else None)
            for n, p in model.named_parameters()}


def _model(cls, cfg, sd):
    model = cls(**cfg, device='cpu')
    model.load_state_dict(sd, strict=True)
    return _no_dropout(model)


def steps(out):
    inputs = torch.load(os.path.join(out, 'inputs.pt'), weights_only=False)
    r = int(os.environ['VIDAR_PROCESS_ID'])
    pre_batch, det_batch = (take(inputs['pre_batch'], r),
                            take(inputs['det_batch'], r))
    res = {}
    # the per-rank normalised variant: no process group yet
    m = _model(ViDAR, pretrain_cfg(), inputs['pre_sd']).train()
    losses = m(pre_batch, train_frame_gate=GATE)
    sum(losses.values()).backward()
    res['pre_local'] = ({k: float(v) for k, v in losses.items()}, _grads(m))
    m = _model(BEVFormer, det_cfg(), inputs['det_sd']).train()
    losses = m.loss(m(det_batch.frames, train=True), det_batch.gt_bboxes,
                    det_batch.gt_labels, det_batch.num_valid_gt)
    sum(losses.values()).backward()
    res['det_local'] = ({k: float(v) for k, v in losses.items()}, _grads(m))

    assert maybe_initialize_distributed(device='cpu')
    assert rank() == r
    m = _model(ViDAR, pretrain_cfg(), inputs['pre_sd'])
    step = TrainStep(m, make_optimizer(m, device='cpu'),
                     supervise_all_future=False, device='cpu')
    step.frame_gate = lambda: list(GATE)
    metrics = step(pre_batch)
    res['pre'] = (metrics, _grads(m), m.state_dict())
    m = _model(BEVFormer, det_cfg(), inputs['det_sd'])
    metrics = DetTrainStep(m, make_optimizer(m, device='cpu'),
                           device='cpu')(det_batch)
    res['det'] = (metrics, _grads(m), m.state_dict())
    shutdown()
    torch.save(res, os.path.join(out, f'rank{r}.pt'))


def _train_recording_writes(spec, r, port):
    """``tools.train`` at two ranks -> (what it returned, the files this
    rank's checkpoints wrote)."""
    from vidar_tpu_torch.core import checkpoint
    from vidar_tpu_torch.tools import train as train_cli
    writes = []
    save = torch.save

    def recording_save(obj, path, *a, **kw):
        writes.append(str(path))
        return save(obj, path, *a, **kw)

    checkpoint.torch.save = recording_save
    try:
        trained = train_cli.main(spec['train'] + [
            '--coordinator', f'127.0.0.1:{port}', '--num-processes', '2',
            '--process-id', str(r)])
    finally:
        checkpoint.torch.save = save
    return trained, writes


def uniad_clip_loss_of(model, frames, targets, command):
    """The clip's forward and weighted loss -> (total, per-term losses)."""
    from vidar_tpu_torch.uniad.clip_matcher import FrameGT
    from vidar_tpu_torch.uniad.loss import uniad_clip_loss
    gt = FrameGT(boxes=targets.track_boxes, labels=targets.track_labels,
                 ids=targets.track_ids, num_valid=targets.track_num)
    track_losses, out, matched = model.clip_forward(
        frames, gt, targets.l2g_r, targets.l2g_t, targets.timestamp, command,
        deterministic=False, with_masks=True)
    return uniad_clip_loss(track_losses, out, targets, matched,
                           task_loss_weight=model.task_loss_weight)


def uniad_model(sd):
    from vidar_tpu_torch.core.builder import build_model
    from vidar_tpu_torch.core.config import load_config
    cfg = load_config(os.path.join(REPO, 'configs', 'tiny',
                                   'uniad_tiny.py'))['model']
    return _model(lambda **kw: build_model(cfg, **kw), {}, sd)


def uniad(out, r, port1, port2, port3, args_file):
    from vidar_tpu_torch.tools import test as test_cli
    from vidar_tpu_torch.train import UniADTrainStep
    inputs = torch.load(os.path.join(out, 'uniad_inputs.pt'),
                        weights_only=False)
    frames, targets = take(inputs['frames'], r), take(inputs['targets'], r)
    command = inputs['command'][r:r + 1]
    res = {}
    # the per-rank normalised variant: no process group yet
    m = uniad_model(inputs['sd']).train()
    total, losses = uniad_clip_loss_of(m, frames, targets, command)
    total.backward()
    res['local'] = ({k: float(v) for k, v in losses.items()}, _grads(m))

    assert maybe_initialize_distributed(f'127.0.0.1:{port1}', 2, r,
                                        device='cpu')
    m = uniad_model(inputs['sd'])
    metrics = UniADTrainStep(m, make_optimizer(m, device='cpu'),
                             task_loss_weight=m.task_loss_weight,
                             device='cpu')((frames, targets, command))
    res['step'] = (metrics, _grads(m), m.state_dict())
    shutdown()

    with open(args_file) as f:
        spec = json.load(f)
    trained, writes = _train_recording_writes(spec, r, port2)
    res['metrics'] = test_cli.main(spec['test'] + [
        '--coordinator', f'127.0.0.1:{port3}', '--num-processes', '2',
        '--process-id', str(r)])
    res.update(params=trained['model'].state_dict(), log=trained['log'],
               writes=writes)
    torch.save(res, os.path.join(out, f'uniad_rank{r}.pt'))


def cli(out, r, port1, port2, args_file):
    from vidar_tpu_torch.tools import test as test_cli
    with open(args_file) as f:
        spec = json.load(f)
    trained, writes = _train_recording_writes(spec, r, port1)
    dist = ['--num-processes', '2', '--process-id', str(r)]
    gathered = []
    aggregate = test_cli.aggregate_frame_metrics

    def recording_aggregate(results):
        gathered.extend(results)
        return aggregate(results)

    test_cli.aggregate_frame_metrics = recording_aggregate
    metrics = test_cli.main(spec['test'] + ['--coordinator',
                                            f'127.0.0.1:{port2}'] + dist)
    torch.save(dict(params=trained['model'].state_dict(),
                    log=trained['log'], writes=writes, metrics=metrics,
                    gathered=gathered),
               os.path.join(out, f'cli_rank{r}.pt'))


def main(argv):
    torch.set_num_threads(1)
    if argv[0] == 'steps':
        steps(argv[1])
    elif argv[0] == 'cli':
        cli(argv[1], int(argv[2]), argv[3], argv[4], argv[5])
    elif argv[0] == 'uniad':
        uniad(argv[1], int(argv[2]), *argv[3:7])
    else:
        raise SystemExit(f'unknown job {argv[0]!r}')
    print('RANK_OK', flush=True)


if __name__ == '__main__':
    main(sys.argv[1:])
