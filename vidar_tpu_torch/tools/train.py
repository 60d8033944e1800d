"""Training CLI of the port (vidar_tpu/tools/train.py, one process per
card).

Builds the model and the train split from a config, feeds the epochs'
samples through the threaded ``PrefetchLoader``, steps ``TrainStep`` (a
ViDAR pre-training config), ``DetTrainStep`` (a BEVFormer fine-tune
config) or ``UniADTrainStep`` (a UniAD config), logs
the metrics as JSON lines, evaluates with ``EvalHook`` and
``run_val_evaluation``, and writes checkpoint directories (``latest/``,
``step_N/``, ``best/``, ``ema_latest/``) under the work dir.

Usage:
  python -m vidar_tpu_torch.tools.train CONFIG [--work-dir DIR]
      [--resume-from CKPT] [--load-from CKPT | PTH]
      [--cfg-options k.ey=value ...]
      [--seed N] [--deterministic] [--max-steps N] [--device cpu]
      [--coordinator HOST:PORT --num-processes N --process-id R]

It runs on the card (``--device cuda``, the default) unless the caller asks
for the CPU. A model that computes in f32 has its convolutions computed in
f32 (cuDNN's TF32 off while it runs; ``device.use_f32_convolutions``).
``main(argv)`` returns what it logged, so a script can call it in the same
process.

Across N processes (the three flags, or ``VIDAR_COORDINATOR`` /
``VIDAR_NUM_PROCESSES`` / ``VIDAR_PROCESS_ID``; one process per card, NCCL;
Gloo with ``--device cpu``) each rank loads ``samples_per_gpu`` samples of
its shard of the epoch, so a step takes N x ``samples_per_gpu`` samples and
computes JAX's step on that global batch. Rank 0 alone writes the log
lines, ``config_dump.txt``, the checkpoints and runs the evaluation; the
other ranks wait for it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.builder import build_dataset, build_model
from ..core.checkpoint import (import_torch_checkpoint, load_checkpoint,
                               load_params_partial, save_checkpoint)
from ..core.config import apply_overrides, dump_config, load_config
from ..data.prefetch import PrefetchLoader
from ..data.samplers import GroupShuffleSampler
from ..data.structures import collate_samples
from ..device import use_f32_convolutions
from ..models import BEVFormer
from ..parallel import (add_distributed_args, barrier, broadcast_object,
                        broadcast_parameters_, is_main, local_device,
                        maybe_initialize_distributed, rank, shutdown,
                        world_size)
from ..train import (DetTrainStep, TrainStep, UniADTrainStep,
                     make_optimizer)
from ..train.ema import EMA
from ..train.eval_hook import EvalHook
from .test import run_val_evaluation


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(
        description='Train a ViDAR model (PyTorch, one process per GPU)')
    p.add_argument('config', help='config file path')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--resume-from', default=None)
    p.add_argument('--load-from', default=None,
                   help='checkpoint directory of vidar_tpu_torch, or a '
                        'reference .pth, to initialise from (shape-checked, '
                        'partial)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--deterministic', action='store_true')
    p.add_argument('--cfg-options', nargs='+', default=None)
    p.add_argument('--max-steps', type=int, default=None,
                   help='override total steps (debug)')
    p.add_argument('--device', default='cuda',
                   help='torch device (default cuda; cpu only on request)')
    add_distributed_args(p)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """-> dict(step: the last step, log: the logged metric dicts, eval: the
    in-training evaluations as (epoch, metrics), loaded: the tensors
    ``--load-from`` / ``load_from`` loaded, torch_import: the
    ``TorchImport`` of a ``.pth`` (else None), work_dir, model). A process
    group that it joined, it leaves before it returns."""
    args = parse_args(argv)
    joined = maybe_initialize_distributed(
        args.coordinator, args.num_processes, args.process_id,
        device=args.device)
    tf32 = torch.backends.cudnn.allow_tf32    # an f32 model turns it off
    try:
        return _train(args)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        if joined:
            shutdown()


def _train(args):
    device = local_device(args.device)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    uniad = cfg['model'].get('type', 'ViDAR') == 'UniAD'
    work_dir = args.work_dir or cfg.get('work_dir') or os.path.join(
        'work_dirs', os.path.splitext(os.path.basename(args.config))[0])
    if is_main():
        os.makedirs(work_dir, exist_ok=True)
        with open(os.path.join(work_dir, 'config_dump.txt'), 'w') as f:
            f.write(dump_config(cfg))
    barrier()

    # dropout draws differ between ranks, as JAX's per-sample draws differ
    # between the samples of its global batch
    torch.manual_seed(args.seed + rank())
    model = build_model(cfg['model'], device=device)
    use_f32_convolutions(model)
    model.init_weights_(torch.Generator(device=device).manual_seed(
        args.seed))
    dataset = build_dataset(cfg['data']['train'])
    local_batch = int(cfg.get('data', {}).get('samples_per_gpu', 1))

    # training sampler: per-epoch shuffled (reference
    # DistributedGroupSampler, samplers/group_sampler.py:15), sharded by
    # rank. Datasets expose ``group_ids`` for aspect-grouping; default is
    # one group = plain shuffle.
    group_ids = getattr(dataset, 'group_ids', None)
    if group_ids is None:
        group_ids = np.zeros(len(dataset), np.int64)
    sampler = GroupShuffleSampler(group_ids, rank=rank(),
                                  world_size=world_size(), seed=args.seed)

    total_epochs = cfg.get('total_epochs', 24)
    epoch_len = len(sampler.epoch_indices(0))  # this rank's shard
    steps_per_epoch = max(1, epoch_len // local_batch)
    total_steps = args.max_steps or total_epochs * steps_per_epoch

    num_workers = int(cfg.get('data', {}).get('workers_per_gpu', 4))
    if args.deterministic:
        # single-threaded loading: the dataset's numpy RNG is shared across
        # prefetch threads, so thread scheduling perturbs the aug stream —
        # one worker makes the sample stream bit-reproducible
        num_workers = 1

    def epoch_batches(epoch: int, skip_steps: int = 0):
        idx = sampler.epoch_indices(epoch)
        # pad to a whole number of batches (wrap-around, matching the
        # reference sampler's padding-to-equal-length contract)
        n_steps = max(1, len(idx) // local_batch)
        need = n_steps * local_batch
        if len(idx) < need:
            idx = (idx * ((need + len(idx) - 1) // len(idx)))[:need]
        idx = idx[:need][skip_steps * local_batch:]
        it = iter(PrefetchLoader(dataset.__getitem__, idx,
                                 num_threads=num_workers,
                                 depth=max(2 * local_batch, 4)))
        while True:
            items = []
            try:
                for _ in range(local_batch):
                    items.append(next(it))
            except StopIteration:
                return
            yield collate_samples(items)

    loaded, imported = 0, None
    load_from = args.load_from or cfg.get('load_from')
    if load_from:
        if load_from.endswith('.pth') and os.path.exists(load_from):
            # a reference checkpoint (the FCOS3D backbone init, a released
            # model): its key mapping, then a shape-checked graft
            imported = import_torch_checkpoint(load_from, model)
            loaded = len(imported.matched)
        elif os.path.isdir(load_from):
            # a previous stage's checkpoint (pretrain -> finetune): partial,
            # shape-checked restore (mmcv strict=False contract)
            loaded, kept = load_params_partial(load_from, model)
            if is_main():
                print(f'load_from {load_from}: {loaded} tensors loaded, '
                      f'{kept} kept from init', flush=True)
        elif args.load_from:
            raise FileNotFoundError(load_from)
        elif is_main():
            print(f'load_from {load_from!r} not found; training from init')
    # every rank starts from rank 0's weights
    broadcast_parameters_(model)

    opt_cfg = cfg.get('optimizer', {})
    optimizer = make_optimizer(
        model,
        base_lr=opt_cfg.get('lr', 2e-4),
        weight_decay=opt_cfg.get('weight_decay', 0.01),
        backbone_lr_mult=opt_cfg.get('backbone_lr_mult', 0.1),
        grad_clip_norm=cfg.get('grad_clip_norm', 35.0),
        total_steps=total_steps, device=device)
    # the grid mask and the Gumbel noise per rank; the frame gate, one for
    # the global batch in JAX, from a generator seeded alike on every rank
    generator = torch.Generator(device=device).manual_seed(args.seed + rank())
    if isinstance(model, BEVFormer):
        step_fn = DetTrainStep(model, optimizer, generator=generator,
                               device=device)
    elif uniad:
        step_fn = UniADTrainStep(
            model, optimizer, device=device,
            task_loss_weight=cfg['model'].get('task_loss_weight'))
    else:
        gate_generator = (None if world_size() == 1 else torch.Generator(
            device=device).manual_seed(args.seed))
        step_fn = TrainStep(
            model, optimizer, generator=generator,
            gate_generator=gate_generator, device=device,
            supervise_all_future=cfg['model'].get('supervise_all_future',
                                                  True))

    start = 0
    if args.resume_from:
        start = load_checkpoint(args.resume_from, model, optimizer)
        broadcast_parameters_(model)

    def state(step):
        return {'model': model, 'optimizer': optimizer, 'step': step}

    log_interval = cfg.get('log_interval', 50)
    ckpt_interval = cfg.get('checkpoint_interval_steps', steps_per_epoch)

    # evaluation hook (reference CustomDistEvalHook: dynamic intervals +
    # save_best; cfg key mirrors the reference's `evaluation = dict(...)`)
    eval_cfg = dict(cfg.get('evaluation') or {})
    eval_hook = None
    if eval_cfg:
        eval_hook = EvalHook(
            interval=eval_cfg.get('interval', total_epochs),
            dynamic_intervals=eval_cfg.get('dynamic_intervals'),
            start=eval_cfg.get('start'),
            save_best=eval_cfg.get('save_best'),
            rule=eval_cfg.get('rule', 'greater'))
    evals = []

    def maybe_evaluate(epoch, step):
        if eval_hook is None or not eval_hook.should_evaluate(epoch):
            return
        best = False
        if is_main():
            # rank 0 alone, unsharded, as JAX evaluates during training;
            # the other ranks wait at the barrier (multihost.TIMEOUT)
            metrics = run_val_evaluation(
                cfg, model, max_samples=eval_cfg.get('max_samples'),
                device=device)
            if metrics is not None:
                evals.append((epoch, metrics))
                print(f'[eval @ epoch {epoch}] ' + json.dumps(
                    {k: round(float(v), 5) for k, v in metrics.items()}),
                    flush=True)
                best = eval_hook.record(epoch, metrics.get('key_score'))
        barrier()
        if broadcast_object(best):
            save_checkpoint(os.path.join(work_dir, 'best'), state(step))
            if is_main():
                print(f'[eval] new best '
                      f'{eval_hook.save_best}={eval_hook.best_score:.5f}')

    # EMA hook (reference core/hooks/ema.py; enable with cfg `ema = dict(
    # mode='exp'|'linear', momentum=..., gamma=...)`)
    ema_cfg = dict(cfg.get('ema') or {})
    ema = None
    if ema_cfg:
        ema = EMA(model, momentum=ema_cfg.get('momentum', 0.0002),
                  gamma=ema_cfg.get('gamma', 2000.0),
                  mode=ema_cfg.get('mode', 'exp'))

    log = []
    t0 = time.time()
    wait = 0.0          # seconds the steps waited for the loader
    it = start
    start_epoch = start // steps_per_epoch
    skip = start % steps_per_epoch
    # --max-steps may exceed total_epochs * steps_per_epoch (debug runs on
    # tiny datasets); keep cycling epochs until the step budget is spent
    run_epochs = max(total_epochs, -(-total_steps // steps_per_epoch))
    for epoch in range(start_epoch, run_epochs):
        batches = epoch_batches(epoch, skip_steps=skip)
        while it < total_steps:
            tw = time.time()
            batch = next(batches, None)
            wait += time.time() - tw
            if batch is None:
                break
            metrics = step_fn(batch)
            if ema is not None:
                ema.update(model)
            it += 1
            if it % log_interval == 0:
                m = dict(metrics)
                m['lr'] = optimizer.schedule(it - 1)
                m['it/s'] = log_interval / (time.time() - t0)
                m['data_wait_s'] = wait / log_interval
                t0, wait = time.time(), 0.0
                log.append(m)
                if is_main():
                    print(f'[{it}/{total_steps}] ' + json.dumps(m),
                          flush=True)
                # the metrics are the global batch's, equal on every rank
                if m.get('sca_overflow', 0) > 0:
                    # visible queries were dropped by the SCA static
                    # capacity — a silent parity loss vs the reference's
                    # dynamic rebatching. Raise (or warn loudly) per cfg.
                    msg = (f'SCA capacity overflow: {int(m["sca_overflow"])}'
                           f' visible queries dropped (step {it}). Raise '
                           f'model.sca_capacity_ratio')
                    if cfg.get('sca_overflow_action', 'warn') == 'raise':
                        raise RuntimeError(msg)
                    if is_main():
                        print(f'WARNING: {msg}', file=sys.stderr)
            if it % ckpt_interval == 0:
                save_checkpoint(os.path.join(work_dir, f'step_{it}'),
                                state(it))
        batches.close()    # stops the epoch's loader threads
        skip = 0
        maybe_evaluate(epoch + 1, it)
        if it >= total_steps:
            break
    save_checkpoint(os.path.join(work_dir, 'latest'), state(it))
    if ema is not None:
        save_checkpoint(os.path.join(work_dir, 'ema_latest'),
                        {'model': ema.state_dict(model), 'step': ema.step})
    return dict(step=it, log=log, eval=evals, loaded=loaded,
                torch_import=imported, work_dir=work_dir, model=model)


if __name__ == '__main__':
    main()
