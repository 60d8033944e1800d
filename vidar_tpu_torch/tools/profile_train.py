"""Where the time of a train step goes, on one GPU.

    python -m vidar_tpu_torch.tools.profile_train [--model M] [--steps N]

``--model vidar`` (the default): the step of ``chip_smoke.py`` phase 5
(``vidar_base`` in bf16 with f32 parameters, bs 1, 4+1 frames x 6 cameras
at 928x1600, 3 supervised futures, 32768 GT points). ``--model finetune``:
the step of phase 7 (``vidar_finetune_1_8_nusc_3future`` in f32, the same
frames, 40 synthetic GT boxes of 128). Random weights N(0, 1) x 0.02. After
one warm-up step it reports:

* per phase, host clock with a device synchronise around each phase (so
  the phases sum to a little more than a step): the history backbone, the
  current frame's backbone, the history encode, the current encode, the
  rollout (ViDAR) or the detection head (the fine-tune), the head and the
  losses (the fine-tune's with its Hungarian matches on the host), the
  backward pass, the optimizer;
* over one more step under ``torch.profiler``: device time by kernel kind
  (the port's CUDA kernels by name, convolutions, matrix products,
  gathers/scatters, elementwise and reductions, the rest), the device's busy
  time (the union of kernel intervals) and its idle share of the step.

Prints the card (``nvidia-smi`` name and power limit) and a JSON line with
every number. The profiler's own host work lengthens the profiled step, so
its idle share is an upper bound; the unprofiled step time bounds it from
below.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

KINDS = (
    ('K1 msda_forward', ('msda_forward_kernel',)),
    ('K5 msda_backward', ('msda_backward_kernel',)),
    ('K2 dcn_conv_forward', ('dcn_conv',)),
    ('K9 dcn_sample_forward', ('dcn_gather',)),
    ('K3 ray_first_hit_forward', ('ray_first_hit_kernel',)),
    ('K6/K7 ray_first_hit_backward', ('ray_first_hit_backward_kernel',)),
    ('K4 ray_aggregate_forward', ('ray_aggregate_kernel',)),
    ('K8 ray_aggregate_backward', ('ray_aggregate_backward_kernel',)),
    ('convolution (cuDNN)', ('conv', 'cudnn', 'implicit', 'winograd',
                             'fprop', 'dgrad', 'wgrad')),
    ('matrix product (cuBLAS)', ('gemm', 'sm90_xmma', 'cutlass', 'nvjet')),
    ('gather/scatter/index', ('index', 'scatter', 'gather', 'embedding')),
    ('elementwise/reduce/copy', ('elementwise', 'reduce', 'copy', 'fill',
                                 'cat', 'softmax', 'norm', 'where')),
)


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return 'other'


class _PhaseClock:
    """Wraps methods of objects so each outermost call is timed (host clock
    between two device synchronisations)."""

    def __init__(self):
        self.ms = defaultdict(float)
        self._depth = 0

    def wrap(self, obj, method: str, phase: str):
        fn = getattr(obj, method)

        def timed(*args, **kwargs):
            if self._depth:
                return fn(*args, **kwargs)
            self._depth += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self.ms[phase] += (time.perf_counter() - t0) * 1e3
                self._depth -= 1

        setattr(obj, method, timed)


def _busy_ms(events) -> float:
    """Union of the device kernels' intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def _vidar(dev, clock):
    """The pre-training step, its phases wrapped in ``clock``."""
    from ..configs import vidar_base
    from ..data import make_synthetic_batch
    from ..models import ViDAR
    from ..train import TrainStep, make_optimizer

    model = ViDAR(**vidar_base(), dtype=torch.bfloat16, device=dev)
    model.randomize_(torch.Generator(device=dev).manual_seed(2), 0.02)
    batch = make_synthetic_batch(np.random.default_rng(0), bs=1,
                                 queue_length=4, future_length=3,
                                 num_cams=6, img_h=928, img_w=1600,
                                 max_points=32768, device=dev)
    opt = make_optimizer(model, device=dev)
    step = TrainStep(model, opt,
                     generator=torch.Generator(device=dev).manual_seed(3),
                     device=dev)
    step(batch)                                            # warm-up
    head = model.future_pred_head
    clock.wrap(model, 'extract_feats', 'backbone, history frames (no grad)')
    clock.wrap(model, 'extract_feats_cam_seq',
               'backbone, current frame (6 cameras)')
    clock.wrap(model, 'encode_history', 'encode, history frames (no grad)')
    clock.wrap(model, 'encode_single', 'encode, current frame')
    clock.wrap(model, 'rollout', 'rollout, 3 futures')
    clock.wrap(head, 'forward_head', 'head')
    clock.wrap(head, 'loss', 'losses (ray CE x 5 channels, dense)')
    clock.wrap(step, 'backward', 'backward')
    clock.wrap(opt, 'step', 'optimizer (clip + AdamW)')
    return step, batch


def _finetune(dev, clock):
    """The fine-tune step, its phases wrapped in ``clock``."""
    from ..configs import vidar_finetune_1_8_nusc_3future
    from ..data import make_synthetic_det_batch
    from ..models import BEVFormer
    from ..train import DetTrainStep, make_optimizer

    model = BEVFormer(**vidar_finetune_1_8_nusc_3future(), device=dev)
    model.randomize_(torch.Generator(device=dev).manual_seed(4), 0.02)
    batch = make_synthetic_det_batch(np.random.default_rng(0), bs=1,
                                     queue_length=4, num_cams=6, img_h=928,
                                     img_w=1600, max_points=64, max_gt=128,
                                     num_gt=40, device=dev)
    opt = make_optimizer(model, device=dev)
    step = DetTrainStep(model, opt,
                        generator=torch.Generator(device=dev).manual_seed(6),
                        device=dev)
    step(batch)                                            # warm-up
    clock.wrap(model, 'extract_feats', 'backbone, history frames (no grad)')
    clock.wrap(model, 'extract_feats_cam_seq',
               'backbone, current frame (6 cameras)')
    clock.wrap(model, 'obtain_history_bev',
               'encode, history frames (3 frozen, 1 with grad)')
    clock.wrap(model, 'encode_frame', 'encode, current frame')
    clock.wrap(model.pts_bbox_head_det, 'forward',
               'detection head (6 decoder layers)')
    clock.wrap(model, 'loss', 'losses (6 Hungarian matches on the host)')
    clock.wrap(step, 'backward', 'backward')
    clock.wrap(opt, 'step', 'optimizer (clip + AdamW)')
    return step, batch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--model', choices=('vidar', 'finetune'),
                    default='vidar', help='the step to profile')
    ap.add_argument('--steps', type=int, default=2,
                    help='timed steps after the warm-up')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_train: no CUDA device')

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda:0')
    clock = _PhaseClock()
    build = _vidar if args.model == 'vidar' else _finetune
    step, batch = build(dev, clock)
    t_steps = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(batch)
        t_steps.append((time.perf_counter() - t0) * 1e3)
    phases = {k: v / args.steps for k, v in clock.ms.items()}

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kind = defaultdict(float)
    for e in kernels:
        by_kind[_kind(e.name)] += e.time_range.elapsed_us() / 1e3
    busy = _busy_ms(kernels)

    steps_ms = ', '.join(f'{t:.1f}' for t in t_steps)
    print(f'{args.model} train step, host clock with a sync per phase '
          f'(mean of {args.steps}; steps {steps_ms} ms):', flush=True)
    for k, v in phases.items():
        print(f'  {k:45s} {v:9.1f} ms')
    print(f'profiled step: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms,'
          f' idle {100 * (1 - busy / wall_ms):.1f}%')
    for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f'  {k:45s} {v:9.1f} ms')
    print(json.dumps(dict(card=card, model=args.model, step_ms=t_steps,
                          phases_ms=phases,
                          profiled_wall_ms=wall_ms, device_busy_ms=busy,
                          device_ms_by_kind=dict(by_kind),
                          peak_gib=torch.cuda.max_memory_allocated() /
                          2 ** 30)))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
