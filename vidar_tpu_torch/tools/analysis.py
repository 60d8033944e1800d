"""Analysis tools (port of vidar_tpu/tools/analysis.py): forecast
benchmark, parameter counter, train-log analyzer, profiler trace and the
SCA visibility scan.

Capability matches:
  * benchmark       <- tools/analysis_tools/benchmark.py:70-95 (inference
                       samples/s of ``ViDAR`` in bf16 at 928x1600)
  * count_params    <- tools/analysis_tools/get_params.py
  * analyze_logs    <- tools/analysis_tools/analyze_logs.py (the train
                       CLI's ``[it/total] {json}`` lines)
  * profile_trace   -> a ``torch.profiler`` Chrome trace of one forecast
  * visibility_scan -> per-camera visible-query statistics of a dataset

Usage (subcommands ``benchmark``, ``get-params``, ``profile``,
``analyze-logs``, ``visibility``):
    python -m vidar_tpu_torch.tools.analysis get-params CONFIG
    python -m vidar_tpu_torch.tools.analysis benchmark CONFIG [--samples N]
    python -m vidar_tpu_torch.tools.analysis profile CONFIG [--out-dir DIR]
    python -m vidar_tpu_torch.tools.analysis analyze-logs LOG [--keys ...]
    python -m vidar_tpu_torch.tools.analysis visibility CONFIG
        [--max-samples N]
``benchmark`` and ``profile`` run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from typing import Dict, Tuple


def _forecast(config: str, cfg_options, device):
    """The bf16 ``ViDAR`` of ``config`` (weights from ``init_weights_``,
    seed 0), its ``ForecastRunner`` and a synthetic batch of one sample at
    928x1600 with 32768 rays, on ``device``."""
    import numpy as np
    import torch
    from ..core.builder import build_model
    from ..core.config import apply_overrides, load_config
    from ..data import make_synthetic_batch
    from ..device import resolve_device
    from ..evals.forecast_runner import ForecastRunner

    dev = resolve_device(device)
    cfg = apply_overrides(load_config(config), cfg_options)
    m = cfg['model']
    model = build_model(m, dtype=torch.bfloat16, device=dev).eval()
    model.init_weights_(torch.Generator(device=dev).manual_seed(0))
    batch = make_synthetic_batch(
        np.random.default_rng(0), bs=1,
        queue_length=m['history_queue_length'],
        future_length=m['test_future_frame_num'],
        num_cams=m['num_cams'], img_h=928, img_w=1600, max_points=32768,
        device=dev)
    runner = ForecastRunner(model, (928, 1600),
                            num_future=m['test_future_frame_num'],
                            device=dev)
    return runner, batch, dev


def _sync(dev):
    import torch
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def benchmark(config: str, samples: int = 20, warmup: int = 3,
              cfg_options=None, device='cuda') -> float:
    """Forecast samples/s of the config's ``ViDAR`` in bf16 at 928x1600
    (the first call and ``warmup`` more untimed)."""
    runner, batch, dev = _forecast(config, cfg_options, device)
    runner(batch)
    _sync(dev)
    for _ in range(warmup):
        runner(batch)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(samples):
        runner(batch)
    _sync(dev)
    fps = samples / (time.perf_counter() - t0)
    print(f'Overall fps: {fps:.3f} samples/s')
    return fps


def param_counts(model) -> Tuple[int, Dict[str, int]]:
    """(elements of every state-dict tensor, {top-level module: its
    elements}). The state dict holds the frozen BatchNorms' folded scale
    and bias as buffers, which JAX's init tree holds as parameters, so the
    counts equal the JAX package's."""
    total, by_top = 0, {}
    for name, t in model.state_dict().items():
        top = name.split('.', 1)[0]
        by_top[top] = by_top.get(top, 0) + t.numel()
        total += t.numel()
    return total, by_top


def count_params(config: str, cfg_options=None) -> int:
    """Print and return the element count of the config's model (any
    registered type; built on the CPU, no weights drawn)."""
    from ..core.builder import build_model
    from ..core.config import apply_overrides, load_config

    cfg = apply_overrides(load_config(config), cfg_options)
    total, by_top = param_counts(build_model(cfg['model'], device='cpu'))
    print(f'total params: {total / 1e6:.2f} M')
    for k, v in sorted(by_top.items(), key=lambda kv: -kv[1]):
        print(f'  {k}: {v / 1e6:.2f} M')
    return total


def analyze_logs(log_file: str, keys=('loss',)):
    """Parse the train CLI's json log lines and print loss statistics."""
    hist = {k: [] for k in keys}
    pat = re.compile(r'\[(\d+)/(\d+)\] (\{.*\})')
    with open(log_file) as f:
        for line in f:
            m = pat.search(line)
            if not m:
                continue
            rec = json.loads(m.group(3))
            for k in keys:
                if k in rec:
                    hist[k].append((int(m.group(1)), rec[k]))
    for k, vals in hist.items():
        if not vals:
            continue
        v = [x[1] for x in vals]
        print(f'{k}: n={len(v)} first={v[0]:.4f} last={v[-1]:.4f} '
              f'min={min(v):.4f}')
    return hist


def profile_trace(config: str, out_dir: str = '/tmp/torch_trace',
                  cfg_options=None, device='cuda') -> str:
    """A ``torch.profiler`` Chrome trace (host and device activity, the
    ``core.timing`` spans of the forecast's phases) of one forecast of the
    config's bf16 ``ViDAR``, after an untimed one -> the trace's path,
    ``out_dir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    runner, batch, dev = _forecast(config, cfg_options, device)
    runner(batch)                               # warm-up outside the trace
    _sync(dev)
    activities = [ProfilerActivity.CPU]
    if dev.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        runner(batch)
        _sync(dev)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, 'trace.json')
    prof.export_chrome_trace(path)
    print(f'trace written to {path}')
    return path


def visibility_scan(config: str, max_samples: int = None, cfg_options=None):
    """Per-camera visible-query statistics from the dataset's calibration.

    Grounds ``model.sca_capacity_ratio``: the SCA compaction keeps a static
    ``cap = ratio * bev_h * bev_w`` queries per camera; any sample whose
    per-camera visibility exceeds the cap loses parity (reference
    spatial_cross_attention.py:135-166 never drops a visible query). This
    scans every (sample, frame, camera) of the configured train split,
    reports the visibility distribution, and prints the minimum safe
    capacity_ratio (peak + suggested 5% margin). Host numpy end to end.
    """
    import numpy as np
    from ..core.builder import build_dataset
    from ..core.config import apply_overrides, load_config
    from ..models.encoder import reference_points_3d

    cfg = apply_overrides(load_config(config), cfg_options)
    m = cfg['model']
    bev_h, bev_w = m.get('bev_h', 200), m.get('bev_w', 200)
    pc = m.get('pc_range', (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0))
    n = bev_h * bev_w
    ref = reference_points_3d(bev_h, bev_w, pc[5] - pc[2], 4)  # [D, N, 3]
    xyz = np.stack([ref[..., 0] * (pc[3] - pc[0]) + pc[0],
                    ref[..., 1] * (pc[4] - pc[1]) + pc[1],
                    ref[..., 2] * (pc[5] - pc[2]) + pc[2]], -1)
    homo = np.concatenate([xyz, np.ones_like(xyz[..., :1])], -1)  # [D,N,4]

    dataset = build_dataset(cfg['data']['train'])
    n_samples = min(len(dataset), max_samples or len(dataset))
    peak, fracs = 0, []
    for i in range(n_samples):
        sample = dataset[i]
        batch = sample.frames if hasattr(sample, 'frames') else sample
        l2i = np.asarray(batch.lidar2img, np.float32)
        img_h, img_w = batch.images.shape[3:5]
        l2i = l2i.reshape(-1, 4, 4)
        proj = np.einsum('cij,dnj->cdni', l2i, homo)
        z = proj[..., 2]
        with np.errstate(invalid='ignore', divide='ignore'):
            x = proj[..., 0] / np.maximum(z, 1e-5) / img_w
            y = proj[..., 1] / np.maximum(z, 1e-5) / img_h
        vis = ((z > 1e-5) & (x > 0) & (x < 1) & (y > 0) & (y < 1))
        count = vis.any(axis=1).sum(axis=-1)  # [frames*cams]
        peak = max(peak, int(count.max()))
        fracs.append(count / n)
        if (i + 1) % 50 == 0:
            print(f'[{i + 1}/{n_samples}] running peak '
                  f'{peak / n:.4f}')
    fracs = np.concatenate(fracs)
    report = {
        'samples_scanned': n_samples,
        'per_camera_frames': int(fracs.size),
        'visible_frac_mean': round(float(fracs.mean()), 4),
        'visible_frac_p99': round(float(np.percentile(fracs, 99)), 4),
        'visible_frac_peak': round(peak / n, 4),
        'min_safe_capacity_ratio': round(peak / n, 4),
        'suggested_capacity_ratio': round(min(1.0, peak / n * 1.05), 4),
    }
    print(json.dumps(report, indent=2))
    return report


def main(argv=None):
    """-> what the subcommand's function returns."""
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest='cmd', required=True)
    v = sub.add_parser('visibility')
    v.add_argument('config')
    v.add_argument('--max-samples', type=int, default=None)
    v.add_argument('--cfg-options', nargs='+', default=None)
    for name in ('benchmark', 'get-params', 'profile'):
        s = sub.add_parser(name)
        s.add_argument('config')
        s.add_argument('--cfg-options', nargs='+', default=None)
        if name == 'benchmark':
            s.add_argument('--samples', type=int, default=20)
        if name == 'profile':
            s.add_argument('--out-dir', default='/tmp/torch_trace')
        if name != 'get-params':
            s.add_argument('--device', default='cuda',
                           help='torch device (default cuda; cpu only on '
                                'request)')
    a = sub.add_parser('analyze-logs')
    a.add_argument('log_file')
    a.add_argument('--keys', nargs='+', default=['loss'])
    args = p.parse_args(argv)
    if args.cmd == 'benchmark':
        return benchmark(args.config, samples=args.samples,
                         cfg_options=args.cfg_options, device=args.device)
    if args.cmd == 'get-params':
        return count_params(args.config, cfg_options=args.cfg_options)
    if args.cmd == 'profile':
        return profile_trace(args.config, args.out_dir,
                             cfg_options=args.cfg_options,
                             device=args.device)
    if args.cmd == 'analyze-logs':
        return analyze_logs(args.log_file, args.keys)
    return visibility_scan(args.config, max_samples=args.max_samples,
                           cfg_options=args.cfg_options)


if __name__ == '__main__':
    main()
