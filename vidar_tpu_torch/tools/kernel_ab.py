"""Time K1 and K2 of this checkout against another checkout's, on one GPU.

    python -m vidar_tpu_torch.tools.kernel_ab --other PATH [--reps N]

PATH is the root of another checkout of the repository, such as a git
archive of the parent commit. Its kernels are built by its own
``ops/_build.py`` in a subprocess, and its library is loaded beside this
checkout's. Both are called through their C entries (``msda_forward``,
``dcn_conv_forward``, whose signatures both checkouts share) on the same
inputs, in turns (other, this, this, other): CUDA events, the mean of
``--reps`` launches after a warm-up.

The inputs are the first of each case that the bf16 forecast gives K1 and
K2: ``vidar_base`` at ``chip_smoke.py`` phase 2's shapes and weights. K1 is
timed at TSA, SCA and the decoder, and at SCA on f32 values. K2 is timed at
stages 3 and 4 (30 images) and on the first 1 and 24 images of those
inputs, the shapes of the pre-training step's camera-sequential and history
calls. Prints the card and one JSON line: per case, both times in ms and
the largest difference between the two outputs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build, dcn, msda


def _other_library(root: str) -> ctypes.CDLL:
    code = ('import sys; sys.path.insert(0, sys.argv[1]); '
            'from vidar_tpu_torch.ops import _build; '
            'print(_build.load_library()._name)')
    out = subprocess.run([sys.executable, '-c', code, root], check=True,
                         capture_output=True, text=True, cwd=root)
    return _bind(ctypes.CDLL(out.stdout.strip().splitlines()[-1]))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name in ('msda_forward', 'dcn_conv_forward'):
        fn = getattr(lib, name)
        fn.argtypes = list(_build.SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


def _forecast_inputs(dev):
    """{case: kept arguments} of K1 and K2 in one bf16 forecast."""
    from ..configs import vidar_base
    from ..data import make_synthetic_batch
    from ..evals.forecast_runner import ForecastRunner
    from ..models import ViDAR
    cfg = vidar_base()
    cfg['test_future_frame_num'] = 6
    model = ViDAR(**cfg, dtype=torch.bfloat16, device=dev).eval()
    model.randomize_(torch.Generator(device=dev).manual_seed(0), 0.02)
    batch = make_synthetic_batch(np.random.default_rng(0), bs=1,
                                 queue_length=4, future_length=6, num_cams=6,
                                 img_h=928, img_w=1600, max_points=32768,
                                 device=dev)
    kept = {}

    def keeper(case_of):
        def hook(args):
            case = case_of(args)
            if case is not None and case not in kept:
                kept[case] = {k: v.clone() if torch.is_tensor(v) else v
                              for k, v in args.items()}
        return hook

    msda.KERNEL.on_launch = keeper(lambda a: {
        (2, 1): 'K1 tsa', (6, 4): 'K1 sca', (1, 1): 'K1 decoder'}.get(
            (a['value'].shape[0], len(a['spatial_shapes']))))
    dcn.KERNEL.on_launch = keeper(lambda a: {
        256: 'K2 stage3', 512: 'K2 stage4'}.get(a['x'].shape[-1]))
    try:
        ForecastRunner(model, (928, 1600), num_future=6, device=dev)(batch)
    finally:
        msda.KERNEL.on_launch = dcn.KERNEL.on_launch = None
    torch.cuda.synchronize()
    kept['K1 sca,float32'] = dict(kept['K1 sca'],
                                  value=kept['K1 sca']['value'].float())
    for stage in ('stage3', 'stage4'):
        a = kept[f'K2 {stage}']
        for n in (1, 24):
            kept[f'K2 {stage},b{n}'] = {
                k: v[:n].contiguous() if k in ('x', 'sx', 'sy', 'mask') else v
                for k, v in a.items()}
    return kept


def _launcher(lib, case, a, dev):
    """-> (launch function, output tensor) for one kept case."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if case.startswith('K1'):
        v, loc, w = a['value'], a['loc'], a['weights']
        b, v_len, heads, dim = v.shape
        _, q, _, levels, p, _ = loc.shape
        shapes, starts = msda._tables(a['spatial_shapes'], dev)
        out = torch.empty(b, q, heads * dim, device=dev)
        args = (v.data_ptr(), int(v.dtype == torch.bfloat16),
                shapes.data_ptr(), starts.data_ptr(), loc.data_ptr(),
                w.data_ptr(), out.data_ptr(), b, v_len, q, heads, dim, levels,
                p, stream)
        return (lambda: _build.check(lib.msda_forward(*args), case)), out
    x, wt = a['x'], a['weight']
    b, h, w_, c = x.shape
    q, co = a['sx'].shape[1], wt.shape[1]
    out = torch.empty(b, q, co, device=dev)
    args = (x.data_ptr(), a['sx'].data_ptr(), a['sy'].data_ptr(),
            a['mask'].data_ptr(), wt.data_ptr(), out.data_ptr(), b, h, w_, c,
            q, co, stream)
    return (lambda: _build.check(lib.dcn_conv_forward(*args), case)), out


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--other', required=True,
                    help='root of the other checkout')
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('kernel_ab: no CUDA device', file=sys.stderr)
        return 2
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device('cuda:0')
    other = _other_library(args.other)
    this = _bind(_build.load_library())
    results = {}
    for case, a in _forecast_inputs(dev).items():
        run_other, out_other = _launcher(other, case, a, dev)
        run_this, out_this = _launcher(this, case, a, dev)
        t = [_time_ms(f, args.reps)
             for f in (run_other, run_this, run_this, run_other)]
        diff = (out_this - out_other).abs().max().item()
        results[case] = dict(other_ms=(t[0] + t[3]) / 2,
                             this_ms=(t[1] + t[2]) / 2, max_abs_diff=diff)
        print(f'{case}: other {t[0]:.4f} {t[3]:.4f} ms, this {t[1]:.4f} '
              f'{t[2]:.4f} ms, max |this - other| {diff:.3g}', flush=True)
    print(json.dumps({'card': card, 'cases': results}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
