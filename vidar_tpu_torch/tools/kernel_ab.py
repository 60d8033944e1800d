"""Time K1-K6 and K8-K10 of this checkout against other checkouts', on
one GPU.

    python -m vidar_tpu_torch.tools.kernel_ab --other PATH [--other PATH ...]
        [--kernels K1 K2 K3 K4 K5 K6 K8 K9 K10] [--reps N]

Each PATH is the root of another checkout of the repository, such as a git
archive of the parent commit. Its kernels are built by its own
``ops/_build.py`` in a subprocess, and its library is loaded beside this
checkout's. Both are called through their C entries (``msda_forward``,
``dcn_conv_forward``, ``ray_first_hit_forward``, ``ray_aggregate_forward``,
``msda_backward``, ``ray_first_hit_backward``, ``ray_aggregate_backward``,
``dcn_sample_forward``, ``dcn_sample16_forward``, whose signatures the
checkouts share) on the same inputs, in turns for each other checkout
(other, this, this, other): CUDA events around ``--reps`` launches after a
warm-up, queued behind a sleep kernel so that the host's launch cost does
not enter a short kernel's time (device time). The gradients of K5, K6/K7
(``K6``) and K8 are zeroed before the launch whose output is compared, not
before the timed ones (their atomics then add onto the previous sums, at
the same cost).

The inputs are the first of each case that the main paths give the kernels,
at ``chip_smoke.py``'s shapes and weights:
- the bf16 forecast of ``vidar_base`` (phase 2): K1 at TSA, SCA and the
  decoder, and at SCA on f32 values; K2 at stages 3 and 4 (30 images) and on
  the first 1 and 24 images of those inputs, the shapes of the pre-training
  step's camera-sequential and history calls; K3 on the bf16 occupancy and
  K4 on the fused map;
- the bf16 pre-training step (phase 5): K5 at TSA, SCA and the decoder,
  K6/K7 and K8 on its bf16 maps;
- the f32 full-window eval of ``vidar_finetune_1_8_nusc_3future`` (phase 6):
  K9 at stages 3 and 4 (30 images);
- the f32 fine-tune step of the same model (phase 7): K5 at its TSA, SCA
  and detection decoder, K3 on its f32 occupancy, K4 on its f32 fused map,
  K6/K7 and K8 on its f32 maps, and K9 at stages 3 and 4 on the history's
  24 images (``b24``) and on one camera-sequential image (``b1``);
- the bf16 forecast with a deformable conv in every ResNet stage (phase 8):
  K10 at stage 1 (30 images, C = 64).
K6/K7 and K8 also run each step's input with the map cast to the other
dtype (cases ``... as f32``, ``... as bf16``), and their lines give the
share of the upstream gradient's elements and cells (rows) that are zero:
whether the map's dtype or the gradient's zeros set a backward's time.
K8's lines also count, from the case's geometry and g, the valid
waypoints a cell and the float4 reductions of the vector kernel's scatter
before and after it merges the corner rows neighbouring waypoints share.
Prints the card and one JSON line: per case and other checkout, both times
in ms and the largest difference between the two outputs (one per output;
K9's and K10's taps must be equal, a difference of 0), beside the largest
magnitude of this checkout's output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build, dcn, latent_render, msda

KERNELS = ('K1', 'K2', 'K3', 'K4', 'K5', 'K6', 'K8', 'K9', 'K10')
ENTRIES = ('msda_forward', 'dcn_conv_forward', 'ray_first_hit_forward',
           'ray_aggregate_forward', 'msda_backward', 'ray_first_hit_backward',
           'ray_aggregate_backward', 'dcn_sample_forward',
           'dcn_sample16_forward')
# a sleep kernel of ~5 ms (at the H100's 1.98 GHz boost clock or below)
# that outlasts the host's queueing of the timed launches
SLEEP_CYCLES = 10_000_000
# chip_smoke.py's shapes: bs 1, 4+1 frames, 6 cameras at 928x1600
BATCH = dict(bs=1, queue_length=4, num_cams=6, img_h=928, img_w=1600)


def _other_library(root: str) -> ctypes.CDLL:
    code = ('import sys; sys.path.insert(0, sys.argv[1]); '
            'from vidar_tpu_torch.ops import _build; '
            'print(_build.load_library()._name)')
    out = subprocess.run([sys.executable, '-c', code, root], check=True,
                         capture_output=True, text=True, cwd=root)
    return _bind(ctypes.CDLL(out.stdout.strip().splitlines()[-1]))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = list(_build.SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


def _keeper(kept, case_of):
    """A launch hook that keeps (cloned) the first arguments of each case
    ``case_of`` names."""
    def hook(args):
        case = case_of(args)
        if case is not None and case not in kept:
            kept[case] = {k: v.clone() if torch.is_tensor(v) else v
                          for k, v in args.items()}
    return hook


def _msda_case(prefix, suffix):
    names = {(2, 1): 'tsa', (6, 4): 'sca', (1, 1): 'decoder'}

    def case_of(a):
        name = names.get((a['value'].shape[0], len(a['spatial_shapes'])))
        return name and f'{prefix} {name}{suffix}'
    return case_of


def _run_hooked(hooks, fn):
    for counter, hook in hooks.items():
        counter.on_launch = hook
    try:
        fn()
    finally:
        for counter in hooks:
            counter.on_launch = None
    torch.cuda.synchronize()


def _dcn_case(kernel, args, images=(30,)):
    """'K2 stage3' ... by ResNet stage (C = 256 or 512), with ',b1' or
    ',b24' unless the call has the 30 images of a window; None for a call
    of another stage or image count."""
    stage = {256: 'stage3', 512: 'stage4'}.get(args['x'].shape[-1])
    b = args['x'].shape[0]
    if stage is None or b not in images:
        return None
    return f'{kernel} {stage}' + ('' if b == 30 else f',b{b}')


def _forecast_inputs(dev, kept, kernels):
    """K1-K4 cases of one bf16 forecast (chip_smoke.py phase 2)."""
    from ..configs import vidar_base
    from ..data import make_synthetic_batch
    from ..evals.forecast_runner import ForecastRunner
    from ..models import ViDAR
    cfg = vidar_base()
    cfg['test_future_frame_num'] = 6
    model = ViDAR(**cfg, dtype=torch.bfloat16, device=dev).eval()
    model.randomize_(torch.Generator(device=dev).manual_seed(0), 0.02)
    batch = make_synthetic_batch(np.random.default_rng(0), future_length=6,
                                 max_points=32768, device=dev, **BATCH)
    hooks = {
        msda.KERNEL: _keeper(kept, _msda_case('K1', '')),
        dcn.KERNEL: _keeper(kept, lambda a: _dcn_case('K2', a)),
        latent_render.FIRST_HIT: _keeper(kept, lambda a: 'K3 forecast,bf16'),
        latent_render.AGGREGATE: _keeper(kept,
                                         lambda a: 'K4 forecast,bf16')}
    _run_hooked(hooks, lambda: ForecastRunner(
        model, (928, 1600), num_future=6, device=dev)(batch))
    if 'K1' in kernels:
        kept['K1 sca,float32'] = dict(kept['K1 sca'],
                                      value=kept['K1 sca']['value'].float())
    for stage in ('stage3', 'stage4'):
        a = kept[f'K2 {stage}']
        for n in (1, 24):
            kept[f'K2 {stage},b{n}'] = {
                k: v[:n].contiguous() if k in ('x', 'sx', 'sy', 'mask') else v
                for k, v in a.items()}


def _ray_backward_hooks(kept, kernels, case):
    """Keepers of the K6/K7 and K8 inputs of a step, by ``case``."""
    hooks = {}
    if 'K6' in kernels:
        hooks[latent_render.FIRST_HIT_BACKWARD] = _keeper(
            kept, lambda a: f'K6 {case}')
    if 'K8' in kernels:
        hooks[latent_render.AGGREGATE_BACKWARD] = _keeper(
            kept, lambda a: f'K8 {case}')
    return hooks


def _recast(kept, case, other):
    """A copy of the kept K6/K7 or K8 case with its map cast to ``other``
    (case ``<case> as <dtype>``)."""
    a = kept[case]
    key = 'occ' if 'occ' in a else 'fused_map'
    name = {torch.float32: 'f32', torch.bfloat16: 'bf16'}[other]
    kept[f'{case} as {name}'] = dict(a, **{key: a[key].to(other)})


def _pretrain_inputs(dev, kept, kernels):
    """K5, K6/K7 and K8 cases of one bf16 pre-training step (chip_smoke.py
    phase 5)."""
    from ..configs import vidar_base
    from ..data import make_synthetic_batch
    from ..models import ViDAR
    from ..train import TrainStep, make_optimizer
    model = ViDAR(**vidar_base(), dtype=torch.bfloat16, device=dev)
    model.randomize_(torch.Generator(device=dev).manual_seed(2), 0.02)
    batch = make_synthetic_batch(np.random.default_rng(0), future_length=3,
                                 max_points=32768, device=dev, **BATCH)
    step = TrainStep(model, make_optimizer(model, device=dev),
                     generator=torch.Generator(device=dev).manual_seed(3),
                     device=dev)
    hooks = _ray_backward_hooks(kept, kernels, 'pretrain,bf16')
    if 'K5' in kernels:
        hooks[msda.BACKWARD] = _keeper(kept, _msda_case('K5', ',bf16'))
    _run_hooked(hooks, lambda: step(batch))
    for k in ('K6', 'K8'):
        if k in kernels:
            _recast(kept, f'{k} pretrain,bf16', torch.float32)


def _finetune_inputs(dev, kept, kernels):
    """K9 cases of one f32 full-window eval (chip_smoke.py phase 6), and K3,
    K4, K5, K6/K7, K8 and K9 cases of one f32 fine-tune step (phase 7)."""
    from ..configs import vidar_finetune_1_8_nusc_3future
    from ..data import make_synthetic_det_batch
    from ..evals.det_runner import DetectionRunner
    from ..models import BEVFormer
    from ..train import DetTrainStep, make_optimizer
    det = BEVFormer(**vidar_finetune_1_8_nusc_3future(), device=dev)
    det.randomize_(torch.Generator(device=dev).manual_seed(4), 0.02)
    batch = make_synthetic_det_batch(np.random.default_rng(0), max_points=64,
                                     max_gt=128, num_gt=40, device=dev,
                                     **BATCH)
    if 'K9' in kernels:
        det.eval()
        _run_hooked({dcn.SAMPLE: _keeper(kept, lambda a: _dcn_case('K9', a))},
                    lambda: DetectionRunner(det, device=dev)(batch))
    step = DetTrainStep(det, make_optimizer(det, device=dev),
                        generator=torch.Generator(device=dev).manual_seed(6),
                        device=dev)
    hooks = _ray_backward_hooks(kept, kernels, 'finetune,f32')
    hooks.update({msda.BACKWARD: _keeper(kept, _msda_case('K5', ',f32 ft')),
                  latent_render.FIRST_HIT: _keeper(
                      kept, lambda a: 'K3 finetune,f32'),
                  latent_render.AGGREGATE: _keeper(
                      kept, lambda a: 'K4 finetune,f32'),
                  dcn.SAMPLE: _keeper(kept, lambda a: _dcn_case('K9', a,
                                                                (1, 24)))})
    _run_hooked(hooks, lambda: step(batch))
    for k in ('K6', 'K8'):
        if k in kernels:
            _recast(kept, f'{k} finetune,f32', torch.bfloat16)


def _all_dcn_inputs(dev, kept):
    """The K10 case of one bf16 forecast with a deformable conv in every
    ResNet stage (chip_smoke.py phase 8): stage 1, C = 64."""
    from ..configs import vidar_base
    from ..data import make_synthetic_batch
    from ..evals.forecast_runner import ForecastRunner
    from ..models import ViDAR
    cfg = vidar_base(backbone_dcn=(True,) * 4)
    model = ViDAR(**cfg, dtype=torch.bfloat16, device=dev).eval()
    model.randomize_(torch.Generator(device=dev).manual_seed(7), 0.02)
    batch = make_synthetic_batch(np.random.default_rng(0), future_length=6,
                                 max_points=32768, device=dev, **BATCH)
    _run_hooked({dcn.SAMPLE16: _keeper(
        kept, lambda a: 'K10 stage1' if a['x'].shape[-1] == 64 else None)},
        lambda: ForecastRunner(model, (928, 1600), num_future=6,
                               device=dev)(batch))


def _aggregate_rows(a):
    """For a K8 case, from its geometry and g: the valid (cell, waypoint)
    pairs a cell, and the float4 reductions of the vector kernel's walk 2
    before and after its merge (the cells with a non-zero g: a corner row
    on the map is CT / 4 float4s; each of the 32 / (CT / 8) lane groups
    takes a run of consecutive listed waypoints of each batch of 32 and
    merges a row into the next waypoint's where that waypoint has it too)
    -> (pairs a cell, before, after)."""
    fm, g, rn, steps = a['fused_map'], a['g'], a['radial_norm'], a['steps']
    _, h, w, ct = fm.shape
    groups = 32 // (ct // 8)
    way = (0.5 + rn[:, None, :] * steps[None, :, None]) * 2.0 - 1.0
    boundary = torch.minimum(1.0 / rn[:, 0].abs(), 1.0 / rn[:, 1].abs())
    valid = torch.sqrt((way ** 2).sum(-1)) < boundary[:, None]   # [N, G]
    x0 = torch.floor(((way[..., 0] + 1.0) * w - 1.0) * 0.5).long()
    y0 = torch.floor(((way[..., 1] + 1.0) * h - 1.0) * 0.5).long()
    pix = []
    for c in range(4):
        ix, iy = x0 + (c & 1), y0 + (c >> 1)
        on = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        pix.append(torch.where(on, iy * w + ix, -1))
    pix = torch.where(valid[..., None], torch.stack(pix, -1), -1)
    # the batches of 32 waypoints, each batch's valid ones first, in order
    n, ng = valid.shape
    pad = -ng % 32
    valid = torch.nn.functional.pad(valid, (0, pad)).view(n, -1, 32)
    pix = torch.nn.functional.pad(pix, (0, 0, 0, pad), value=-1).view(
        n, -1, 32, 4)
    listed = torch.argsort((~valid).byte(), dim=-1, stable=True)
    pix = torch.gather(pix, 2, listed[..., None].expand(-1, -1, -1, 4))
    n_in = valid.sum(-1, keepdim=True)                        # [N, nb, 1]
    run = (n_in + groups - 1) // groups
    k = torch.arange(32, device=pix.device)
    group = k // run.clamp(min=1)
    same = (k[:-1] + 1 < n_in) & (group[..., :-1] == group[..., 1:])
    shared = ((pix[..., :-1, :, None] == pix[..., 1:, None, :]) &
              (pix[..., :-1, :, None] >= 0)).any(-1).sum(-1)
    rows = (pix >= 0).sum((1, 2, 3)).double()
    merged = rows - (shared * same).sum((1, 2)).double()
    live = (g != 0).any(-1).double()                          # [B, N]
    return (valid.sum().item() / n, (live @ rows).sum().item() * ct // 4,
            (live @ merged).sum().item() * ct // 4)


def _launcher(lib, case, a, dev):
    """-> (launch function, reset function, output tensors) for one kept
    case."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    kind = case.split()[0]
    if kind in ('K1', 'K5'):
        v, loc, w = a['value'], a['loc'], a['weights']
        b, v_len, heads, dim = v.shape
        _, q, _, levels, p, _ = loc.shape
        shapes, starts = msda._tables(a['spatial_shapes'], dev)
        head = (v.data_ptr(), int(v.dtype == torch.bfloat16),
                shapes.data_ptr(), starts.data_ptr(), loc.data_ptr(),
                w.data_ptr())
        tail = (b, v_len, q, heads, dim, levels, p, stream)
        if kind == 'K1':
            out = torch.empty(b, q, heads * dim, device=dev)
            args = head + (out.data_ptr(),) + tail
            return (lambda: _build.check(lib.msda_forward(*args), case),
                    lambda: None, [out])
        outs = [torch.zeros(v.shape, device=dev), torch.empty_like(loc),
                torch.empty_like(w)]
        args = head + (a['dout'].data_ptr(),) + tuple(
            t.data_ptr() for t in outs) + tail
        return (lambda: _build.check(lib.msda_backward(*args), case),
                outs[0].zero_, outs)
    if kind == 'K3':
        occ = a['occ']
        b, h, w_, z = occ.shape
        n, g = a['grids'].shape[0], a['steps'].shape[0]
        out = torch.empty(b, n, z, device=dev)
        args = (occ.data_ptr(), int(occ.dtype == torch.bfloat16),
                a['grids'].data_ptr(), a['radial_norm'].data_ptr(),
                a['steps'].data_ptr(), out.data_ptr(), b, h, w_, z, n, g,
                int(a['act'] == 'exp'), stream)
        return (lambda: _build.check(lib.ray_first_hit_forward(*args), case),
                lambda: None, [out])
    if kind == 'K6':
        occ, g = a['occ'], a['g']
        b, h, w_, z = occ.shape
        n, ng = a['grids'].shape[0], a['steps'].shape[0]
        out = torch.zeros(b, h, w_, z, device=dev)
        args = (occ.data_ptr(), int(occ.dtype == torch.bfloat16),
                a['grids'].data_ptr(), a['radial_norm'].data_ptr(),
                a['steps'].data_ptr(), g.data_ptr(), out.data_ptr(), b, h, w_,
                z, n, ng, int(a['act'] == 'exp'), stream)
        return (lambda: _build.check(lib.ray_first_hit_backward(*args), case),
                out.zero_, [out])
    if kind == 'K8':
        fm, g = a['fused_map'], a['g']
        b, h, w_, ct = fm.shape
        n, ng = a['grids'].shape[0], a['steps'].shape[0]
        out = torch.zeros(b, h, w_, ct, device=dev)
        args = (fm.data_ptr(), int(fm.dtype == torch.bfloat16),
                a['grids'].data_ptr(), a['radial_norm'].data_ptr(),
                a['steps'].data_ptr(), g.data_ptr(), out.data_ptr(), b, h, w_,
                ct, a['c_r'], a['zdim'], n, ng, float(a['eps']), stream)
        return (lambda: _build.check(lib.ray_aggregate_backward(*args), case),
                out.zero_, [out])
    if kind in ('K9', 'K10'):
        x = a['x']
        b, h, w_, c = x.shape
        q = a['sx'].shape[1]
        if kind == 'K9':
            out = torch.empty(b, q, dcn.TAPS, c, device=dev)
            entry = lib.dcn_sample_forward
        else:
            out = torch.empty(b, q, dcn.TAPS * c, dtype=torch.bfloat16,
                              device=dev)
            entry = lib.dcn_sample16_forward
        args = (x.data_ptr(), a['sx'].data_ptr(), a['sy'].data_ptr(),
                a['mask'].data_ptr(), out.data_ptr(), b, h, w_, c, q, stream)
        return (lambda: _build.check(entry(*args), case), lambda: None,
                [out])
    if kind == 'K4':
        fm = a['fused_map']
        b, h, w_, ct = fm.shape
        n, g = a['grids'].shape[0], a['steps'].shape[0]
        out = torch.empty(b, n, a['c_r'], device=dev)
        args = (fm.data_ptr(), int(fm.dtype == torch.bfloat16),
                a['grids'].data_ptr(), a['radial_norm'].data_ptr(),
                a['steps'].data_ptr(), out.data_ptr(), b, h, w_, ct,
                a['c_r'], a['zdim'], n, g, float(a['eps']), stream)
        return (lambda: _build.check(lib.ray_aggregate_forward(*args), case),
                lambda: None, [out])
    x, wt = a['x'], a['weight']
    b, h, w_, c = x.shape
    q, co = a['sx'].shape[1], wt.shape[1]
    out = torch.empty(b, q, co, device=dev)
    args = (x.data_ptr(), a['sx'].data_ptr(), a['sy'].data_ptr(),
            a['mask'].data_ptr(), wt.data_ptr(), out.data_ptr(), b, h, w_, c,
            q, co, stream)
    return (lambda: _build.check(lib.dcn_conv_forward(*args), case),
            lambda: None, [out])


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)  # the launches queue behind it
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _outputs(run, reset, outs):
    reset()
    run()
    torch.cuda.synchronize()
    return [o.clone() for o in outs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--other', required=True, action='append',
                    help='root of another checkout (repeatable)')
    ap.add_argument('--kernels', nargs='+', choices=KERNELS,
                    default=list(KERNELS))
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
    others = {root: _other_library(root) for root in args.other}
    this = _bind(_build.load_library())
    kept = {}
    if {'K1', 'K2', 'K3', 'K4'} & set(args.kernels):
        _forecast_inputs(dev, kept, args.kernels)
    if {'K5', 'K6', 'K8'} & set(args.kernels):
        _pretrain_inputs(dev, kept, args.kernels)
    if {'K3', 'K4', 'K5', 'K6', 'K8', 'K9'} & set(args.kernels):
        _finetune_inputs(dev, kept, args.kernels)
    if 'K10' in args.kernels:
        _all_dcn_inputs(dev, kept)
    torch.cuda.empty_cache()
    results = {}
    for case, a in sorted(kept.items()):
        if case.split()[0] not in args.kernels:
            continue
        run_this, reset_this, out_this = _launcher(this, case, a, dev)
        want = _outputs(run_this, reset_this, out_this)
        scale = [w.abs().max().item() for w in want]
        results[case] = {}
        if 'g' in a:  # a backward's upstream gradient: its zeros
            zero = a['g'] == 0
            share = dict(elements=zero.float().mean().item(),
                         rows=zero.all(-1).float().mean().item())
            results[case]['g_zero_share'] = share
            print(f'{case}: g == 0 in {share["elements"]:.4f} of its '
                  f'elements, {share["rows"]:.4f} of its rows', flush=True)
        if case.startswith('K8'):
            pairs, before, after = _aggregate_rows(a)
            results[case]['reductions'] = dict(
                valid_per_cell=pairs, before_merge=before, after_merge=after)
            print(f'{case}: {pairs:.2f} valid waypoints a cell; walk 2 '
                  f'{before / 1e6:.2f}M float4 reductions before the merge, '
                  f'{after / 1e6:.2f}M after ({after / before:.1%})',
                  flush=True)
        for root, lib in others.items():
            run_other, reset_other, out_other = _launcher(lib, case, a, dev)
            t = [_time_ms(f, args.reps)
                 for f in (run_other, run_this, run_this, run_other)]
            got = _outputs(run_other, reset_other, out_other)
            diff = [(x - y).abs().max().item() for x, y in zip(want, got)]
            results[case][root] = dict(other_ms=(t[0] + t[3]) / 2,
                                       this_ms=(t[1] + t[2]) / 2,
                                       max_abs_diff=diff, max_abs=scale)
            print(f'{case} vs {root}: other {t[0]:.4f} {t[3]:.4f} ms, this '
                  f'{t[1]:.4f} {t[2]:.4f} ms, max |this - other| '
                  f'{" ".join(f"{d:.3g}" for d in diff)} (max |this| '
                  f'{" ".join(f"{m:.3g}" for m in scale)})', flush=True)
            del got, out_other
        del want, out_this
    print(json.dumps({'card': card, 'cases': results}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
