"""Chip smoke test of the PyTorch/CUDA port: the ViDAR forecast on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero and prints no
result line):

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the TF32 switches, set explicitly;
1. the build of the four CUDA kernels from ``vidar_tpu_torch/csrc``;
2. one full forecast of ``vidar_base`` in bf16 at the nuScenes shapes of
   bench.py (bs 1, 4+1 frames, 6 cameras, 928x1600, 6 futures, 32768 rays),
   random weights (N(0, 1) x 0.02 from a seeded generator), through
   ``ForecastRunner``; every kernel's launch count must be > 0, and each
   kernel's first input is kept;
   then the small-input check: ``vidar_tiny`` at the bench.py smoke shapes,
   on the card (kernels) and on the CPU (plain versions), same weights and
   batch;
3. each kernel against its plain PyTorch version on the kept inputs, error
   and CUDA-event times of both;
4. a second, timed forecast: seconds, samples/s, peak device memory.

The line before the last is a JSON object of per-kernel results; the last
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel-vs-plain tolerances: max |kernel - plain| <= ATOL + RTOL * max|plain|.
# Both sides read the same inputs and compute the same products; what may
# differ is the order of f32 sums (and, for K3, the activation's last bit).
TOLERANCES = {
    # sums of <= 32 samples x 4 corners in another order
    'msda_forward': (1e-5, 1e-4),
    # identical bf16 taps, exact bf16 products; f32 accumulation of
    # 9*C = 2304..4608 terms in another order
    'dcn_conv_forward': (0.0, 1e-3),
    # outputs in [0, 1]: a product of <= 257 factors in another order and
    # expf's last-bit rounding
    'ray_first_hit_forward': (1e-4, 0.0),
    # two sums over <= 256 waypoints in another order, then one division
    'ray_aggregate_forward': (1e-5, 1e-4),
}


def _nvidia_smi() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps=3) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _unit_scale_(model, generator):
    """Random weights with unit-scale activations for the small-input
    check: kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1), biases
    N(0, 0.1), embeddings N(0, 1)."""
    with torch.no_grad():
        for name, t in model.state_dict().items():
            r = torch.randn(t.shape, generator=generator,
                            device=generator.device)
            leaf = name.rsplit('.', 1)[-1]
            if leaf == 'kernel':              # deformable conv [9*C, CO]
                r = r / t.shape[0] ** 0.5
            elif leaf == 'weight' and t.dim() >= 2:   # Dense, conv
                r = r / float(np.prod(t.shape[1:])) ** 0.5
            elif leaf in ('weight', 'scale'):  # LayerNorm, frozen BN
                r = 1.0 + 0.1 * r
            elif leaf == 'bias':
                r = 0.1 * r
            t.copy_(r)


class _Keeper:
    """Keeps (cloned) the first input a kernel gets for each case."""

    def __init__(self, case_of):
        self.case_of = case_of
        self.inputs = {}

    def __call__(self, args):
        case = self.case_of(args)
        if case is not None and case not in self.inputs:
            self.inputs[case] = {k: v.clone() if torch.is_tensor(v) else v
                                 for k, v in args.items()}


def _msda_case(args):
    b, levels = args['value'].shape[0], len(args['spatial_shapes'])
    return {(2, 1): 'tsa', (6, 4): 'sca', (1, 1): 'decoder'}.get((b, levels))


def _dcn_case(args):
    return {256: 'stage3', 512: 'stage4'}.get(args['x'].shape[-1])


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2

    from vidar_tpu_torch.configs import vidar_base, vidar_tiny
    from vidar_tpu_torch.data import make_synthetic_batch
    from vidar_tpu_torch.evals.forecast_runner import ForecastRunner
    from vidar_tpu_torch.models import ViDAR
    from vidar_tpu_torch.ops import _build, dcn, latent_render, msda

    dev = torch.device('cuda:0')
    # -- phase 0: the card and the numerics switches
    card = _nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'{card} | torch {torch.__version__} | CUDA '
          f'{torch.version.cuda} | device_count {torch.cuda.device_count()}'
          f' | matmul.allow_tf32=False cudnn.allow_tf32=False (f32 islands '
          f'run in full f32; the bf16 model is unaffected)', flush=True)

    # -- phase 1: build
    _build.load_library()
    print(f'build: {_build.build_seconds:.1f} s -> {_build.BUILD_DIR}',
          flush=True)

    kernels = [msda.KERNEL, dcn.KERNEL, latent_render.FIRST_HIT,
               latent_render.AGGREGATE]
    keepers = {msda.KERNEL.name: _Keeper(_msda_case),
               dcn.KERNEL.name: _Keeper(_dcn_case),
               latent_render.FIRST_HIT.name: _Keeper(lambda a: 'encoder'),
               latent_render.AGGREGATE.name: _Keeper(lambda a: 'encoder')}

    # -- phase 2: the forecast at full width
    cfg = vidar_base()
    cfg['test_future_frame_num'] = 6
    bs, q, f, cams, ih, iw, pts = 1, 4, 6, 6, 928, 1600, 32768
    model = ViDAR(**cfg, dtype=torch.bfloat16, device=dev).eval()
    model.randomize_(torch.Generator(device=dev).manual_seed(0), 0.02)
    batch = make_synthetic_batch(np.random.default_rng(0), bs=bs,
                                 queue_length=q, future_length=f,
                                 num_cams=cams, img_h=ih, img_w=iw,
                                 max_points=pts, device=dev)
    runner = ForecastRunner(model, (ih, iw), num_future=f, device=dev)
    for k in kernels:
        k.on_launch = keepers[k.name]
        k.launches = 0
    t0 = time.perf_counter()
    out = runner(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    for k in kernels:
        k.on_launch = None
    print(f'forecast 1 (incl. warm-up): {first_s:.3f} s; launches '
          f'{json.dumps(launches)}', flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f'kernel {name} never launched on the path')
    for key in ('pred_dist', 'gt_dist', 'frame_idx'):
        if tuple(out[key].shape) != (bs, pts):
            raise RuntimeError(f'{key} shape {tuple(out[key].shape)}')
    valid = out['frame_idx'] >= 0
    if not bool(valid.any()):
        raise RuntimeError('no valid ray in the decode')
    for key in ('pred_dist', 'gt_dist'):
        if not bool(torch.isfinite(out[key]).all()):
            raise RuntimeError(f'{key} has non-finite values')
    max_len = cfg['ray_grid_num'] * cfg['ray_grid_step'] * (
        (cfg['pc_range'][3] - cfg['pc_range'][0]) / cfg['bev_w'])
    pd = out['pred_dist'][valid]
    if not bool(((pd >= 0) & (pd <= max_len)).all()):
        raise RuntimeError('predicted distances outside the ray')
    print(f'decode: {int(valid.sum())} valid rays, pred_dist mean '
          f'{pd.mean().item():.4f} m, gt_dist mean '
          f'{out["gt_dist"][valid].mean().item():.4f} m', flush=True)

    # small input: the same forecast through the kernels (card) and the
    # plain versions (CPU); the decode's GT geometry must agree and the
    # predictions must land on the same waypoints on nearly every ray
    tcfg = vidar_tiny()
    tiny = ViDAR(**tcfg, dtype=torch.bfloat16, device=dev).eval()
    _unit_scale_(tiny, torch.Generator(device=dev).manual_seed(1))
    tiny_cpu = ViDAR(**tcfg, dtype=torch.bfloat16).eval()
    tiny_cpu.load_state_dict({k: v.cpu() for k, v in
                              tiny.state_dict().items()})
    small = dict(bs=1, queue_length=2, future_length=2, num_cams=3,
                 img_h=64, img_w=64, max_points=128)
    sb = make_synthetic_batch(np.random.default_rng(0), **small)
    nf = tcfg['test_future_frame_num']
    got = ForecastRunner(tiny, (64, 64), num_future=nf, device=dev)(sb)
    ref = ForecastRunner(tiny_cpu, (64, 64), num_future=nf,
                         device='cpu')(sb)
    v = ref['frame_idx'] >= 0
    gt_err = (got['gt_dist'].cpu()[v] - ref['gt_dist'][v]).abs().max().item()
    same = ((got['pred_dist'].cpu()[v] - ref['pred_dist'][v]).abs() <=
            1e-3).float().mean().item()
    print(f'small input (vidar_tiny, 64x64), card vs CPU plain: gt_dist max '
          f'err {gt_err:.3g} m, pred_dist on the same waypoint for '
          f'{same:.4f} of {int(v.sum())} rays', flush=True)
    # gt_dist is f32 geometry and must agree. The two devices round the
    # bf16 model differently (convolution algorithms, sum orders), so an
    # argmax over 16 waypoints may flip on near ties; a broken path lands
    # on the same waypoint for about 1 ray in 16
    if gt_err > 1e-4 or same < 0.5:
        raise RuntimeError('small-input forecast disagrees with the CPU')

    # -- phase 3: every kernel against its plain version on kept inputs
    results = []

    def compare(counter, case, run_kernel, run_plain):
        got = run_kernel()
        torch.cuda.synchronize()
        want = run_plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        atol, rtol = TOLERANCES[counter.name]
        ok = err <= atol + rtol * scale and bool(torch.isfinite(got).all())
        plain_ms = _time_ms(run_plain)
        ms = _time_ms(run_kernel)
        torch.cuda.synchronize()
        print(f'{counter.name}[{case}]: max_abs_err {err:.3g} (max|plain| '
              f'{scale:.4g}, rel {err / max(scale, 1e-30):.3g}; tolerance '
              f'{atol:g} + {rtol:g}*max|plain|) kernel {ms:.3f} ms, plain '
              f'{plain_ms:.3f} ms -> {"ok" if ok else "FAIL"}', flush=True)
        results.append(dict(
            name=f'{counter.name}[{case}]', route='cuda',
            source=counter.source, replaces=counter.replaces,
            launches=launches[counter.name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms))
        return ok

    oks = []
    kept = keepers[msda.KERNEL.name].inputs
    for case in ('tsa', 'sca', 'decoder'):
        a = kept[case]
        oks.append(compare(
            msda.KERNEL, f'{case},{str(a["value"].dtype)[6:]}',
            lambda a=a: msda.msda_forward_cuda(a['value'],
                                               a['spatial_shapes'],
                                               a['loc'], a['weights']),
            lambda a=a: msda.msdeform_attn_plain(a['value'],
                                                 a['spatial_shapes'],
                                                 a['loc'], a['weights'])))
    a = dict(kept['sca'], value=kept['sca']['value'].float())
    oks.append(compare(
        msda.KERNEL, 'sca,float32',
        lambda: msda.msda_forward_cuda(a['value'], a['spatial_shapes'],
                                       a['loc'], a['weights']),
        lambda: msda.msdeform_attn_plain(a['value'], a['spatial_shapes'],
                                         a['loc'], a['weights'])))
    for case, a in sorted(keepers[dcn.KERNEL.name].inputs.items()):
        args = (a['x'], a['sx'], a['sy'], a['mask'], a['weight'])
        oks.append(compare(dcn.KERNEL, case,
                           lambda args=args: dcn.dcn_conv_cuda(*args),
                           lambda args=args: dcn.dcn_conv_plain(*args)))
    a = keepers[latent_render.FIRST_HIT.name].inputs['encoder']
    geo = (a['occ'], a['grids'], a['radial_norm'], a['steps'], a['act'])
    oks.append(compare(
        latent_render.FIRST_HIT, 'encoder',
        lambda: latent_render.ray_first_hit_cuda(*geo),
        lambda: latent_render.ray_first_hit_plain(*geo)))
    a = keepers[latent_render.AGGREGATE.name].inputs['encoder']
    agg = (a['fused_map'], a['grids'], a['radial_norm'], a['steps'],
           a['c_r'], a['zdim'], a['eps'])
    oks.append(compare(
        latent_render.AGGREGATE, 'encoder',
        lambda: latent_render.ray_aggregate_cuda(*agg),
        lambda: latent_render.ray_aggregate_plain(*agg)))
    keepers.clear()
    if not all(oks):
        raise RuntimeError('a kernel disagrees with its plain version')

    # -- phase 4: a timed forecast
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = runner(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(out['pred_dist']).all()):
        raise RuntimeError('timed forecast gave non-finite distances')
    dt = sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated()
    print(f'forecast (vidar_base bf16, bs {bs}, {q}+1 frames x {cams} cams '
          f'{ih}x{iw}, {f} futures, {pts} rays): '
          f'{" ".join(f"{t:.4f}" for t in times)} s -> {dt:.4f} s/sample, '
          f'{bs / dt:.4f} samples/s, peak memory {peak / 2**30:.2f} GiB '
          f'on {card}', flush=True)

    print(json.dumps({'kernels': results}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
