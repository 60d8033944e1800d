"""Chip smoke test of the PyTorch/CUDA port: the ViDAR forecast, the
pre-training step, and the BEVFormer detection fine-tune (eval, streaming
eval and train step) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero and prints no
result line). Every kernel's launches are counted from 0 around each path
it drives; a kernel of the path that never launched fails the run:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the TF32 switches, set explicitly (off);
1. the build of the CUDA kernels from ``vidar_tpu_torch/csrc`` (K1-K4, the
   backwards K5, K6/K7, K8, K9 and K10), K2's ``wgmma`` instructions and
   K5's, K6/K7's and K8's vector f32 reductions counted in ``cuobjdump
   -sass`` of the build;
2. one full forecast of ``vidar_base`` in bf16 at the nuScenes shapes of
   bench.py (bs 1, 4+1 frames, 6 cameras, 928x1600, 6 futures, 32768 rays),
   random weights (N(0, 1) x 0.02 from a seeded generator), through
   ``ForecastRunner``; each forward kernel's first input is kept; then the
   small-input forecast check (``vidar_tiny``, card kernels vs CPU plain
   versions, same weights and batch);
3. each forward kernel against its plain PyTorch version on the kept
   inputs: error and CUDA-event times of both, and the bound: the larger of
   the bytes the function must move over 3.35 TB/s and its floating-point
   operations over the card's peak rate for their type, with the share of
   it each kernel reaches (bound / time); the kernel that each K3, K6/K7,
   K8, K9 and K10 case ran (its ``path`` in the JSON line:
   ``ray_first_hit_route``'s vector or first design,
   ``ray_first_hit_backward_route``'s and
   ``ray_aggregate_backward_route``'s vector or scalar,
   ``dcn_sample_route``'s staged or scalar, ``dcn_sample16_route``'s
   staged, vector or scalar), and the device-only time of K6/K7, K8, K9
   and K10 (``device_ms``: launches queued behind a sleep kernel) beside
   the wrapper-inclusive one;
4. a second, timed forecast: seconds, samples/s, peak device memory (the
   forecast's own: the train model does not exist yet);
5. the first (warm-up) pre-training step of ``vidar_base`` at full width
   and depth in bf16 with f32 parameters, the shapes of
   benchmarks/train_step_flagship.py (bs 1, 4+1 frames, 6 cameras at
   928x1600, 3 supervised futures, 32768 GT points), random weights as
   above, through ``TrainStep`` and ``make_optimizer``: the losses and the
   gradient norm must be finite, the parameters must move, and each
   backward kernel's first input is kept; the small-input train check
   (``vidar_tiny``, one forward and backward on the card and on the CPU,
   same weights and batch: the losses and the cosine similarity of the
   gradients); each backward kernel against autograd of its plain forward
   in f32 on the kept inputs, and K2 on the step's one-image
   (camera-sequential backbone) and 24-image (history) stage-3 inputs, as
   in phase 3; then two timed steps, the forward alone (autograd on, the
   graph freed without a backward) and the step's peak device memory;
6. the f32 fine-tune ``BEVFormer(**vidar_finetune_1_8_nusc_3future())`` at
   full width and depth, random weights as above (bs 1, 4+1 frames, 6
   cameras at 928x1600, 900 queries, 200x200 BEV, 40 synthetic GT boxes of
   128): one full-window eval and three streamed frames through
   ``DetectionRunner``, ``evaluate_detection`` on their decodes (K9, K1,
   K3, K4 must launch, K2 must not); the small-input fine-tune check
   (``vidar_finetune_tiny``, card vs CPU, window and streamed outputs); K9
   against its plain version on the kept stage-3 and stage-4 inputs with
   ``F.grid_sample`` as the library yardstick, K1 at the fine-tune's f32
   TSA, SCA and detection-decoder inputs, and K3 and K4 at its f32
   occupancy and fused map, as in phase 3; then the timed full-window
   sample and streamed frames, with peak device memory;
7. the fine-tune train step at the same shapes through ``DetTrainStep``:
   a warm-up step (K9, K1, K5, K3, K4, K6/K7, K8 must launch; finite losses
   and gradient norm; parameters move; each backward kernel's first f32
   input is kept), the small-input fine-tune train check (losses and
   gradient cosine, card vs CPU), K5 at the TSA, SCA and decoder inputs and
   K6/K7 and K8 against autograd of their plain forwards, as in phase 5, K9
   on the step's one-image (camera-sequential) and 24-image (history)
   stage-3 and stage-4 inputs (cases ``stage3,b1`` ... ``stage4,b24``) with
   ``F.grid_sample`` as the library yardstick, as in phase 6,
   two timed steps with peak device memory, and one step with the host's
   Hungarian calls timed;
8. the bf16 forecast of ``vidar_base`` with a deformable conv in every
   ResNet stage (``backbone_dcn=(True,) * 4``) at phase 2's shapes and
   weight scheme: stage 1 (C = CO = 64, which K2 does not take) runs K10
   and a bf16 product, stages 2-4 run K2. One counted warm-up sample (K10 3
   and K2 30 launches; no K9, no backward kernel), K10 against its plain
   version on the kept stage-1 input (bit for bit) with ``F.grid_sample`` as
   the library yardstick and K2 on the kept stage-2 input, as in phase 3;
   two timed samples with peak device memory beside phase 4's; the
   small-input forecast and train checks of phases 2 and 5 at
   ``vidar_tiny(backbone_dcn=(True,) * 4, frozen_stages=0)``, so K10's
   route and its backward run through autograd on the card.

The line before the last is a JSON object of per-kernel results; the last
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

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
    # the plain version's four products and sum order, then the mask,
    # without fused multiply-adds: equal but for a sign of zero; 1e-5 of the
    # largest tap
    'dcn_sample_forward': (0.0, 1e-5),
    # K2's taps, rounded to bf16 once: equal but for a sign of zero; held
    # to K9's tolerance
    'dcn_sample16_forward': (0.0, 1e-5),
}
# Backward kernels against autograd of the plain version in f32: f32 atomic
# sums in an order that changes from run to run (1e-4 of the largest
# gradient); a gradient the kernel returns in bf16 is also rounded once to
# bf16 (2^-9 of the element), hence 4e-3 of the largest
BACKWARD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 4e-3}

# NVIDIA H100 SXM peaks (data sheet, dense): HBM bytes/s, bf16 tensor-core
# and f32 (no tensor core) operations/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {'bf16': 989e12, 'f32': 67e12}


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


# a sleep kernel of about 5 ms (10M cycles at the H100's clocks), longer
# than the host takes to queue the timed launches behind it
SLEEP_CYCLES = 10_000_000


def _device_ms(fn, reps=10) -> float:
    """fn's device time: CUDA events around reps launches that the host
    queued behind a sleep kernel, so the host's cost per call (checks,
    allocation, launch) does not enter it, as it enters ``_time_ms``."""
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _unit_scale_(model, generator):
    """Random weights with unit-scale activations for the small-input
    checks: kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1), biases
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
    """Keeps (cloned) the first input a kernel gets for each case, and
    counts the launches of each case."""

    def __init__(self, case_of):
        self.case_of = case_of
        self.inputs = {}
        self.counts = {}

    def __call__(self, args):
        case = self.case_of(args)
        self.counts[case] = self.counts.get(case, 0) + 1
        if case is not None and case not in self.inputs:
            self.inputs[case] = {k: v.clone() if torch.is_tensor(v) else v
                                 for k, v in args.items()}


def _msda_case(args, prefix=''):
    """The attention an MSDA call serves, by (batch, levels); ``prefix``
    names the model (the fine-tune's decoder shares ViDAR's (1, 1))."""
    b, levels = args['value'].shape[0], len(args['spatial_shapes'])
    case = {(2, 1): 'tsa', (6, 4): 'sca', (1, 1): 'decoder'}.get((b, levels))
    return case and prefix + case


def _det_msda_case(args):
    return _msda_case(args, 'det_')


def _dcn_case(args):
    return {64: 'stage1', 128: 'stage2', 256: 'stage3',
            512: 'stage4'}.get(args['x'].shape[-1])


def _dcn_image_case(args):
    """K2's or K9's case by ResNet stage and image count: the 30 images of a
    window (forecast, eval) keep the stage's name; a train step's 24-image
    history and 1-image camera-sequential calls add ``,b24`` and ``,b1``."""
    stage, b = _dcn_case(args), args['x'].shape[0]
    return stage if stage is None or b == 30 else f'{stage},b{b}'


def _run_counted(kernels, keepers, fn):
    """Run fn with every kernel's count set to 0 and its keeper hooked;
    -> (fn's result, {kernel: launches})."""
    for k in kernels:
        k.on_launch = keepers.get(k.name)
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    for k in kernels:
        k.on_launch = None
    by_case = {n: kp.counts for n, kp in keepers.items()}
    print(f'  launches by case: {json.dumps(by_case)}', flush=True)
    return out, launches


# ------------------------------------------------------------ bound model

def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _msda_valid_samples(loc, spatial_shapes):
    """Samples whose top-left corner touches the map (the others cost no
    loads), counted from this run's locations."""
    n = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        x = torch.floor(loc[..., lvl, :, 0] * w - 0.5)
        y = torch.floor(loc[..., lvl, :, 1] * h - 0.5)
        n += int(((x >= -1) & (x <= w - 1) & (y >= -1) &
                  (y <= h - 1)).sum())
    return n


def _dcn_valid_taps(sx, sy, h, w):
    """Taps whose top-left corner touches the map (the others are zeros
    with no loads), counted from this run's coordinates."""
    x0, y0 = torch.floor(sx), torch.floor(sy)
    return int(((x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) &
                (y0 <= h - 1)).sum())


def _ray_counts(grids, radial_norm, steps):
    """(inside, valid), each [N]: per cell, the waypoints the first-hit
    pass samples (strictly closer to the centre than the cell) and those
    the aggregation samples (inside the boundary square), from this run's
    geometry."""
    way = (0.5 + radial_norm[:, None, :] * steps[None, :, None]) * 2.0 - 1.0
    length = torch.sqrt((way ** 2).sum(-1))
    cell = torch.sqrt(((grids * 2.0 - 1.0) ** 2).sum(-1))
    boundary = torch.minimum(1.0 / radial_norm[:, 0].abs(),
                             1.0 / radial_norm[:, 1].abs())
    return ((length < cell[:, None]).sum(-1).double(),
            (length < boundary[:, None]).sum(-1).double())


def _bound(nbytes, flops):
    """-> (bound_ms, bound_by): the larger of bytes / HBM rate and, for
    each type, its operations / peak rate of that type (flops: {type:
    count})."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / PEAK_OPS[kind] * 1e3 for kind, n in flops.items())
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


# Floating-point operations per unit of work, an FMA counted as 2 as the
# peak rates count it. They count the least the function needs, not what a
# kernel does: K6/K7 and K8 sample each waypoint twice, and that recompute
# is not charged.
#   geo      the ray geometry of one (cell, waypoint): the waypoint, its
#            length and the test against the cell or the boundary
#   corners  one sample point's map coordinates, floors, fractions and 4
#            corner weights, shared by all its channels
#   lerp     one channel's bilinear sample: 4 FMAs
#   scatter  one value into one channel's 4 corners: 4 products, 4 adds
#   act      an activation (negation, exp, add, reciprocal); dact its slope
FLOPS = dict(geo=13, corners=18, lerp=8, scatter=8, act=4, dact=2)


def _cost(name, a, out_bytes):
    """(bytes, {type: flops}) of one call of kernel `name` on inputs a."""
    F = FLOPS
    if name.startswith('msda'):
        v, loc, w = a['value'], a['loc'], a['weights']
        dim = v.shape[-1]
        n = _msda_valid_samples(loc, a['spatial_shapes'])
        if name == 'msda_forward':
            # per sample: its corner weights times the attention weight;
            # per channel: 4 FMAs into the output
            return (_nbytes(v, loc, w) + out_bytes,
                    {'f32': n * (F['corners'] + 4 + dim * F['lerp'])})
        # per channel: the 4 corner dots t_c (4 FMAs) and the dvalue
        # scatter; per sample: the weights as forward, dweight (4 FMAs),
        # dwx, dwy (2 differences, 2 FMAs and the attention weight, each)
        # and the two map-size scales of dloc
        return (_nbytes(v, loc, w, a['dout']) + out_bytes,
                {'f32': n * (F['corners'] + 4 + 8 + 14 + 2 +
                             dim * (F['lerp'] + F['scatter']))})
    if name == 'dcn_sample_forward':
        # per tap that touches the map: its corners; per such tap and
        # channel: 4 FMAs and the mask product. Every tap is written.
        x = a['x']
        taps = _dcn_valid_taps(a['sx'], a['sy'], *x.shape[1:3])
        return (_nbytes(x, a['sx'], a['sy'], a['mask']) + out_bytes,
                {'f32': taps * (F['corners'] + x.shape[-1] * (F['lerp'] + 1))})
    if name == 'dcn_sample16_forward':
        # per tap that touches the map: its corners and the mask folded into
        # the 4 corner weights; per such tap and channel: 4 FMAs. Every tap
        # is written, in bf16.
        x = a['x']
        taps = _dcn_valid_taps(a['sx'], a['sy'], *x.shape[1:3])
        return (_nbytes(x, a['sx'], a['sy'], a['mask']) + out_bytes,
                {'f32': taps * (F['corners'] + 4 + x.shape[-1] * F['lerp'])})
    if name == 'dcn_conv_forward':
        x, w = a['x'], a['weight']
        b, q = a['sx'].shape[:2]
        taps = b * q * 9
        # the matrix product in bf16; the sampling (per tap: corners; per
        # tap and channel: 4 FMAs and the mask product) in f32
        return (_nbytes(x, a['sx'], a['sy'], a['mask'], w) + out_bytes,
                {'bf16': 2 * b * q * w.shape[0] * w.shape[1],
                 'f32': taps * (F['corners'] + x.shape[-1] * (F['lerp'] + 1))})
    geo = (a['grids'], a['radial_norm'], a['steps'])
    inside, valid = _ray_counts(*geo)
    steps = a['steps'].shape[0]
    if name.startswith('ray_first_hit'):
        occ = a['occ']
        points = inside + 1          # the inside waypoints and the cell
        if name == 'ray_first_hit_forward':
            # per cell: the path's geometry, each point's corners; per
            # (point, bin): sample, activation, 1 - p and the product
            bz = occ.shape[0] * occ.shape[-1]
            return (_nbytes(occ, *geo) + out_bytes,
                    {'f32': float(points.numel() * steps * F['geo'] +
                                  points.sum() * (F['corners'] + bz * (
                                      F['lerp'] + F['act'] + 2)))})
        # only the bins with g != 0 send a gradient: per cell with one, the
        # geometry as forward; per (point, such bin): sample, activation
        # and slope once, 1 - p, the prefix and suffix products, dlogit (3
        # products) and its scatter
        live = (a['g'] != 0).sum(0).double()                     # [N, Z]
        cells = live.sum(-1) > 0
        return (_nbytes(occ, a['g'], *geo) + out_bytes,
                {'f32': float(cells.sum() * steps * F['geo'] +
                              (cells * points).sum() * F['corners'] +
                              (live.sum(-1) * points).sum() *
                              (F['lerp'] + F['act'] + F['dact'] + 6 +
                               F['scatter']))})
    fmap = a['fused_map']
    b, c_r, zdim = fmap.shape[0], a['c_r'], a['zdim']
    n = valid.numel()
    if name == 'ray_aggregate_forward':
        # per cell: the path's geometry, each valid waypoint's corners; per
        # (valid waypoint, feature): sample and an FMA into num; per
        # (valid waypoint, bin): sample and an add into den; per output: an
        # add and a division
        return (_nbytes(fmap, *geo) + out_bytes,
                {'f32': float(n * steps * F['geo'] + valid.sum() * (
                    F['corners'] + b * (c_r * (F['lerp'] + 2) +
                                        zdim * (F['lerp'] + 1)))
                    + b * n * c_r * 2)})
    # only the cells with g != 0 send a gradient. Per such cell: the
    # geometry as forward; (num, den) kept from the forward; per output:
    # dnum and dden (5); per (valid waypoint, feature): f once, dnum * p and
    # its scatter, dnum * f + dden (an FMA); per (valid waypoint, bin): p
    # once and the scatter of the bin's sum
    live = (a['g'] != 0).any(-1).sum(0).double()                 # [N]
    cells = live > 0
    return (_nbytes(fmap, a['g'], *geo) + out_bytes,
            {'f32': float(cells.sum() * steps * F['geo'] +
                          (cells * valid).sum() * F['corners'] +
                          (live * valid).sum() * (
                              c_r * (F['lerp'] + 3 + F['scatter']) +
                              zdim * (F['lerp'] + F['scatter'])) +
                          live.sum() * c_r * 5)})


def _window(det_batch, end):
    """The detection batch cut to its first ``end`` camera frames: frame
    ``end - 1`` is then the current one."""
    f = det_batch.frames
    frames = dataclasses.replace(f, **{
        k: getattr(f, k)[:, :end] for k in (
            'images', 'lidar2img', 'can_bus', 'shift', 'rotate_angle',
            'prev_bev_exists')})
    return dataclasses.replace(det_batch, frames=frames)


def _stream_meta(k):
    """Frame k of one synthetic scene: the ego drives 2 m forward and
    turns 1 degree per frame."""
    can_bus = np.zeros(18)
    can_bus[0], can_bus[-1] = 2.0 * k, 1.0 * k
    return dict(can_bus=can_bus, scene_token='scene-0', l2g_rot=np.eye(3))


def _grid_sample_taps(x_nchw, grid, mask):
    """K9's and K10's function as one PyTorch call in its own layout (the
    library yardstick): x [B, C, H, W] f32, grid [B, Q*9, 1, 2] in [-1, 1]
    with align_corners, mask [B, 1, Q*9, 1] -> [B, C, Q*9, 1] f32."""
    return torch.nn.functional.grid_sample(
        x_nchw, grid, mode='bilinear', padding_mode='zeros',
        align_corners=True) * mask


def _grid_sample_args(a):
    """The kept DCN inputs in ``_grid_sample_taps``'s layout, x in f32."""
    x, sx, sy, mask = a['x'], a['sx'], a['sy'], a['mask']
    b, h, w, _ = x.shape
    grid = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1],
                       -1).reshape(b, -1, 1, 2)
    return (x.permute(0, 3, 1, 2).float().contiguous(), grid,
            mask.reshape(b, 1, -1, 1))


SMALL = dict(bs=1, queue_length=2, future_length=2, num_cams=3, img_h=64,
             img_w=64, max_points=128)


def _tiny_pair(cfg, dev, seed):
    """A small bf16 ``ViDAR`` on the card with unit-scale random weights,
    and the same model on the CPU."""
    from vidar_tpu_torch.models import ViDAR
    tiny = ViDAR(**cfg, dtype=torch.bfloat16, device=dev).eval()
    _unit_scale_(tiny, torch.Generator(device=dev).manual_seed(seed))
    tiny_cpu = ViDAR(**cfg, dtype=torch.bfloat16, device='cpu').eval()
    tiny_cpu.load_state_dict({k: v.cpu() for k, v in
                              tiny.state_dict().items()})
    return tiny, tiny_cpu


def _small_forecast_check(tiny, tiny_cpu, dev, label):
    """The same small forecast through the kernels (card) and the plain
    versions (CPU): the decode's GT geometry must agree and the predictions
    must land on the same waypoints on nearly every ray."""
    from vidar_tpu_torch.data import make_synthetic_batch
    from vidar_tpu_torch.evals.forecast_runner import ForecastRunner
    sb = make_synthetic_batch(np.random.default_rng(0), **SMALL,
                              device='cpu')
    nf = tiny.test_future_frame_num
    hw = (SMALL['img_h'], SMALL['img_w'])
    got = ForecastRunner(tiny, hw, num_future=nf, device=dev)(sb)
    ref = ForecastRunner(tiny_cpu, hw, num_future=nf, device='cpu')(sb)
    v = ref['frame_idx'] >= 0
    gt_err = (got['gt_dist'].cpu()[v] - ref['gt_dist'][v]).abs().max().item()
    same = ((got['pred_dist'].cpu()[v] - ref['pred_dist'][v]).abs() <=
            1e-3).float().mean().item()
    print(f'small input ({label}, 64x64), card vs CPU plain: gt_dist max '
          f'err {gt_err:.3g} m, pred_dist on the same waypoint for '
          f'{same:.4f} of {int(v.sum())} rays', flush=True)
    # gt_dist is f32 geometry and must agree. The two devices round the
    # bf16 model differently (convolution algorithms, sum orders), so an
    # argmax over 16 waypoints may flip on near ties; a broken path lands
    # on the same waypoint for about 1 ray in 16
    if gt_err > 1e-4 or same < 0.5:
        raise RuntimeError(f'small-input forecast ({label}) disagrees with '
                           f'the CPU')


def _grad_agreement(sides):
    """(loss max rel diff, flattened gradient cosine, {tensor: cosine}) of
    [(losses, grads) on the card, (losses, grads) on the CPU]; tensors
    whose CPU gradient is under 1e-3 of the largest are left out."""
    (lg, gg), (lc, gc) = sides
    loss_err = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6) for k in lc)
    flat_g = torch.cat([g.reshape(-1) for g in gg.values()])
    flat_c = torch.cat([g.reshape(-1) for g in gc.values()])
    cos = torch.nn.functional.cosine_similarity(flat_g, flat_c, 0).item()
    biggest = max(float(g.norm()) for g in gc.values())
    per_tensor = {n: torch.nn.functional.cosine_similarity(
        gg[n].reshape(-1), gc[n].reshape(-1), 0).item()
        for n in gc if float(gc[n].norm()) > 1e-3 * biggest}
    return loss_err, cos, per_tensor


def _small_train_check(tiny, tiny_cpu, dev, label, each_loss=True):
    """One forward and backward of the small model, dropout and noise off,
    through the kernels (card) and the plain versions (CPU): the losses
    (each relative to itself, or with ``each_loss=False`` to the largest)
    and the cosine similarity of the parameter gradients."""
    from vidar_tpu_torch.data import make_synthetic_batch
    tb = make_synthetic_batch(np.random.default_rng(0), **SMALL,
                              device='cpu')
    sides = []
    for m, d in ((tiny, dev), (tiny_cpu, 'cpu')):
        m.zero_grad(set_to_none=True)
        losses = m(tb.to(d))
        sum(losses.values()).backward()
        grads = {n: (p.grad if p.grad is not None else
                     torch.zeros_like(p)).float().cpu()
                 for n, p in m.named_parameters()}
        sides.append(({k: float(x.detach()) for k, x in losses.items()},
                      grads))
    loss_err, cos, per_tensor = _grad_agreement(sides)
    (lg, _), (lc, _) = sides
    if not each_loss:
        loss_err = max(abs(lg[k] - lc[k]) for k in lc) / max(
            abs(v) for v in lc.values())
    worst = min(per_tensor, key=per_tensor.get)
    print(f'small input train ({label}, 64x64, bf16), card vs CPU plain: '
          f'losses {json.dumps({k: [lg[k], lc[k]] for k in lc})}, max diff '
          f'{loss_err:.3g} of {"each" if each_loss else "the largest"}; '
          f'gradient cosine {cos:.5f} (flattened), min per tensor '
          f'{per_tensor[worst]:.4f} ({worst}, {len(per_tensor)} tensors)',
          flush=True)
    # the bf16 model rounds differently on the two devices; a backward
    # kernel that returns zeros leaves the tensors it feeds at cosine 0
    if loss_err > 2e-2 or cos < 0.99 or per_tensor[worst] < 0.9:
        raise RuntimeError(f'small-input train step ({label}) disagrees '
                           f'with the CPU')


def _check_forecast(out, cfg, bs, pts):
    """A full forecast's decode: [bs, pts] outputs, some valid rays, finite
    distances, predictions on the ray -> the predicted distances."""
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


def _check_detections(name, pred, gt, num_classes):
    """One sample's entries: K finite boxes [K, 9], K scores in [0, 1], K
    labels among the classes, K attributes; GT boxes [G, 9]."""
    k = len(pred['boxes'])
    ok = (pred['boxes'].shape == (k, 9) and pred['scores'].shape == (k,) and
          pred['labels'].shape == (k,) and len(pred['attrs']) == k and
          gt['boxes'].shape[1:] == (9,) and
          np.isfinite(pred['boxes']).all() and
          ((pred['scores'] >= 0) & (pred['scores'] <= 1)).all() and
          ((pred['labels'] >= 0) & (pred['labels'] < num_classes)).all())
    if not ok:
        raise RuntimeError(f'{name}: malformed detections')


def _plain_grads(fn, inputs, g):
    """Autograd of a plain version in f32 (bf16 inputs upcast: the same
    values): the gradients of <fn(*inputs), g> against the inputs."""
    leaves = [x.detach().float().requires_grad_() for x in inputs]
    return list(torch.autograd.grad(fn(*leaves), leaves, g))


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2

    from vidar_tpu_torch.configs import (vidar_base,
                                         vidar_finetune_1_8_nusc_3future,
                                         vidar_finetune_tiny, vidar_tiny)
    from vidar_tpu_torch.core import bbox as bbox_core
    from vidar_tpu_torch.data import (make_synthetic_batch,
                                      make_synthetic_det_batch)
    from vidar_tpu_torch.evals.det_runner import CLASS_NAMES, DetectionRunner
    from vidar_tpu_torch.evals.detection import evaluate_detection
    from vidar_tpu_torch.evals.forecast_runner import ForecastRunner
    from vidar_tpu_torch.models import BEVFormer, ViDAR
    from vidar_tpu_torch.ops import _build, dcn, latent_render, msda
    from vidar_tpu_torch.train import (DetTrainStep, TrainStep,
                                       make_optimizer)

    dev = torch.device('cuda:0')
    # -- phase 0: the card and the numerics switches
    card = _nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card, flush=True)
    print(f'{card} | torch {torch.__version__} | CUDA '
          f'{torch.version.cuda} | device_count {torch.cuda.device_count()}'
          f' | matmul.allow_tf32=False cudnn.allow_tf32=False (f32 islands '
          f'run in full f32; the bf16 model is unaffected)', flush=True)

    # -- phase 1: build; K2 must issue its product with wgmma (HGMMA)
    lib = _build.load_library()
    print(f'build: {_build.build_seconds:.1f} s -> {_build.BUILD_DIR}',
          flush=True)
    sass = subprocess.run(
        [str(Path(_build._nvcc()).with_name('cuobjdump')), '-sass',
         lib._name], capture_output=True, text=True, timeout=120,
        check=True).stdout
    # each function's SASS runs from its "Function :" line to the next
    hgmma = sum(chunk.split('Function :')[0].count('HGMMA')
                for chunk in sass.split('dcn_conv_kernel')[1:])
    print(f'cuobjdump -sass: {hgmma} HGMMA instructions in K2 '
          f'(dcn_conv_kernel)', flush=True)
    if not hgmma:
        raise RuntimeError('K2 was built without wgmma')
    # K5 scatters 4 channels an instruction, K6/K7's and K8's vector
    # kernels 4 bins or channels: Hopper's vector f32 reductions
    # (red.global.add.v4.f32)
    for label, fn in (('K5', 'msda_backward_vec_kernel'),
                      ('K6/K7', 'ray_first_hit_backward_vec_kernel'),
                      ('K8', 'ray_aggregate_backward_vec_kernel')):
        red4 = [line.strip() for chunk in sass.split(fn)[1:]
                for line in chunk.split('Function :')[0].splitlines()
                if ('RED' in line or 'ATOM' in line) and 'F32x4' in line]
        print(f'cuobjdump -sass: {len(red4)} vector f32 reductions in '
              f'{label} ({fn}), e.g. {red4[:1]}', flush=True)
        if not red4:
            raise RuntimeError(f'{label} was built without vector atomics')

    forward_kernels = [msda.KERNEL, dcn.KERNEL, latent_render.FIRST_HIT,
                       latent_render.AGGREGATE]
    backward_kernels = [msda.BACKWARD, latent_render.FIRST_HIT_BACKWARD,
                        latent_render.AGGREGATE_BACKWARD]
    kernels = forward_kernels + backward_kernels
    # K9 runs on the f32 fine-tune's path only, K10 on phase 8's; every path
    # counts both
    counted = kernels + [dcn.SAMPLE, dcn.SAMPLE16]
    keepers = {msda.KERNEL.name: _Keeper(_msda_case),
               dcn.KERNEL.name: _Keeper(_dcn_image_case),
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
    t0 = time.perf_counter()
    out, launches = _run_counted(counted, keepers, lambda: runner(batch))
    first_s = time.perf_counter() - t0
    print(f'forecast 1 (incl. warm-up): {first_s:.3f} s; launches '
          f'{json.dumps(launches)}', flush=True)
    for k in forward_kernels:
        if launches[k.name] <= 0:
            raise RuntimeError(f'kernel {k.name} never launched on the path')
    if launches[dcn.SAMPLE.name] or launches[dcn.SAMPLE16.name] or any(
            launches[k.name] for k in backward_kernels):
        raise RuntimeError('the bf16 forecast ran K9, K10 or a backward '
                           'kernel')
    _check_forecast(out, cfg, bs, pts)

    tiny, tiny_cpu = _tiny_pair(vidar_tiny(use_grid_mask=False), dev, 1)
    _small_forecast_check(tiny, tiny_cpu, dev, 'vidar_tiny')

    # -- phase 3: every forward kernel against its plain version
    results = []

    def record(counter, case, err, scale, ok, ms, plain_ms, cost, n,
               library_ms=None):
        bound_ms, bound_by = _bound(*cost)
        lib = '' if library_ms is None else f', library {library_ms:.3f} ms'
        print(f'{counter.name}[{case}]: max_abs_err {err:.3g} (max|plain| '
              f'{scale:.4g}) kernel {ms:.3f} ms, plain {plain_ms:.3f} ms'
              f'{lib}, bound {bound_ms:.4f} ms ({bound_by}, '
              f'{bound_ms / ms:.1%} of it reached) -> '
              f'{"ok" if ok else "FAIL"}', flush=True)
        results.append(dict(
            name=f'{counter.name}[{case}]', route='cuda',
            source=counter.source, replaces=counter.replaces,
            launches=n[counter.name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms))

    def compare(counter, case, args, run_kernel, run_plain, n=launches,
                library=None):
        got = run_kernel()
        torch.cuda.synchronize()
        want = run_plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        atol, rtol = TOLERANCES[counter.name]
        ok = err <= atol + rtol * scale and bool(torch.isfinite(got).all())
        out_bytes = _nbytes(got)
        del got, want
        plain_ms = _time_ms(run_plain)
        ms = _time_ms(run_kernel)
        library_ms = None if library is None else _time_ms(library)
        record(counter, case, err, scale, ok, ms, plain_ms,
               _cost(counter.name, args, out_bytes), n, library_ms)
        return ok

    def compare_dcn_taps(counter, case, a, run_kernel, run_plain, n):
        """K9 or K10 on the kept input ``a``, with ``F.grid_sample`` x mask
        on the same input as the library yardstick."""
        gs = _grid_sample_args(a)
        ok = compare(counter, case, a, run_kernel, run_plain, n=n,
                     library=lambda: _grid_sample_taps(*gs))
        b_, c_ = a['x'].shape[0], a['x'].shape[-1]
        lib = _grid_sample_taps(*gs).reshape(b_, c_, -1, 9).permute(0, 2, 3,
                                                                     1)
        plain = run_plain().float().reshape(lib.shape)
        print(f'  grid_sample yardstick[{case}]: max abs diff from the plain '
              f'version {(lib - plain).abs().max().item():.3g}', flush=True)
        # the kernel K9 or K10 ran, and its device time beside the
        # wrapper-inclusive time of the line above
        route = (dcn.dcn_sample_route if counter is dcn.SAMPLE
                 else dcn.dcn_sample16_route)
        record_path(counter, case, route(a['x'], a['sx'].shape[1]),
                    run_kernel)
        return ok

    def record_path(counter, case, path, run_kernel):
        """Adds the kernel a case ran and its device-only time to the
        case's JSON entry (the last recorded)."""
        device_ms = _device_ms(run_kernel)
        results[-1].update(path=path, device_ms=device_ms)
        print(f'  {counter.name}[{case}]: path {path}; device-only '
              f'{device_ms:.4f} ms, with the wrapper '
              f'{results[-1]["ms"]:.4f} ms', flush=True)

    oks = []
    kept = keepers[msda.KERNEL.name].inputs
    for case in ('tsa', 'sca', 'decoder'):
        a = kept[case]
        oks.append(compare(
            msda.KERNEL, f'{case},{str(a["value"].dtype)[6:]}', a,
            lambda a=a: msda.msda_forward_cuda(a['value'],
                                               a['spatial_shapes'],
                                               a['loc'], a['weights']),
            lambda a=a: msda.msdeform_attn_plain(a['value'],
                                                 a['spatial_shapes'],
                                                 a['loc'], a['weights'])))
    a = dict(kept['sca'], value=kept['sca']['value'].float())
    oks.append(compare(
        msda.KERNEL, 'sca,float32', a,
        lambda: msda.msda_forward_cuda(a['value'], a['spatial_shapes'],
                                       a['loc'], a['weights']),
        lambda: msda.msdeform_attn_plain(a['value'], a['spatial_shapes'],
                                         a['loc'], a['weights'])))
    for case, a in sorted(keepers[dcn.KERNEL.name].inputs.items()):
        args = (a['x'], a['sx'], a['sy'], a['mask'], a['weight'])
        oks.append(compare(dcn.KERNEL, case, a,
                           lambda args=args: dcn.dcn_conv_cuda(*args),
                           lambda args=args: dcn.dcn_conv_plain(*args)))

    def compare_render(kept, case, n):
        """K3 and K4 on the inputs kept for ``case`` -> [ok, ok]."""
        a = kept[latent_render.FIRST_HIT.name].inputs[case]
        geo = (a['grids'], a['radial_norm'], a['steps'])
        first_hit = compare(
            latent_render.FIRST_HIT, case, a,
            lambda: latent_render.ray_first_hit_cuda(a['occ'], *geo,
                                                     a['act']),
            lambda: latent_render.ray_first_hit_plain(a['occ'], *geo,
                                                      a['act']), n=n)
        path = latent_render.ray_first_hit_route(a['occ'])
        results[-1]['path'] = path
        print(f'  {latent_render.FIRST_HIT.name}[{case}]: path {path} '
              f'({a["occ"].dtype}, Z = {a["occ"].shape[-1]})', flush=True)
        b = kept[latent_render.AGGREGATE.name].inputs[case]
        agg = (b['fused_map'], b['grids'], b['radial_norm'], b['steps'],
               b['c_r'], b['zdim'], b['eps'])
        return [first_hit, compare(
            latent_render.AGGREGATE, case, b,
            lambda: latent_render.ray_aggregate_cuda(*agg),
            lambda: latent_render.ray_aggregate_plain(*agg), n=n)]

    oks += compare_render(keepers, 'encoder', launches)
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
    forecast_s, forecast_peak = dt, peak
    print(f'forecast (vidar_base bf16, bs {bs}, {q}+1 frames x {cams} cams '
          f'{ih}x{iw}, {f} futures, {pts} rays): '
          f'{" ".join(f"{t:.4f}" for t in times)} s -> {dt:.4f} s/sample, '
          f'{bs / dt:.4f} samples/s, peak memory {peak / 2**30:.2f} GiB '
          f'on {card}', flush=True)
    del model, runner, batch, out

    # -- phase 5: the pre-training step at full width; the warm-up step,
    # counted, keeps each backward kernel's first input
    torch.cuda.empty_cache()
    tr_model = ViDAR(**vidar_base(), dtype=torch.bfloat16, device=dev)
    tr_model.randomize_(torch.Generator(device=dev).manual_seed(2), 0.02)
    tr_batch = make_synthetic_batch(np.random.default_rng(0), bs=bs,
                                    queue_length=q, future_length=3,
                                    num_cams=cams, img_h=ih, img_w=iw,
                                    max_points=pts, device=dev)
    step = TrainStep(tr_model, make_optimizer(tr_model, device=dev),
                     generator=torch.Generator(device=dev).manual_seed(3),
                     device=dev)
    before = [p.detach().clone() for p in tr_model.parameters()]
    keepers = {k.name: _Keeper(_msda_case if k is msda.BACKWARD
                               else lambda a: 'encoder')
               for k in backward_kernels}
    # the forward kernels' launches by case, as in phase 2; K2's one-image
    # and 24-image stage-3 inputs are kept
    keepers.update({msda.KERNEL.name: _Keeper(_msda_case),
                    dcn.KERNEL.name: _Keeper(_dcn_image_case)})
    t0 = time.perf_counter()
    metrics, train_launches = _run_counted(counted, keepers,
                                           lambda: step(tr_batch))
    warm_s = time.perf_counter() - t0
    print(f'train step 1 (incl. warm-up): {warm_s:.3f} s; launches '
          f'{json.dumps(train_launches)}; metrics {json.dumps(metrics)}',
          flush=True)
    for k in kernels:
        if train_launches[k.name] <= 0:
            raise RuntimeError(f'kernel {k.name} never launched in the train '
                               f'step')
    if train_launches[dcn.SAMPLE.name] or train_launches[dcn.SAMPLE16.name]:
        raise RuntimeError('the bf16 train step ran K9 or K10')
    for r in results:
        r['train_launches'] = train_launches[r['name'].split('[')[0]]
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError('non-finite train metrics')
    if not metrics['grad_norm'] > 0:
        raise RuntimeError('zero gradient norm')
    moved = sum(bool((p.detach() != b0).any())
                for p, b0 in zip(tr_model.parameters(), before))
    del before
    print(f'parameters moved: {moved} of {len(list(tr_model.parameters()))}',
          flush=True)
    if moved == 0:
        raise RuntimeError('the train step moved no parameter')

    _small_train_check(tiny, tiny_cpu, dev, 'vidar_tiny')
    del tiny, tiny_cpu

    # the backward kernels on the train step's inputs, against autograd of
    # the plain forward
    def compare_backward(counter, case, args, run_kernel, plain_fn, inputs,
                         n):
        g = args['g'] if 'g' in args else args['dout']
        got = run_kernel()
        want = _plain_grads(plain_fn, inputs, g)
        torch.cuda.synchronize()
        ok, err0, scale0 = True, None, None
        for x, gk, gp in zip(inputs, got, want):
            err = (gk.float() - gp).abs().max().item()
            scale = gp.abs().max().item()
            tol = BACKWARD_RTOL[gk.dtype] * scale
            ok = ok and err <= tol and bool(torch.isfinite(gk).all())
            print(f'  {counter.name}[{case}] d{tuple(x.shape)} '
                  f'{str(gk.dtype)[6:]}: err {err:.3g}, max|plain| '
                  f'{scale:.4g}, tolerance {tol:.3g}', flush=True)
            if err0 is None:
                err0, scale0 = err, scale
        plain_ms = _time_ms(lambda: _plain_grads(plain_fn, inputs, g))
        ms = _time_ms(run_kernel)
        record(counter, case, err0, scale0, ok, ms, plain_ms,
               _cost(counter.name, args, _nbytes(*got)), n)
        return ok

    def compare_backwards(kept, render_case, n):
        """K5 on every kept case, K6/K7 and K8 on ``render_case`` -> [ok]."""
        oks = []
        for case, a in sorted(kept[msda.BACKWARD.name].inputs.items()):
            shapes = a['spatial_shapes']
            oks.append(compare_backward(
                msda.BACKWARD, f'{case},{str(a["value"].dtype)[6:]}', a,
                lambda a=a: msda.msda_backward_cuda(
                    a['value'], a['spatial_shapes'], a['loc'], a['weights'],
                    a['dout']),
                lambda v, lo, w, s=shapes: msda.msdeform_attn_plain(v, s, lo,
                                                                    w),
                (a['value'], a['loc'], a['weights']), n))
        a = kept[latent_render.FIRST_HIT_BACKWARD.name].inputs[render_case]
        geo = (a['grids'], a['radial_norm'], a['steps'])

        def first_hit_backward():
            return (latent_render.ray_first_hit_backward_cuda(
                a['occ'], *geo, a['act'], a['g']),)
        oks.append(compare_backward(
            latent_render.FIRST_HIT_BACKWARD, render_case, a,
            first_hit_backward,
            lambda o: latent_render.ray_first_hit_plain(o, *geo, a['act']),
            (a['occ'],), n))
        # the kernel K6/K7 ran; its device time includes the wrapper's
        # zeroing of d occ (and, for a bf16 map, the cast to bf16)
        record_path(latent_render.FIRST_HIT_BACKWARD, render_case,
                    latent_render.ray_first_hit_backward_route(a['occ'],
                                                               a['g']),
                    first_hit_backward)
        b = kept[latent_render.AGGREGATE_BACKWARD.name].inputs[render_case]
        geo_b = (b['grids'], b['radial_norm'], b['steps'])
        rest = (b['c_r'], b['zdim'], b['eps'])

        def aggregate_backward():
            return (latent_render.ray_aggregate_backward_cuda(
                b['fused_map'], *geo_b, *rest, b['g']),)
        oks.append(compare_backward(
            latent_render.AGGREGATE_BACKWARD, render_case, b,
            aggregate_backward,
            lambda fm: latent_render.ray_aggregate_plain(fm, *geo_b, *rest),
            (b['fused_map'],), n))
        # the kernel K8 ran, and its device time with the wrapper's zeroing
        # (and, for a bf16 map, the cast to bf16)
        record_path(latent_render.AGGREGATE_BACKWARD, render_case,
                    latent_render.ray_aggregate_backward_route(
                        b['fused_map'], b['g']),
                    aggregate_backward)
        return oks

    oks = compare_backwards(keepers, 'encoder', train_launches)
    # K2 on the step's own inputs: the camera-sequential backbone's
    # one-image calls and the history's 24-image calls, as in phase 3
    kept = keepers[dcn.KERNEL.name].inputs
    for case in ('stage3,b1', 'stage3,b24'):
        if case not in kept:
            raise RuntimeError(f'the train step never ran K2 at {case}')
        a = kept[case]
        args = (a['x'], a['sx'], a['sy'], a['mask'], a['weight'])
        oks.append(compare(dcn.KERNEL, case, a,
                           lambda args=args: dcn.dcn_conv_cuda(*args),
                           lambda args=args: dcn.dcn_conv_plain(*args),
                           n=train_launches))
    keepers.clear()
    if not all(oks):
        raise RuntimeError('a backward kernel or K2 disagrees with its plain '
                           'version on the train step')

    # two timed steps, then the forward alone as the step runs it (autograd
    # on, activations saved), its graph freed without a backward
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        metrics = step(tr_batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError('non-finite train metrics in the timed steps')
    fwd = []
    tr_model.train()
    for _ in range(2):
        t0 = time.perf_counter()
        losses = tr_model(tr_batch, generator=step.generator,
                          gumbel_generator=step.generator,
                          train_frame_gate=step.frame_gate())
        torch.cuda.synchronize()
        fwd.append(time.perf_counter() - t0)
        del losses
    st, ft = sum(times) / len(times), sum(fwd) / len(fwd)
    print(f'train step (vidar_base bf16 compute, f32 params, bs {bs}, {q}+1 '
          f'frames x {cams} cams {ih}x{iw}, 3 futures, {pts} GT points): '
          f'{" ".join(f"{t:.4f}" for t in times)} s -> {st:.4f} s/it; '
          f'forward alone (autograd on) '
          f'{" ".join(f"{t:.4f}" for t in fwd)} s -> {ft:.4f} s '
          f'(backward + update / forward {(st - ft) / ft:.3f}); '
          f'peak memory {peak / 2**30:.2f} GiB; loss {metrics["loss"]:.5f}, '
          f'grad_norm {metrics["grad_norm"]:.5g}, sca_overflow '
          f'{metrics["sca_overflow"]} on {card}', flush=True)

    del tr_model, step, tr_batch
    torch.cuda.empty_cache()

    # -- phase 6: the f32 fine-tune at full width and depth, the full-window
    # eval and three streamed frames; every count set to 0 around them
    det_kernels = [msda.KERNEL, dcn.SAMPLE, latent_render.FIRST_HIT,
                   latent_render.AGGREGATE]
    keepers = {msda.KERNEL.name: _Keeper(_det_msda_case),
               dcn.SAMPLE.name: _Keeper(_dcn_case),
               latent_render.FIRST_HIT.name: _Keeper(lambda a: 'det_encoder'),
               latent_render.AGGREGATE.name: _Keeper(lambda a: 'det_encoder')}
    dcfg = vidar_finetune_1_8_nusc_3future()
    det = BEVFormer(**dcfg, device=dev).eval()
    det.randomize_(torch.Generator(device=dev).manual_seed(4), 0.02)
    n_gt, max_gt = 40, 128
    det_batch = make_synthetic_det_batch(
        np.random.default_rng(0), bs=bs, queue_length=q, num_cams=cams,
        img_h=ih, img_w=iw, max_points=64, max_gt=max_gt, num_gt=n_gt,
        device=dev)
    full = DetectionRunner(det, device=dev)
    stream = DetectionRunner(det, streaming=True, device=dev)
    frames = [(_window(det_batch, q - 1 + k), _stream_meta(k))
              for k in range(3)]

    def det_eval():
        out = {'full': full(det_batch)}
        stream.reset()
        for k, (b_k, meta) in enumerate(frames):
            out[f'stream{k}'] = stream(b_k, meta)
        return out

    t0 = time.perf_counter()
    samples, det_launches = _run_counted(counted, keepers, det_eval)
    det_first_s = time.perf_counter() - t0
    print(f'fine-tune eval 1 (incl. warm-up; full window + 3 streamed '
          f'frames): {det_first_s:.3f} s; launches '
          f'{json.dumps(det_launches)}', flush=True)
    for k in det_kernels:
        if det_launches[k.name] <= 0:
            raise RuntimeError(f'kernel {k.name} never launched in the '
                               f'fine-tune eval')
    if det_launches[dcn.KERNEL.name] or det_launches[dcn.SAMPLE16.name]:
        raise RuntimeError('the f32 fine-tune ran K2 or K10, the bf16 DCN')
    for name, (pred, gt) in samples.items():
        _check_detections(name, pred, gt, dcfg['num_classes'])
    if len(samples['full'][1]['boxes']) != n_gt:
        raise RuntimeError('ground truth lost boxes')
    metrics = evaluate_detection({k: p for k, (p, _) in samples.items()},
                                 {k: g for k, (_, g) in samples.items()},
                                 CLASS_NAMES)
    if not all(np.isfinite(v) for v in metrics.values()) or not (
            0 <= metrics['mAP'] <= 1 and 0 <= metrics['NDS'] <= 1):
        raise RuntimeError(f'detection metrics {metrics}')
    print(f'detections: {[len(p["boxes"]) for p, _ in samples.values()]} '
          f'valid boxes per sample (of 300); metrics on the synthetic boxes '
          f'(random weights): mAP {metrics["mAP"]:.4f}, NDS '
          f'{metrics["NDS"]:.4f}', flush=True)

    # small input: the fine-tune at test size through the kernels (card)
    # and the plain versions (CPU), same weights and batch, f32 on both
    tdcfg = vidar_finetune_tiny(use_grid_mask=False)
    tiny = BEVFormer(**tdcfg, device=dev).eval()
    _unit_scale_(tiny, torch.Generator(device=dev).manual_seed(5))
    tiny_cpu = BEVFormer(**tdcfg, device='cpu').eval()
    tiny_cpu.load_state_dict({k: v.cpu() for k, v in
                              tiny.state_dict().items()})
    sdb = make_synthetic_det_batch(np.random.default_rng(0), device='cpu')
    sides = []
    for m, d in ((tiny, dev), (tiny_cpu, 'cpu')):
        with torch.inference_mode():
            preds = m(sdb.frames.to(d), train=False)
            st = m.init_stream(1, d)
            for b_k in (_window(sdb, 2), sdb):
                sp, st = m.streaming_test(b_k.frames.to(d), st)
        sides.append({'window cls': preds['all_cls_scores'],
                      'window boxes': preds['all_bbox_preds'],
                      'streamed BEV': st.prev_bev,
                      'streamed cls': sp['all_cls_scores'],
                      'streamed boxes': sp['all_bbox_preds']})
    errs = {k: ((sides[0][k].cpu() - sides[1][k]).abs().max() /
                sides[1][k].abs().max()).item() for k in sides[1]}
    print(f'small input (fine-tune tiny, 64x64, f32), card vs CPU plain, '
          f'max err / max|CPU|: {json.dumps(errs)}', flush=True)
    # f32 on both sides (TF32 off); sums in other orders through ~50
    # layers: the CPU tests' 1e-3 against the JAX package
    if max(errs.values()) > 1e-3:
        raise RuntimeError('small-input fine-tune eval disagrees with the '
                           'CPU')

    # K9 and the fine-tune's K1 calls against their plain versions
    oks = []
    for case, a in sorted(keepers[dcn.SAMPLE.name].inputs.items()):
        args = (a['x'], a['sx'], a['sy'], a['mask'])
        oks.append(compare_dcn_taps(
            dcn.SAMPLE, case, a, lambda args=args: dcn.dcn_sample_cuda(*args),
            lambda args=args: dcn.dcn_sample_plain(*args), det_launches))
    kept = keepers[msda.KERNEL.name].inputs
    for case in ('det_tsa', 'det_sca', 'det_decoder'):
        a = kept[case]
        oks.append(compare(
            msda.KERNEL, f'{case},{str(a["value"].dtype)[6:]}', a,
            lambda a=a: msda.msda_forward_cuda(a['value'],
                                               a['spatial_shapes'],
                                               a['loc'], a['weights']),
            lambda a=a: msda.msdeform_attn_plain(a['value'],
                                                 a['spatial_shapes'],
                                                 a['loc'], a['weights']),
            n=det_launches))
    oks += compare_render(keepers, 'det_encoder', det_launches)
    keepers.clear()
    if not all(oks):
        raise RuntimeError('a kernel disagrees with its plain version on the '
                           'fine-tune path')

    # timed: two full-window samples, then three streamed frames
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full_t, stream_t = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        full(det_batch)
        torch.cuda.synchronize()
        full_t.append(time.perf_counter() - t0)
    full_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stream.reset()
    for b_k, meta in frames:
        t0 = time.perf_counter()
        stream(b_k, meta)
        torch.cuda.synchronize()
        stream_t.append(time.perf_counter() - t0)
    stream_peak = torch.cuda.max_memory_allocated()
    ft, stt = sum(full_t) / len(full_t), sum(stream_t) / len(stream_t)
    print(f'fine-tune eval (vidar_finetune_1_8_nusc_3future f32, bs {bs}, '
          f'{q}+1 frames x {cams} cams {ih}x{iw}, 900 queries, 200x200 BEV, '
          f'6 encoder layers): full window '
          f'{" ".join(f"{t:.4f}" for t in full_t)} s -> {ft:.4f} s/sample, '
          f'peak memory {full_peak / 2**30:.2f} GiB; streaming '
          f'{" ".join(f"{t:.4f}" for t in stream_t)} s -> {stt:.4f} s/frame, '
          f'peak memory {stream_peak / 2**30:.2f} GiB on {card}', flush=True)
    del full, stream, samples

    # -- phase 7: the fine-tune train step at the same shapes
    torch.cuda.empty_cache()
    det_step = DetTrainStep(det, make_optimizer(det, device=dev),
                            generator=torch.Generator(device=dev).manual_seed(
                                6), device=dev)
    before = [p.detach().clone() for p in det.parameters()]
    keepers = {k.name: _Keeper(_det_msda_case if k is msda.BACKWARD
                               else lambda a: 'det_encoder')
               for k in backward_kernels}
    keepers.update({msda.KERNEL.name: _Keeper(_det_msda_case),
                    dcn.SAMPLE.name: _Keeper(_dcn_image_case)})
    t0 = time.perf_counter()
    metrics, det_train_launches = _run_counted(
        counted, keepers, lambda: det_step(det_batch))
    warm_s = time.perf_counter() - t0
    print(f'fine-tune train step 1 (incl. warm-up): {warm_s:.3f} s; '
          f'launches {json.dumps(det_train_launches)}; metrics '
          f'{json.dumps(metrics)}', flush=True)
    for k in det_kernels + backward_kernels:
        if det_train_launches[k.name] <= 0:
            raise RuntimeError(f'kernel {k.name} never launched in the '
                               f'fine-tune train step')
    if det_train_launches[dcn.KERNEL.name] or det_train_launches[
            dcn.SAMPLE16.name]:
        raise RuntimeError('the f32 fine-tune train step ran K2 or K10')
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError('non-finite fine-tune train metrics')
    if not metrics['grad_norm'] > 0:
        raise RuntimeError('zero gradient norm in the fine-tune step')
    moved = sum(bool((p.detach() != b0).any())
                for p, b0 in zip(det.parameters(), before))
    del before
    print(f'parameters moved: {moved} of {len(list(det.parameters()))}',
          flush=True)
    if moved == 0:
        raise RuntimeError('the fine-tune step moved no parameter')

    # small-input fine-tune train check: the train forward (dropout and
    # grid mask off), the Hungarian-matched losses and their gradients
    sides = []
    for m, d in ((tiny, dev), (tiny_cpu, 'cpu')):
        m.zero_grad(set_to_none=True)
        b_d = sdb.to(d)
        losses = m.loss(m(b_d.frames, train=True), b_d.gt_bboxes,
                        b_d.gt_labels, b_d.num_valid_gt)
        sum(losses.values()).backward()
        grads = {n: (p.grad if p.grad is not None else
                     torch.zeros_like(p)).float().cpu()
                 for n, p in m.named_parameters()}
        sides.append(({k: float(x.detach()) for k, x in losses.items()},
                      grads))
    loss_err, cos, per_tensor = _grad_agreement(sides)
    worst = min(per_tensor, key=per_tensor.get)
    print(f'small input fine-tune train (tiny, 64x64, f32), card vs CPU '
          f'plain: losses max rel diff {loss_err:.3g}; gradient cosine '
          f'{cos:.6f} (flattened), min per tensor {per_tensor[worst]:.5f} '
          f'({worst}, {len(per_tensor)} tensors)', flush=True)
    # f32 on both sides: the same assignment, sums in other orders (and
    # the backward kernels' atomics)
    if loss_err > 1e-3 or cos < 0.999 or per_tensor[worst] < 0.99:
        raise RuntimeError('small-input fine-tune train step disagrees with '
                           'the CPU')
    del tiny, tiny_cpu, sides

    # the backward kernels on the fine-tune step's f32 inputs (K5 at each
    # of its attentions), against autograd of the plain forward
    kept = sorted(keepers[msda.BACKWARD.name].inputs)
    if kept != ['det_decoder', 'det_sca', 'det_tsa']:
        raise RuntimeError(f'the fine-tune step ran K5 for {kept} only')
    oks = compare_backwards(keepers, 'det_encoder', det_train_launches)
    # K9 on the step's own inputs: the history's 24-image calls and the
    # camera-sequential backbone's 1-image calls, at stages 3 and 4
    kept = keepers[dcn.SAMPLE.name].inputs
    for case in ('stage3,b1', 'stage3,b24', 'stage4,b1', 'stage4,b24'):
        if case not in kept:
            raise RuntimeError(f'the fine-tune step never ran K9 at {case}')
        a = kept[case]
        args = (a['x'], a['sx'], a['sy'], a['mask'])
        oks.append(compare_dcn_taps(
            dcn.SAMPLE, case, a, lambda args=args: dcn.dcn_sample_cuda(*args),
            lambda args=args: dcn.dcn_sample_plain(*args),
            det_train_launches))
    keepers.clear()
    del kept, a, args  # the kept inputs stay out of the timed steps' peak
    if not all(oks):
        raise RuntimeError('a backward kernel or K9 disagrees with its plain '
                           'version on the fine-tune path')

    # two timed steps; then one with the host's Hungarian calls timed on
    # their own (a synchronisation before each)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        metrics = det_step(det_batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError('non-finite metrics in the timed fine-tune steps')
    lap_host = bbox_core.hungarian_assign
    lap_s = []

    def timed_lap(cost, n_valid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lap_host(cost, n_valid)
        lap_s.append(time.perf_counter() - t0)
        return out

    bbox_core.hungarian_assign = timed_lap
    try:
        det_step(det_batch)
    finally:
        bbox_core.hungarian_assign = lap_host
    st = sum(times) / len(times)
    print(f'fine-tune train step (f32, bs {bs}, {q}+1 frames x {cams} cams '
          f'{ih}x{iw}, {n_gt} GT boxes of {max_gt}): '
          f'{" ".join(f"{t:.4f}" for t in times)} s -> {st:.4f} s/it; '
          f'peak memory {peak / 2**30:.2f} GiB; loss {metrics["loss"]:.5f}, '
          f'grad_norm {metrics["grad_norm"]:.5g}; Hungarian on the host: '
          f'{len(lap_s)} calls, {1e3 * sum(lap_s):.2f} ms per step (copy + '
          f'scipy, after a synchronisation) on {card}', flush=True)
    del det_step, det, det_batch
    torch.cuda.empty_cache()

    # -- phase 8: the bf16 forecast with a deformable conv in every ResNet
    # stage; stage 1 (C = CO = 64) is a shape K2 does not take
    dcn_cfg = vidar_base(backbone_dcn=(True, True, True, True))
    model = ViDAR(**dcn_cfg, dtype=torch.bfloat16, device=dev).eval()
    model.randomize_(torch.Generator(device=dev).manual_seed(7), 0.02)
    batch = make_synthetic_batch(np.random.default_rng(0), bs=bs,
                                 queue_length=q, future_length=f,
                                 num_cams=cams, img_h=ih, img_w=iw,
                                 max_points=pts, device=dev)
    runner = ForecastRunner(model, (ih, iw), num_future=f, device=dev)
    keepers = {dcn.SAMPLE16.name: _Keeper(_dcn_case),
               dcn.KERNEL.name: _Keeper(_dcn_image_case)}
    t0 = time.perf_counter()
    out, dcn_launches = _run_counted(counted, keepers, lambda: runner(batch))
    print(f'all-DCN forecast 1 (incl. warm-up): '
          f'{time.perf_counter() - t0:.3f} s; launches '
          f'{json.dumps(dcn_launches)}', flush=True)
    # one sample: ResNet-101's 3 stage-1 blocks run K10, its 4 + 23 + 3
    # stage-2 to stage-4 blocks K2, each once over the 30 images
    if dcn_launches[dcn.SAMPLE16.name] != 3 or dcn_launches[
            dcn.KERNEL.name] != 30:
        raise RuntimeError('the all-DCN forecast did not run K10 3 times and '
                           'K2 30 times')
    for k in forward_kernels:
        if dcn_launches[k.name] <= 0:
            raise RuntimeError(f'kernel {k.name} never launched on the '
                               f'all-DCN forecast')
    if dcn_launches[dcn.SAMPLE.name] or any(dcn_launches[k.name]
                                            for k in backward_kernels):
        raise RuntimeError('the all-DCN forecast ran K9 or a backward kernel')
    _check_forecast(out, dcn_cfg, bs, pts)
    del out

    a = keepers[dcn.SAMPLE16.name].inputs['stage1']
    args = (a['x'], a['sx'], a['sy'], a['mask'])
    oks = [compare_dcn_taps(
        dcn.SAMPLE16, 'stage1', a, lambda: dcn.dcn_sample16_cuda(*args),
        lambda: dcn.dcn_sample16_plain(*args), dcn_launches)]
    a = keepers[dcn.KERNEL.name].inputs['stage2']
    args2 = (a['x'], a['sx'], a['sy'], a['mask'], a['weight'])
    oks.append(compare(dcn.KERNEL, 'stage2', a,
                       lambda: dcn.dcn_conv_cuda(*args2),
                       lambda: dcn.dcn_conv_plain(*args2), n=dcn_launches))
    keepers.clear()
    del a, args, args2
    if not all(oks):
        raise RuntimeError('a kernel disagrees with its plain version on the '
                           'all-DCN forecast')

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = runner(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(out['pred_dist']).all()):
        raise RuntimeError('timed all-DCN forecast gave non-finite distances')
    dt = sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated()
    print(f'all-DCN forecast (vidar_base bf16, backbone_dcn (True,) * 4, '
          f'bs {bs}, {q}+1 frames x {cams} cams {ih}x{iw}, {f} futures, {pts} '
          f'rays): {" ".join(f"{t:.4f}" for t in times)} s -> {dt:.4f} '
          f's/sample, peak memory {peak / 2**30:.2f} GiB; phase 4 (stages 3-4 '
          f'DCN) {forecast_s:.4f} s/sample, {forecast_peak / 2**30:.2f} GiB '
          f'on {card}', flush=True)
    del model, runner, batch, out
    torch.cuda.empty_cache()

    tiny, tiny_cpu = _tiny_pair(vidar_tiny(use_grid_mask=False,
                                           backbone_dcn=(True,) * 4,
                                           frozen_stages=0), dev, 8)
    for k in counted:
        k.launches = 0
    _small_forecast_check(tiny, tiny_cpu, dev, 'vidar_tiny all-DCN')
    # the losses against the largest: the dense-voxel loss decodes each
    # voxel's ray at its argmax waypoint, so a near tie that the two
    # devices' bf16 roundings break apart moves that small loss by a step
    _small_train_check(tiny, tiny_cpu, dev, 'vidar_tiny all-DCN',
                       each_loss=False)
    if not dcn.SAMPLE16.launches:
        raise RuntimeError('the small all-DCN checks never ran K10')
    del tiny, tiny_cpu

    for r in results:
        base = r['name'].split('[')[0]
        r.setdefault('train_launches', train_launches[base])
        r['det_eval_launches'] = det_launches[base]
        r['det_train_launches'] = det_train_launches[base]
        r['all_dcn_launches'] = dcn_launches[base]
    print(json.dumps({'kernels': results}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
