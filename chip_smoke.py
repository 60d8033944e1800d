"""Chip smoke test of the PyTorch/CUDA port: the ViDAR forecast, the
pre-training step, the BEVFormer detection fine-tune (eval, streaming eval
and train step, in f32 and bf16), the train and test CLIs on the released
configs (each one it does not run is held to one it runs by
tests/test_torch_config_matrix.py), data parallelism across processes,
UniAD (its eval, clip train step and CLIs), the data path from raw
nuScenes tables through the port's data-preparation tools, and the
BEVFormerV2 family (with DD3D and InternImage), the voxel renderer and the
visualisation tool, on one GPU.

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
   in phase 3; then a timed step, the forward alone (autograd on, the
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
   a timed step with peak device memory, and one step with the host's
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
   route and its backward run through autograd on the card;
9. the port's CLIs in this process, with PyTorch's default numerics
   switches, on a nuScenes-format fixture written here (one scene of 14
   samples, 6 cameras at 900x1600 as baseline JPEG, 4:2:0 at quality 90,
   from a numpy encoder of this script with the IJG and Annex K tables,
   and as PNG; 34720 seeded lidar points and 40 GT boxes of the 10
   detection classes a sample): the host library's JPEG decoder equal bit
   for bit to ``data/jpeg.py`` on a small image and each camera within 30
   dB PSNR of its source; the loader's host seconds per train sample on
   JPEG on one thread (and a cProfile of one) and on the train CLI's 4
   threads, and one PNG sample on one thread; ``tools.train`` on the
   released pre-training config (``vidar_1_8_nusc_3future``, f32, full
   width and depth, its ``ida_aug_conf`` resize, crop and flip) for 1
   step with its eval hook once; ``tools.test`` on that checkpoint (2
   samples, 7 frames of metrics); ``tools.train`` on the released
   fine-tune config for 1 step from that checkpoint (n_loaded > 0);
   ``tools.test`` on the fine-tuned checkpoint, full window and streaming
   (2 samples, NDS and mAP); ``tools.train`` on the mem-efficient
   pre-training config for 1 step; on the BEVFormer baseline for 1 step
   from a synthetic ``r101_dcn_fcos3d_pretrain.pth`` (the published
   R101-DCN shapes under ``backbone.``, with decoy keys: every backbone
   tensor grafted, none mismatched, only the decoys unmapped); and on the
   OpenScene pre-training config for 1 step, on a second fixture of 8
   JPEG cameras at 1080x1920 and PCD lidar. Each run's wall time, s/it,
   ``data_wait_s``, peak device memory and launches (K1, K9 and, but in
   the baseline, K3, K4 in every run; K5 and, but in the baseline, K6/K7
   and K8 in the train runs; K2 and K10 in none); finite losses and
   metrics; the checkpoint directories. The pre-training, forecast-eval
   and OpenScene runs keep each kernel's first f32 input of each case, and
   every kernel is held against its plain version on them at the
   tolerances of phases 3-7: K1 at TSA, SCA (6 and 8 cameras) and the
   rollout decoder, K9 at each ResNet call, K3/K4, and (train runs) K5 at
   each attention and K6/K7 and K8 on the step's own gradients;
10. data parallelism across processes (``vidar_tpu_torch.parallel``).
   a: one process at bs 2 on two samples whose counts of GT points and
   valid rays differ (``vidar_base`` bf16 at phase 5's shapes and
   weights, no grid mask, no dropout, Gumbel argmax: a warm-up step kept,
   one timed step), then two spawned ranks of one sample each on the one
   card over Gloo (NCCL refuses two ranks on one device): a counted
   warm-up step (K1-K8 must launch on each rank, K9 and K10 not), a timed
   step with the gradient all-reduce timed, the parameters' digests equal
   between the ranks after every step, step 1's losses, summed gradients
   and update held to the bs-2 process (``DP_LOSS_RTOL``,
   ``DP_MIN_COSINE``); then the same at test size with ``DetTrainStep``
   (f32, 0 GT boxes on rank 0, 40 on rank 1). Each rank's s/it (two ranks
   share the card: not a speed), all-reduce seconds, gradient bytes and
   peak memory. b: the train CLI (1 step, loading on one thread) and the
   test CLI's forecast eval (2 samples, on its 4 loader threads) on the
   released pre-training config with ``--coordinator --num-processes 1
   --process-id 0`` on NCCL (the backend printed), against the same runs
   without a process group (``DP_CLI_RTOL``). c: the train CLI at two
   ranks on two cards over
   NCCL, only where the machine shows two cards; the line says whether it
   ran;
11. UniAD (``configs/uniad/stage2_e2e/vidar_e2e.py``: embed 256, BEV
   200x200, 900 track and 300 map queries, 6 cameras, R101 with DCN in
   stages 3-4, latent rendering at layer 2, 12 steps x 6 modes), f32,
   ``init_weights_`` from seed 0. a: 3 streamed eval frames on a synthetic
   6 x 928x1600 batch (s/frame, peak memory, tracks alive), a fourth
   frame timed stage by stage with CUDA events (``_stage_times``: the
   track stages, each head, the occupancy dense decoder and transformer
   layers, the planning BEV adapter, attention and collision
   optimisation, and the rest, in ms as one JSON line), then the clip
   train step (``UniADTrainStep``, 40 agents with persistent ids) at the
   config's 6 frames (no cut: a clip that does not fit fails the phase):
   a step at 2 frames as the warm-up (its peak beside the 73.2 GiB of the
   same step with nothing recomputed), then the timed 6-frame step (s/it,
   peak memory with the kernels' kept inputs), each counted step's
   launches by case held to the counts the code gives
   (``_uniad_clip_launches``: the backbone camera by camera and every
   frame's BEV encoder recomputed in the backward); b: on phase 9's JPEG
   fixture with persistent instances (``_uniad_fixture``): the train CLI
   on ``vidar_e2e.py`` for 1 step of the config's clip (its launches
   held likewise), its UniAD eval of 4 samples of one scene (the six
   metrics ``UNIAD_KEYS``, each finite, printed), ``base_track_map.py``
   for 1 step of a 2-frame clip (K1, K5 and K9; no latent rendering; a
   depth cut: the e2e runs take its modules through 6 frames); each
   run's wall time, peak memory and launches; c: UniAD across processes
   (``_phase11c``): two Gloo ranks of ``vidar_e2e.py`` on the one card,
   each with a clip of its own (40 and 24 agents, 8 and 3 map elements),
   dropout off, at the config's clip or, where a rank runs out of device
   memory, one frame fewer each time (the cut printed), one step a rank
   (its warm-up included): per rank s/it, the gradient all-reduce's
   seconds and bytes and peak memory, the ranks' parameters
   bit-identical after the step (a mismatch fails);
   the UniAD train (a 2-frame clip) and test CLIs on NCCL at world size
   1; the train CLI at two NCCL ranks on two cards
   where the machine shows two (the line says whether it ran).
   The eval, the step and the e2e CLI runs keep each kernel's first input
   of each case and hold it against its plain version (phase 9's check):
   K1 and K5 at the motion head's 64,872 folded queries, the panoptic
   encoder's 40,000 and decoder's 300, the track decoder's 900, TSA and
   SCA; K9 at stages 3-4; K3/K4 and K6/K7, K8. ``uniad_*_launches``,
   ``cli_uniad_*_launches`` and ``uniad_dp_rank*_launches`` in the kernel
   line;
12. the data path from raw tables, the rest of the fine-tune, the
   analysis tools and the video step (``_phase12``). a: nuScenes v1.0
   tables (``_write_nuscenes_tables``: 2 trainval scenes and 1 test scene
   of 40 keyframes, 6 JPEG cameras at 900x1600 (phase 9's, shared by the
   rows), 34720 lidar points a keyframe and 9 sweeps at 20 Hz between
   keyframes, 40 tracked instances, CAN bus at 50 Hz, map expansions along
   the ego path); b: the port's converter, map converter, k-means anchors
   (6 modes, 12 steps) and merge-fullset on them, each output checked
   against what was written (``_check_converted``: counts, frame_idx, the
   nearest CAN-bus message, the GT boxes in the lidar frame), the
   converter's host time a sample; c: ``vidar_e2e.py`` through the train
   CLI for 1 step on the converted train pkl with its map gt and k-means
   anchors (a 2-frame clip), ``map.loss`` finite and above
   0, then its UniAD eval on the val pkl; d: the fullset pre-training
   config for 1 step on the merged traintest pkl; e: ``BEVFormerFP16`` at
   phase 6's full width and batch: the window eval, 3 streamed frames and a
   train step with every kernel counted and held against its plain
   version on its kept bf16 inputs (K1b at TSA, SCA and the detection
   decoder, K2 at each ResNet call, K3/K4, K5, K6/K7, K8), then both
   fine-tune CLIs with ``model.type=BEVFormer_fp16`` on the converted
   pkls; f: ``hungarian_assign(impl='auction')`` on the card against
   scipy on the fine-tune's cost [900, G], G = 40 and 200 (the total
   within G x eps, both times, the rounds); g: ``count_params`` of
   ``vidar_1_8_nusc_3future`` and ``vidar_e2e.py`` equal to the models
   built, ``benchmark`` (3 samples) beside phase 4, ``profile_trace`` (its
   ``timer`` spans and device kernels in the trace), ``visibility_scan`` on
   the converted pkl; h: one video-replay train step of ``vidar_base`` in
   bf16 at full width. ``p12_*_launches`` in the kernel line;
13. the BEVFormerV2 family, the voxel renderer and the visualisation tool
   (``_phase13(counted, card, check, dev, fixture_dir, tables, data)``,
   runnable alone after ``_build.load_library()`` with phase 9's fixture
   and phase 12's tables). b: DD3D (``VoVNet('V-99-eSE')``, the port's FPN
   to 5 levels at 256 channels, ``NuScenesDD3D``) on one camera image of
   one sample of phase 12's converted train pkl (``NuScenesMonoDataset``,
   its JPEG through the port's decoder): forward, ``loss`` on the
   sample's targets, backward, ``inference`` with the class-wise NMS;
   a: ``BEVFormerV2`` at the JAX defaults (embed 256, BEV 200x200, 900
   queries, R101 with DCN in stages 3-4, 6 encoder layers, ``num_fusion``
   3, frames (-1, 0)), f32, bs 1, 6 cameras at 928x1600, random 0.02-scale
   weights: the eval forward and ``get_bboxes``, then a train step
   (``loss`` with b's DD3D losses through the mono hook, backward,
   ``make_optimizer``'s AdamW over both models), each with its launches
   held to the counts the code gives (eval: K1 30, K9 52; step: K1 30, K5
   18 for frame 0 only, K9 338 with the camera-sequential recompute), s/it
   and peak memory, every kept K1, K5 and K9 input against its plain
   version; the small-input V2 check, card vs CPU; c: InternImage-T on 6 x
   928x1600, forward, backward and one ``make_layer_decay_optimizer`` step
   (DCNv3 on K1 and K5, 30 launches each, held against their plain
   versions by stage), then ``dcnv3_core``'s msda route against its plain
   gather at each stage's shape (error, both times, K1's bound); d:
   ``voxel_render_loss`` forward and backward and ``voxel_render_v2`` at
   sigma [1, 3, 16, 200, 200], 32,768 rays, ``max_steps`` 417 (times, peak
   memory), and a small-size card vs CPU check; e: the test CLI's
   ``--viz-pcd`` on ``configs/tiny/vidar_tiny.py`` (6 cameras) on phase 9's
   fixture, ``tools.visualize detections`` on a fine-tune ``--dump-viz``
   pickle and ``browse``, every PNG read back by this script's own zlib
   decoder (``_read_png``: size, colours). ``v2_eval_launches``,
   ``v2_step_launches``, ``internimage_launches`` and
   ``viz_*_cli_launches`` in the kernel line;
14. the released configs that no earlier phase runs, at their widths,
   through the CLIs with PyTorch's default switches on phase 9's fixtures
   (``_phase14(counted, card, check, tmp, data, os_data, fixture_pkl)``):
   a: ``bevformer_small.py`` (BEV 150x150, 3 encoder layers, queue 3) 1
   step and the detection eval of 1 sample from its checkpoint (K1, K9,
   K5); b: ``bevformer_tiny.py`` (R50 without DCN, BEV 50x50) likewise
   from init (K1, K5; K9, K2 and K10 must not launch); c: the 1-future
   fine-tune (latent rendering at grid step 1.0) 1 step; d: the OpenScene
   submission config through the test CLI on 2 samples of the 8-camera
   fixture (5 history frames, the ego mask off): one depth file a future
   frame and sample, as many finite lines as that frame's rays; e:
   ``vidar_track_map.py`` and ``base_e2e.py`` 1 step each at a 2-frame
   clip (a depth cut: phase 11 runs the same modules at 6 frames); f: the
   released fine-tune config 2 steps from one init with cudnn's TF32
   switch on and off as the CLI starts (the CLI computes an f32 model's
   convolutions in f32: each loss term within ``TF32_LOSS_RTOL``, the
   gradient norms, the updates' largest relative difference). Each run's
   wall time, s/it, peak memory and launches; every kernel of a, b, c, d
   and e's ``vidar_track_map`` held against its plain version on the
   run's own inputs (phase 9's check). ``p14_*_launches`` in the kernel
   line.

Each phase's seconds are printed as it ends, and all of them with the
script's total after phase 14. The line before the last is a JSON object
of per-kernel results; the last is ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --clip-memory [FRAMES ...]`` runs none of the
above: UniAD's clip train step (``clip_memory``) by clip length (default
1 2) and by what its backward recomputes, for the memory table in
PERF.md.
"""

from __future__ import annotations

import cProfile
import dataclasses
import json
import math
import os
import pickle
import pstats
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib
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

# the timed train steps after a warm-up (phases 5, 7 and 13a): one keeps
# the script inside its time limit
TIMED_STEPS = 1

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
    case = {(2, 1): 'tsa', (6, 4): 'sca', (8, 4): 'sca8',
            (1, 1): 'decoder'}.get((b, levels))
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


def _stage_times(stages, fn):
    """Run fn with each (object, attribute, name) of ``stages`` wrapped in
    CUDA events on the current stream -> ({name: ms summed over its
    calls}, the whole call's ms); fn's result is dropped, so that it holds
    no device memory after. A stage may be a module's global function or
    lie inside another stage; each is restored after."""
    spans, wrapped = {}, []

    def wrap(obj, attr, name):
        inner = getattr(obj, attr)
        own = vars(obj).get(attr)

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*args, **kwargs)
            end.record()
            spans.setdefault(name, []).append((start, end))
            return out
        object.__setattr__(obj, attr, timed)
        wrapped.append((obj, attr, own))

    for obj, attr, name in stages:
        wrap(obj, attr, name)
    first = torch.cuda.Event(enable_timing=True)
    last = torch.cuda.Event(enable_timing=True)
    try:
        first.record()
        fn()
        last.record()
        torch.cuda.synchronize()
    finally:
        for obj, attr, own in wrapped:
            if own is None:
                object.__delattr__(obj, attr)
            else:
                object.__setattr__(obj, attr, own)
    return {name: sum(a.elapsed_time(b) for a, b in ev)
            for name, ev in spans.items()}, first.elapsed_time(last)


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



# ----------------------------------------------------- phase 9: the CLIs

ROOT = Path(__file__).resolve().parent
PRETRAIN_CONFIG = (ROOT / 'configs' / 'vidar_pretrain' / 'nusc_1_8_subset' /
                   'vidar_1_8_nusc_3future.py')
FINETUNE_CONFIG = (ROOT / 'configs' / 'vidar_finetune' / 'nusc_1_4_subset' /
                   'vidar_1_8_nusc_3future.py')
MEM_EFFICIENT_CONFIG = (ROOT / 'configs' / 'vidar_pretrain' /
                        'nusc_1_8_subset' /
                        'mem_efficient_vidar_1_8_nusc_3future.py')
OPENSCENE_CONFIG = (ROOT / 'configs' / 'vidar_pretrain' / 'OpenScene' /
                    'vidar_OpenScene_mini_1_8_3future.py')
BASELINE_CONFIG = (ROOT / 'configs' / 'vidar_finetune' / 'nusc_1_4_subset' /
                   'bevformer_1_4_baseline.py')
DET_CLASSES = ('car', 'truck', 'construction_vehicle', 'bus', 'trailer',
               'barrier', 'motorcycle', 'bicycle', 'pedestrian',
               'traffic_cone')
DET_ATTRS = {'car': 'vehicle.moving', 'truck': 'vehicle.parked',
             'construction_vehicle': 'vehicle.stopped',
             'bus': 'vehicle.moving', 'trailer': 'vehicle.parked',
             'barrier': '', 'motorcycle': 'cycle.with_rider',
             'bicycle': 'cycle.without_rider',
             'pedestrian': 'pedestrian.moving', 'traffic_cone': ''}


def _png_bytes(img):
    """An 8-bit RGB PNG of img [h, w, 3] uint8, every row Sub-filtered."""
    h, w, _ = img.shape
    sub = img.copy()
    sub[:, 1:] -= img[:, :-1]           # uint8: modulo 256, as PNG's Sub
    rows = np.concatenate([np.ones((h, 1), np.uint8), sub.reshape(h, -1)],
                          axis=1)

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body +
                struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))

    return (b'\x89PNG\r\n\x1a\n' +
            chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0)) +
            chunk(b'IDAT', zlib.compress(rows.tobytes(), 1)) +
            chunk(b'IEND', b''))


# The fixture's JPEG quality (IJG scaling of the Annex K tables)
JPEG_QUALITY = 90
# A fixture camera decodes within this PSNR of its source
JPEG_MIN_PSNR_DB = 30.0

# IJG's quantisation tables (Annex K, tables K.1 and K.2), natural order
_QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_QUANT_CHROMA = np.full(64, 99)
_QUANT_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# zigzag index -> natural index
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def _ac_symbols(head):
    rest = sorted({r << 4 | s for r in range(16) for s in range(1, 11)}
                  - set(head))
    return head + rest


# Annex K's Huffman tables (K.3-K.6): code counts by length and symbols
_HUFF = {
    'dc_luma': ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                list(range(12))),
    'dc_chroma': ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
                  list(range(12))),
    'ac_luma': ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
                _ac_symbols([
                    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21,
                    0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
                    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1,
                    0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
                    0x82, 0x09, 0x0a, 0x16])),
    'ac_chroma': ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
                  _ac_symbols([
                      0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31,
                      0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
                      0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1,
                      0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
                      0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17])),
}


def _huff_codes(counts, symbols):
    """symbol -> (code, length) arrays over 256 symbols (canonical)."""
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code = k = 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _quant(base, quality):
    """jpeg_quality_scaling and jpeg_add_quant_table (force baseline)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _dct_matrix():
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    c[0] /= np.sqrt(2)
    return c / 2


def _blocks(plane, bh, bw):
    """[bh*8, bw*8] -> [bh, bw, 64] (rows of each block)."""
    return plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(
        bh, bw, 64)


def _size(v):
    """The magnitude category of each value (0 for 0)."""
    a = np.abs(v)
    s = np.zeros(a.shape, np.int64)
    nz = a > 0
    s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return s


def _vbits(v, s):
    """The value bits of each coefficient: v, or v - 1 in s bits for v < 0."""
    return np.where(v < 0, v + (1 << s) - 1, v)


def _encode_jpeg(img, quality=JPEG_QUALITY):
    """A baseline JPEG of img [h, w, 3] uint8: 4:2:0, the IJG tables at
    `quality`, Annex K Huffman tables, a JFIF marker -> its bytes."""
    img = np.asarray(img, np.float64)
    h, w, _ = img.shape
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    mcux, mcuy = -(-w // 16), -(-h // 16)
    y = np.pad(planes[0], ((0, 16 * mcuy - h), (0, 16 * mcux - w)), 'edge')
    chroma = []
    for p in planes[1:]:
        p = np.pad(p, ((0, 16 * mcuy - h), (0, 16 * mcux - w)), 'edge')
        chroma.append(p.reshape(8 * mcuy, 2, 8 * mcux, 2).mean((1, 3)))
    qy, qc = _quant(_QUANT_LUMA, quality), _quant(_QUANT_CHROMA, quality)
    d = _dct_matrix()

    def coefs(plane, bh, bw, q):
        blk = _blocks(plane - 128.0, bh, bw).reshape(bh, bw, 8, 8)
        f = np.einsum('ui,abij,vj->abuv', d, blk, d).reshape(bh, bw, 64)
        return np.round(f / q).astype(np.int64)[..., _ZIGZAG]

    cy = coefs(y, 2 * mcuy, 2 * mcux, qy)                 # [2my, 2mx, 64]
    cy = cy.reshape(mcuy, 2, mcux, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
        mcuy, mcux, 4, 64)
    cb = coefs(chroma[0], mcuy, mcux, qc)[:, :, None]
    cr = coefs(chroma[1], mcuy, mcux, qc)[:, :, None]
    blocks = np.concatenate([cy, cb, cr], 2).reshape(-1, 64)  # MCU order
    comp = np.tile([0, 0, 0, 0, 1, 2], mcux * mcuy)
    chrom = (comp > 0).astype(np.int64)
    n = len(blocks)
    # DC differences within each component
    dc = blocks[:, 0].copy()
    diff = np.empty(n, np.int64)
    for c in range(3):
        idx = np.nonzero(comp == c)[0]
        diff[idx] = np.diff(dc[idx], prepend=0)
    tables = [_huff_codes(*_HUFF[k]) for k in
              ('dc_luma', 'dc_chroma', 'ac_luma', 'ac_chroma')]
    dcode = np.stack([tables[0][0], tables[1][0]])
    dlen = np.stack([tables[0][1], tables[1][1]])
    acode = np.stack([tables[2][0], tables[3][0]])
    alen = np.stack([tables[2][1], tables[3][1]])
    # events (block * 2048 + order): DC; per nonzero AC its ZRLs and its
    # symbol; EOB when the last nonzero is before 63
    s = _size(diff)
    keys = [np.arange(n) * 2048]
    vals = [(dcode[chrom, s] << s) | _vbits(diff, s)]
    lens = [dlen[chrom, s] + s]
    bi, k = np.nonzero(blocks[:, 1:])
    k = k + 1
    v = blocks[bi, k]
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    nzrl = run // 16
    for j in range(3):
        m = nzrl > j
        keys.append(bi[m] * 2048 + k[m] * 16 + j)
        cz = chrom[bi[m]]
        vals.append(acode[cz, 0xF0])
        lens.append(alen[cz, 0xF0])
    s = _size(v)
    sym = (run % 16) << 4 | s
    cz = chrom[bi]
    keys.append(bi * 2048 + k * 16 + 8)
    vals.append((acode[cz, sym] << s) | _vbits(v, s))
    lens.append(alen[cz, sym] + s)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, bi, k)
    m = last < 63
    keys.append(np.nonzero(m)[0] * 2048 + 2047)
    vals.append(acode[chrom[m], 0x00])
    lens.append(alen[chrom[m], 0x00])
    order = np.argsort(np.concatenate(keys), kind='stable')
    vals = np.concatenate(vals)[order]
    lens = np.concatenate(lens)[order]
    # pack the bits, pad with ones, stuff a zero after each 0xFF
    start = np.cumsum(lens) - lens
    total = int(lens.sum())
    ev = np.repeat(np.arange(len(lens)), lens)
    pos = np.arange(total) - start[ev]
    bits = (vals[ev] >> (lens[ev] - 1 - pos)) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)])
    data = np.packbits(bits.astype(np.uint8))
    ff = np.nonzero(data == 0xFF)[0]
    data = np.insert(data, ff + 1, 0).tobytes()

    def seg(marker, body):
        return struct.pack('>BBH', 0xFF, marker, len(body) + 2) + body

    head = b'\xff\xd8' + seg(0xE0, b'JFIF\x00\x01\x01\x00\x00\x01\x00\x01'
                                   b'\x00\x00')
    for i, q in enumerate((qy, qc)):
        head += seg(0xDB, bytes([i]) + bytes(q[_ZIGZAG].astype(np.uint8)))
    head += seg(0xC0, struct.pack('>BHHB', 8, h, w, 3) +
                bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for tc_th, key in ((0x00, 'dc_luma'), (0x10, 'ac_luma'),
                       (0x01, 'dc_chroma'), (0x11, 'ac_chroma')):
        counts, symbols = _HUFF[key]
        head += seg(0xC4, bytes([tc_th, *counts, *symbols]))
    head += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return head + data + b'\xff\xd9'


def _camera_image(rng, h, w):
    """Image-like content [h, w, 3] uint8: smooth structure (a few random
    low-frequency waves per channel, soft-edged bright and dark boxes) plus
    mild noise (sigma 3)."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.empty((h, w, 3))
    for c in range(3):
        f = rng.uniform(1, 12, (4, 2))
        ph = rng.uniform(0, 2 * np.pi, 4)
        img[..., c] = 128 + sum(
            rng.uniform(10, 35) * np.sin(2 * np.pi * (f[k, 0] * xx +
                                                       f[k, 1] * yy) + ph[k])
            for k in range(4))
    for _ in range(12):
        y0, x0 = rng.uniform(0, 1, 2) * (h, w)
        bh, bw = rng.uniform(0.05, 0.3, 2) * (h, w)
        inside = np.minimum.reduce([
            yy * max(h, w) - y0, y0 + bh - yy * max(h, w),
            xx * max(h, w) - x0, x0 + bw - xx * max(h, w)])
        box = 0.5 * (1 + np.tanh(inside / 4))
        img += box[..., None] * rng.uniform(-60, 60, 3)
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _noise_image(rng, h, w):
    """The PNG fixture's content (as before): coarse noise, upsampled, plus
    fine noise."""
    coarse = rng.integers(0, 200, (h // 20 + 1, w // 20 + 1, 3),
                          dtype=np.uint8)
    img = coarse.repeat(20, 0).repeat(20, 1)[:h, :w]
    return img + rng.integers(0, 48, (h, w, 3), dtype=np.uint8)


def _write_pcd(path, pts):
    """Binary PCD (x y z intensity, F4), as OpenScene's merged point
    clouds."""
    n = len(pts)
    header = ('# .PCD v0.7 - Point Cloud Data file format\n'
              'VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n'
              'TYPE F F F F\nCOUNT 1 1 1 1\n'
              f'WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n'
              f'POINTS {n}\nDATA binary\n')
    with open(path, 'wb') as f:
        f.write(header.encode('ascii'))
        f.write(np.ascontiguousarray(pts[:, :4], np.float32).tobytes())


def _write_nuscenes_fixture(root, *, num_samples=14, num_cams=6,
                            img_hw=(900, 1600), num_points=34720,
                            num_gt=40, seed=0, lidar='bin', png=False,
                            distinct=4):
    """A one-scene dataset under root, in the info-pkl layout of
    tests/data/fake_nuscenes.py: num_cams ring cameras (nuScenes
    intrinsics) as baseline JPEG (4:2:0, JPEG_QUALITY) of ``distinct``
    image-like images, encoded once and reused; num_points seeded lidar
    points per frame (nuScenes .bin, 5 float32 a point, or OpenScene's
    binary PCD where lidar='pcd'); num_gt GT boxes per sample over the 10
    detection classes with velocity, attributes and num_lidar_pts > 0.
    With ``png``, a second pkl names a PNG of each camera (the content of
    the earlier PNG fixture: coarse and fine noise). -> (JPEG pkl, PNG pkl
    or None, the distinct source images, their JPEG bytes)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, 'samples'), exist_ok=True)
    h, w = img_hw
    sources = [_camera_image(rng, h, w) for _ in range(distinct)]
    jpegs = [_encode_jpeg(im) for im in sources]
    pngs = [_png_bytes(_noise_image(rng, h, w)) for _ in range(distinct)] \
        if png else None
    intrinsic = np.array([[1266.4, 0.0, w / 2], [0.0, 1266.4, h / 2],
                          [0.0, 0.0, 1.0]])
    infos = []
    for i in range(num_samples):
        t = i * 500000                       # 2 Hz, microseconds
        yaw = 0.02 * i
        pos = np.array([i * 2.0, 0.1 * i, 0.0])
        quat = [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]
        r = rng.uniform(2.0, 50.0, num_points)
        az = rng.uniform(-np.pi, np.pi, num_points)
        pts = np.stack([r * np.cos(az), r * np.sin(az),
                        rng.uniform(-1.8, 2.0, num_points),
                        rng.uniform(0, 255, num_points),
                        np.zeros(num_points)], 1).astype(np.float32)
        lidar_path = os.path.join(root, 'samples', f'lidar_{i}.{lidar}')
        if lidar == 'pcd':
            _write_pcd(lidar_path, pts)
        else:
            pts.tofile(lidar_path)
        cams = {}
        for c in range(num_cams):
            k = (i * num_cams + c) % distinct
            path = os.path.join(root, 'samples', f'img_{i}_{c}.jpg')
            with open(path, 'wb') as f:
                f.write(jpegs[k])
            if png:
                with open(path[:-4] + '.png', 'wb') as f:
                    f.write(pngs[k])
            a = 2 * np.pi * c / num_cams
            fwd = np.array([np.cos(a), np.sin(a), 0.0])
            right = np.array([np.sin(a), -np.cos(a), 0.0])
            # camera axes (x right, y down, z forward) in the lidar frame
            s2l = np.stack([right, [0.0, 0.0, -1.0], fwd], 1)
            cams[f'CAM{c}'] = dict(
                data_path=path, type=f'CAM{c}',
                sample_data_token=f'sd{i}_{c}',
                sensor2lidar_rotation=s2l,
                sensor2lidar_translation=fwd * 1.0 + np.array([0, 0, 1.5]),
                cam_intrinsic=intrinsic, timestamp=t)
        can_bus = np.zeros(18)
        can_bus[:3] = pos
        can_bus[3:7] = quat
        boxes = np.zeros((num_gt, 7))
        boxes[:, :2] = rng.uniform(-45, 45, (num_gt, 2))
        boxes[:, 2] = rng.uniform(-2.0, 0.0, num_gt)
        boxes[:, 3:6] = rng.uniform(0.5, 4.0, (num_gt, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, num_gt)
        names = np.array([DET_CLASSES[k % len(DET_CLASSES)]
                          for k in range(num_gt)])
        infos.append(dict(
            token=f'tok{i}', scene_token='scene0', frame_idx=i,
            prev=f'tok{i - 1}' if i else '',
            next=f'tok{i + 1}' if i + 1 < num_samples else '',
            timestamp=t, lidar_path=lidar_path,
            lidar2ego_translation=[0.9, 0.0, 1.8],
            lidar2ego_rotation=[1.0, 0.0, 0.0, 0.0],
            ego2global_translation=pos.tolist(),
            ego2global_rotation=quat, can_bus=can_bus, cams=cams, sweeps=[],
            gt_boxes=boxes, gt_names=names,
            gt_velocity=rng.uniform(-5, 5, (num_gt, 2)),
            gt_attrs=np.array([DET_ATTRS[n] for n in names]),
            num_lidar_pts=rng.integers(1, 200, num_gt),
            valid_flag=np.ones(num_gt, bool)))

    def dump(name, infos):
        pkl = os.path.join(root, name)
        with open(pkl, 'wb') as f:
            pickle.dump(dict(infos=infos,
                             metadata=dict(version='chip_smoke')), f)
        return pkl

    png_pkl = None
    if png:
        png_infos = pickle.loads(pickle.dumps(infos))
        for info in png_infos:
            for cam in info['cams'].values():
                cam['data_path'] = cam['data_path'][:-4] + '.png'
        png_pkl = dump('infos_png.pkl', png_infos)
    return dump('infos_train.pkl', infos), png_pkl, sources, jpegs


def _write_fcos3d_pth(path, seed=0, depth=101):
    """A synthetic ``r101_dcn_fcos3d_pretrain.pth``: mmdet's ResNet-101 with
    DCNv2 in stages 3-4 (each conv2 with its 27-channel ``conv_offset``)
    under ``backbone.``, at the published shapes, plus a few ``neck.`` and
    ``bbox_head.`` keys that no mapping rule reads. The convs at the scale
    of the port's own initialisation (the variance of U(+-1/sqrt(fan_in))),
    so that activations and gradients stay finite through 33 blocks; BN
    near identity; offsets near 0. -> the decoy keys."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(key, co, ci, k):
        sd[key] = torch.randn(co, ci, k, k, generator=gen) / math.sqrt(
            3.0 * ci * k * k)

    def bn(key, c):
        sd[f'{key}.weight'] = 1 + 0.05 * torch.randn(c, generator=gen)
        sd[f'{key}.bias'] = 0.05 * torch.randn(c, generator=gen)
        sd[f'{key}.running_mean'] = 0.05 * torch.randn(c, generator=gen)
        sd[f'{key}.running_var'] = 1 + 0.05 * torch.rand(c, generator=gen)
        sd[f'{key}.num_batches_tracked'] = torch.tensor(1000)

    conv('backbone.conv1.weight', 64, 3, 7)
    bn('backbone.bn1', 64)
    inplanes = 64
    for stage, blocks in enumerate({50: (3, 4, 6, 3),
                                    101: (3, 4, 23, 3)}[depth]):
        planes = 64 * 2 ** stage
        for i in range(blocks):
            src = f'backbone.layer{stage + 1}.{i}'
            conv(f'{src}.conv1.weight', planes, inplanes, 1)
            conv(f'{src}.conv2.weight', planes, planes, 3)
            if stage >= 2:
                sd[f'{src}.conv2.conv_offset.weight'] = 1e-3 * torch.randn(
                    27, planes, 3, 3, generator=gen)
                sd[f'{src}.conv2.conv_offset.bias'] = torch.zeros(27)
            conv(f'{src}.conv3.weight', 4 * planes, planes, 1)
            for j in (1, 2, 3):
                bn(f'{src}.bn{j}', 4 * planes if j == 3 else planes)
            if i == 0:
                conv(f'{src}.downsample.0.weight', 4 * planes, inplanes, 1)
                bn(f'{src}.downsample.1', 4 * planes)
            inplanes = 4 * planes
    decoys = {'neck.lateral_convs.0.conv.weight': (256, 512, 1, 1),
              'neck.fpn_convs.0.conv.weight': (256, 256, 3, 3),
              'bbox_head.cls_convs.0.conv.weight': (256, 256, 3, 3),
              'bbox_head.conv_cls.weight': (10, 256, 1, 1)}
    for key, shape in decoys.items():
        sd[key] = 0.01 * torch.randn(shape, generator=gen)
    torch.save({'meta': {'epoch': 12}, 'state_dict': sd}, path)
    return sorted(decoys)


def _finite_log(name, log):
    """Every number a CLI logged is finite; -> the losses."""
    if not log:
        raise RuntimeError(f'{name}: nothing logged')
    for m in log:
        bad = {k: v for k, v in m.items() if not math.isfinite(float(v))}
        if bad:
            raise RuntimeError(f'{name}: non-finite log values {bad}')
    return [m['loss'] for m in log]


def _finite_metrics(name, metrics, keys=()):
    flat = ({f'{a}.{b}': v for a, d in metrics.items() for b, v in d.items()}
            if isinstance(next(iter(metrics.values())), dict) else metrics)
    bad = {k: v for k, v in flat.items() if not math.isfinite(float(v))}
    missing = [k for k in keys if k not in flat]
    if bad or missing:
        raise RuntimeError(f'{name}: non-finite metrics {bad}, missing '
                           f'{missing}')


def _cli_keepers(run, train):
    """Keepers for a CLI run: every kernel of its f32 path keeps its first
    input of each case, named ``run:case``; an MSDA or DCN call of a shape
    the other phases do not name is kept under its shape."""
    from vidar_tpu_torch.ops import dcn, latent_render, msda

    def msda_case(a):
        b, levels = a['value'].shape[0], len(a['spatial_shapes'])
        return f'{run}:{_msda_case(a) or f"b{b},l{levels}"}'

    def dcn_case(a):
        b, c = a['x'].shape[0], a['x'].shape[-1]
        return f'{run}:{_dcn_image_case(a) or f"c{c},b{b}"}'

    keepers = {msda.KERNEL.name: _Keeper(msda_case),
               dcn.SAMPLE.name: _Keeper(dcn_case),
               latent_render.FIRST_HIT.name: _Keeper(
                   lambda a: f'{run}:encoder'),
               latent_render.AGGREGATE.name: _Keeper(
                   lambda a: f'{run}:encoder')}
    if train:
        keepers.update({
            msda.BACKWARD.name: _Keeper(msda_case),
            latent_render.FIRST_HIT_BACKWARD.name: _Keeper(
                lambda a: f'{run}:encoder'),
            latent_render.AGGREGATE_BACKWARD.name: _Keeper(
                lambda a: f'{run}:encoder')})
    return keepers


def _psnr(a, b):
    mse = float(((a.astype(np.float64) - b) ** 2).mean())
    return 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))


def _check_decoder(sources, jpegs):
    """The host library's JPEG decoder on this machine: equal bit for bit
    to its numpy version on a small image, and each fixture camera within
    JPEG_MIN_PSNR_DB of its source."""
    from vidar_tpu_torch import native
    from vidar_tpu_torch.data.jpeg import decode_jpeg
    if not native.available():
        raise RuntimeError(f'the host library did not build: '
                           f'{native.build_error}')
    small = _encode_jpeg(_camera_image(np.random.default_rng(1), 45, 77))
    lib, plain = native.jpeg_decode(small), decode_jpeg(small)
    if not np.array_equal(lib, plain):
        raise RuntimeError('JPEG: the host library and data/jpeg.py differ '
                           'on a 45x77 image')
    psnr = [_psnr(native.jpeg_decode(d), im) for im, d in zip(sources,
                                                             jpegs)]
    print(f'JPEG decoder: the host library equals data/jpeg.py bit for '
          f'bit on a 45x77 4:2:0 image; {len(jpegs)} fixture cameras '
          f'{sources[0].shape[1]}x{sources[0].shape[0]}, mean '
          f'{np.mean([len(d) for d in jpegs]):.0f} bytes, PSNR against '
          f'their sources {" ".join(f"{p:.2f}" for p in psnr)} dB '
          f'(>= {JPEG_MIN_PSNR_DB})', flush=True)
    if min(psnr) < JPEG_MIN_PSNR_DB:
        raise RuntimeError(f'JPEG: a fixture camera at {min(psnr):.2f} dB')


def _loader_timing(cfg_path, opts, label, threads=True):
    """A train sample of ``cfg_path``'s train split on one thread, then
    (``threads``) one under cProfile and 4 on the train CLI's 4 loader
    threads."""
    from vidar_tpu_torch.core.builder import build_dataset
    from vidar_tpu_torch.core.config import apply_overrides, load_config
    from vidar_tpu_torch.data.prefetch import PrefetchLoader
    ds = build_dataset(apply_overrides(load_config(str(cfg_path)),
                                       opts)['data']['train'])
    t0 = time.perf_counter()
    ds[0]
    print(f'loader, {label}: a train sample on one thread '
          f'{time.perf_counter() - t0:.3f} s', flush=True)
    if not threads:
        return
    # where a sample's host time goes (cProfile: each numpy or native call
    # is one entry), then the train CLI's loader: 4 threads
    prof = cProfile.Profile()
    prof.runcall(ds.__getitem__, 1)
    top = sorted(pstats.Stats(prof).stats.items(),
                 key=lambda kv: -kv[1][2])[:8]
    print(f'loader, {label}, one sample under cProfile, most own time: ' +
          '; '.join(f'{fn[2]} ({Path(fn[0]).name}:{fn[1]}) {st[2]:.3f} s'
                    for fn, st in top), flush=True)
    t0 = time.perf_counter()
    for _ in PrefetchLoader(ds.__getitem__, range(4), num_threads=4,
                            depth=4):
        pass
    print(f'loader, {label}: 4 train samples on 4 threads (the train '
          f'CLI\'s PrefetchLoader): {(time.perf_counter() - t0) / 4:.3f} '
          f's/sample', flush=True)


def _train_log(name, out, steps):
    """The losses, s/it and data_wait_s of a train run logged at every
    step."""
    losses = _finite_log(name, out['log'])
    if out['step'] != steps:
        raise RuntimeError(f'cli {name}: {out["step"]} steps, not {steps}')
    print(f'cli {name}: losses {losses}; s/it '
          f'{[round(1 / m["it/s"], 3) for m in out["log"]]}; data_wait_s '
          f'{[round(m["data_wait_s"], 4) for m in out["log"]]}', flush=True)


def _phase9(counted, card, check, tmp):
    """The port's train and test CLIs in this process, on the card, on
    nuScenes-format fixtures with JPEG cameras written under ``tmp``: the
    pre-training config for 1 step (its eval hook once), the forecast eval
    of its checkpoint, the fine-tune config for 1 step from that
    checkpoint, the detection eval of the fine-tuned one (full window, then
    streaming), the mem-efficient pre-training config for 1 step, the
    OpenScene pre-training config for 1 step on an 8-camera fixture, and
    the BEVFormer baseline for 1 step from a synthetic FCOS3D ``.pth``. The
    pre-training, forecast-eval and OpenScene runs keep each kernel's
    first f32 input of each case, and ``check(run, keepers, launches)``
    holds the kernels against their plain versions on them.
    -> ({run: {kernel: launches}}, the ``--cfg-options`` of the nuScenes
    and of the OpenScene fixture's data paths)."""
    from vidar_tpu_torch.ops import dcn, latent_render, msda
    from vidar_tpu_torch.tools import test as test_cli
    from vidar_tpu_torch.tools import train as train_cli

    # PyTorch's own defaults, as a user's run of the CLIs gets them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    print('phase 9: the CLIs with PyTorch\'s default numerics switches '
          '(matmul.allow_tf32=False cudnn.allow_tf32=True)', flush=True)
    forward = [msda.KERNEL, latent_render.FIRST_HIT, latent_render.AGGREGATE,
               dcn.SAMPLE]
    backward = [msda.BACKWARD, latent_render.FIRST_HIT_BACKWARD,
                latent_render.AGGREGATE_BACKWARD]
    runs = {}
    t0 = time.perf_counter()
    pkl, png_pkl, sources, jpegs = _write_nuscenes_fixture(tmp,
                                                           png=True)
    print(f'fixture: 14 samples x 6 cameras 900x1600 as JPEG (4:2:0, '
          f'quality {JPEG_QUALITY}, 4 distinct images) and as PNG, '
          f'34720 points and 40 GT boxes a sample, written in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    _check_decoder(sources, jpegs)
    del sources, jpegs
    data = [f'data.{s}.{k}={v}' for s in ('train', 'test')
            for k, v in (('ann_file', pkl), ('data_root', tmp))]
    pre_opts = data + ['data.train.load_frame_interval=1',
                       'log_interval=1', 'evaluation.interval=1',
                       'evaluation.max_samples=1']
    ft_opts = data + ['log_interval=1']

    # the loader's host time on JPEG, and one PNG sample as before
    _loader_timing(PRETRAIN_CONFIG, pre_opts,
                   'pre-training, JPEG fixture')
    _loader_timing(PRETRAIN_CONFIG,
                   [o.replace(pkl, png_pkl) for o in pre_opts],
                   'pre-training, PNG fixture', threads=False)

    def run(name, fn, argv, keepers=None):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, launches = _run_counted(counted, keepers or {},
                                     lambda: fn(argv))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        runs[name] = launches
        kept = sum(_nbytes(v) for kp in (keepers or {}).values()
                   for a in kp.inputs.values() for v in a.values()
                   if torch.is_tensor(v))
        print(f'cli {name}: {wall:.2f} s wall, peak device memory '
              f'{peak / 2**30:.2f} GiB (the kernels\' kept inputs '
              f'{kept / 2**30:.2f} GiB of it at most), launches '
              f'{json.dumps(launches)} on {card}', flush=True)
        if launches[dcn.KERNEL.name] or launches[dcn.SAMPLE16.name]:
            raise RuntimeError(f'cli {name}: the f32 config ran a bf16 '
                               f'kernel (K2 or K10)')
        return out

    def need(name, kernels):
        never = [k.name for k in kernels if runs[name][k.name] <= 0]
        if never:
            raise RuntimeError(f'cli {name}: kernels {never} never '
                               f'launched')

    pre_dir, ft_dir = f'{tmp}/pretrain', f'{tmp}/finetune'
    keepers = _cli_keepers('cli_pretrain', train=True)
    out = run('pretrain', train_cli.main,
              [str(PRETRAIN_CONFIG), '--work-dir', pre_dir,
               '--max-steps', '1', '--cfg-options', *pre_opts], keepers)
    _train_log('pretrain', out, 1)
    if len(out['eval']) != 1:
        raise RuntimeError('cli pretrain: not one eval')
    _finite_metrics('pretrain eval', out['eval'][0][1], ('key_score',))
    need('pretrain', forward + backward)
    check('cli_pretrain', keepers, runs['pretrain'])

    keepers = _cli_keepers('cli_forecast_eval', train=False)
    metrics = run('forecast_eval', test_cli.main,
                  [str(PRETRAIN_CONFIG), f'{pre_dir}/latest',
                   '--max-samples', '2', '--out', f'{tmp}/forecast.json',
                   '--cfg-options', *data], keepers)
    if sorted(metrics) != [f'frame.{f}' for f in range(7)]:
        raise RuntimeError(f'cli forecast_eval: frames {sorted(metrics)}')
    _finite_metrics('forecast_eval', metrics,
                    ('frame.6.chamfer_distance',))
    need('forecast_eval', forward)
    check('cli_forecast_eval', keepers, runs['forecast_eval'])
    del keepers

    out = run('finetune', train_cli.main,
              [str(FINETUNE_CONFIG), '--work-dir', ft_dir,
               '--load-from', f'{pre_dir}/latest', '--max-steps', '1',
               '--cfg-options', *ft_opts])
    _train_log('finetune', out, 1)
    print(f'cli finetune: n_loaded {out["loaded"]}', flush=True)
    if out['loaded'] <= 0:
        raise RuntimeError('cli finetune: nothing loaded from the '
                           'pre-training checkpoint')
    need('finetune', forward + backward)

    for name, extra in (('det_eval', []), ('det_stream', ['--streaming'])):
        metrics = run(name, test_cli.main,
                      [str(FINETUNE_CONFIG), f'{ft_dir}/latest',
                       '--max-samples', '2', *extra,
                       '--cfg-options', *data])
        _finite_metrics(name, metrics, ('NDS', 'mAP'))
        need(name, forward)
    for d in (pre_dir, ft_dir):
        if not os.path.isfile(f'{d}/latest/model.pt'):
            raise RuntimeError(f'no checkpoint in {d}/latest')
        shutil.rmtree(d)

    # the mem-efficient pre-training config (one supervised future, no
    # auxiliary frames; its train split's random_aug_conf)
    out = run('mem_efficient', train_cli.main,
              [str(MEM_EFFICIENT_CONFIG), '--work-dir', f'{tmp}/mem',
               '--max-steps', '1', '--cfg-options', *data,
               'data.train.load_frame_interval=1', 'log_interval=1'])
    _train_log('mem_efficient', out, 1)
    need('mem_efficient', forward + backward)
    shutil.rmtree(f'{tmp}/mem')

    # the BEVFormer baseline from a synthetic FCOS3D backbone .pth
    pth = f'{tmp}/r101_dcn_fcos3d_pretrain.pth'
    decoys = _write_fcos3d_pth(pth)
    out = run('bevformer_pth', train_cli.main,
              [str(BASELINE_CONFIG), '--work-dir', f'{tmp}/baseline',
               '--load-from', pth, '--max-steps', '1',
               '--cfg-options', *ft_opts])
    _train_log('bevformer_pth', out, 1)
    imp = out['torch_import']
    backbone = [k for k in torch.load(
        f'{tmp}/baseline/latest/model.pt', map_location='cpu')
        if k.startswith('img_backbone.')]
    print(f'cli bevformer_pth: {imp.summary()}; the model has '
          f'{len(backbone)} backbone tensors; unmapped {imp.unmapped}',
          flush=True)
    if (sorted(imp.matched) != sorted(backbone) or imp.shape_mismatch
            or imp.unmapped != decoys):
        raise RuntimeError('cli bevformer_pth: the .pth import did not '
                           'set every backbone tensor, or left other '
                           'than the decoys unmapped')
    need('bevformer_pth', [msda.KERNEL, dcn.SAMPLE, msda.BACKWARD])
    shutil.rmtree(f'{tmp}/baseline')
    os.remove(pth)

    # the OpenScene pre-training config: 8 cameras at 1080x1920 (scaled
    # by 2/3), PCD lidar
    t0 = time.perf_counter()
    osc = f'{tmp}/openscene'
    os_pkl, _, sources, jpegs = _write_nuscenes_fixture(
        osc, num_cams=8, img_hw=(1080, 1920), lidar='pcd', seed=1)
    print(f'fixture: OpenScene, 14 samples x 8 cameras 1080x1920 JPEG, '
          f'PCD lidar, written in {time.perf_counter() - t0:.1f} s',
          flush=True)
    _check_decoder(sources, jpegs)
    del sources, jpegs
    os_data = [f'data.{s}.{k}={v}' for s in ('train', 'test')
               for k, v in (('ann_file', os_pkl), ('data_root', osc))]
    os_opts = os_data + ['data.train.load_frame_interval=1',
                         'log_interval=1']
    _loader_timing(OPENSCENE_CONFIG, os_opts, 'OpenScene, JPEG fixture',
                   threads=False)
    keepers = _cli_keepers('cli_openscene', train=True)
    out = run('openscene', train_cli.main,
              [str(OPENSCENE_CONFIG), '--work-dir', f'{tmp}/os_work',
               '--max-steps', '1', '--cfg-options', *os_opts], keepers)
    _train_log('openscene', out, 1)
    need('openscene', forward + backward)
    check('cli_openscene', keepers, runs['openscene'])
    return runs, data, os_data


# ------------------------------------------------------- phase 11: UniAD

UNIAD_E2E_CONFIG = (ROOT / 'configs' / 'uniad' / 'stage2_e2e' /
                    'vidar_e2e.py')
UNIAD_TRACK_MAP_CONFIG = (ROOT / 'configs' / 'uniad' / 'stage1_track_map' /
                          'base_track_map.py')
UNIAD_KEYS = ('amota', 'amotp', 'NDS', 'minADE', 'planning.L2',
              'planning.obj_box_col')
# the 2-frame clip step's peak on the H100 with nothing recomputed (neither
# the backbone nor the encoder checkpointed; PERF.md), printed beside the
# 2-frame step's peak
UNIAD_2FRAME_NO_RECOMPUTE_GIB = 73.2
# the library path's synthetic cameras: nuScenes' 6 at the padded size
UNIAD_CAMS, UNIAD_IMAGE = 6, (928, 1600)
# the clip of the train CLI on UniAD's other stage configs (11b's
# base_track_map.py, 14e): phase 11a's short step; 11a-b run the same
# modules at vidar_e2e.py's 6 frames
UNIAD_SHORT_CLIP = 2


def _uniad_msda_case(cfg, run='uniad'):
    """K1's and K5's UniAD calls by (batch, levels, queries): TSA, SCA, the
    track decoder, the panoptic encoder (every BEV cell a query) and
    decoder, and the motion head's steps folded into its queries."""
    hw = cfg['bev_h'] * cfg['bev_w']
    motion = ((cfg['num_query'] + 1) * cfg.get('predict_modes', 6) *
              cfg.get('predict_steps', 12))
    by_queries = {cfg['num_query']: 'track_decoder', hw: 'seg_encoder',
                  cfg.get('num_seg_query', 300): 'seg_decoder',
                  motion: 'motion'}

    def case(a):
        b, levels = a['value'].shape[0], len(a['spatial_shapes'])
        q = a['loc'].shape[1]
        if levels == 4:
            name = 'sca'
        elif b == 2:
            name = 'tsa'
        else:
            name = by_queries.get(q, f'b{b},l{levels},q{q}')
        return f'{run}:{name}'
    return case


def _uniad_keepers(cfg, run, train):
    """The UniAD path's keepers: each kernel's first input of each case,
    named ``run:case`` as ``check`` (phase 9's) reads them."""
    from vidar_tpu_torch.ops import dcn, latent_render, msda
    msda_case = _uniad_msda_case(cfg, run)
    keepers = {msda.KERNEL.name: _Keeper(msda_case),
               dcn.SAMPLE.name: _Keeper(
                   lambda a: f'{run}:{_dcn_image_case(a) or _dcn_case(a)}'),
               latent_render.FIRST_HIT.name: _Keeper(
                   lambda a: f'{run}:encoder'),
               latent_render.AGGREGATE.name: _Keeper(
                   lambda a: f'{run}:encoder')}
    if train:
        keepers.update({
            msda.BACKWARD.name: _Keeper(msda_case),
            latent_render.FIRST_HIT_BACKWARD.name: _Keeper(
                lambda a: f'{run}:encoder'),
            latent_render.AGGREGATE_BACKWARD.name: _Keeper(
                lambda a: f'{run}:encoder')})
    return keepers


def _uniad_clip_launches(eval_by_case, eval_frames, frames, cams):
    """The launches by case that a clip train step of ``frames`` frames
    must make, from an eval run's (``eval_by_case``: {kernel:
    {case: launches}} of ``eval_frames`` streamed frames, one batched
    backbone pass of ``cams`` images a frame): per frame, the backbone
    camera by camera, each camera recomputed in the backward (K9 at
    ``stage*,b1``: 2 x cams x the eval's per frame); every frame's BEV
    encoder (K1's TSA and SCA, K3/K4) recomputed; the track decoder once a
    frame; the heads once; a backward kernel (K5, K6/K7, K8) once for each
    forward call -> {kernel: {case suffix: launches}}."""
    from vidar_tpu_torch.ops import dcn, latent_render, msda

    def per_frame(kernel):
        out = {}
        for case, n in eval_by_case.get(kernel.name, {}).items():
            if n % eval_frames:
                raise RuntimeError(f'{kernel.name} {case}: {n} launches in '
                                   f'{eval_frames} eval frames')
            out[case.split(':', 1)[1]] = n // eval_frames
        return out

    recomputed = 2 * frames
    msda_cases = per_frame(msda.KERNEL)
    k1 = {case: n * {'tsa': recomputed, 'sca': recomputed,
                     'track_decoder': frames}.get(case, 1)
          for case, n in msda_cases.items()}
    k5 = {case: n * (frames if case in ('tsa', 'sca', 'track_decoder')
                     else 1) for case, n in msda_cases.items()}
    k9 = {case.replace(f',b{cams}', ',b1'): 2 * cams * frames * n
          for case, n in per_frame(dcn.SAMPLE).items()}
    render = {case: n * recomputed
              for case, n in per_frame(latent_render.FIRST_HIT).items()}
    render_bwd = {case: n * frames
                  for case, n in per_frame(latent_render.FIRST_HIT).items()}
    want = {msda.KERNEL.name: k1, msda.BACKWARD.name: k5,
            dcn.SAMPLE.name: k9, latent_render.FIRST_HIT.name: render,
            latent_render.AGGREGATE.name: render,
            latent_render.FIRST_HIT_BACKWARD.name: render_bwd,
            latent_render.AGGREGATE_BACKWARD.name: render_bwd}
    return want


def _hold_clip_launches(label, keepers, want):
    """Each kernel's launches by case (``keepers``' counts, their run's
    prefix dropped) against ``want`` (``_uniad_clip_launches``); raises
    where they differ."""
    got = {k: {c.split(':', 1)[1]: n for c, n in keepers[k].counts.items()}
           for k in want}
    if got != want:
        raise RuntimeError(f'{label}: launches by case {json.dumps(got)}, '
                           f'the code gives {json.dumps(want)}')
    print(f'{label}: launches by case as the code gives them '
          f'{json.dumps(want)}', flush=True)


def _uniad_targets(rng, frames, dev, model, num_gt=40, max_gt=128,
                   max_map=32, map_gt=8):
    """A clip's UniAD targets at ``model``'s widths:
    num_gt agents with instance ids that persist over the clip's frames,
    moving 1 m a frame, their futures and occupancy, map elements and the
    ego's plan."""
    from vidar_tpu_torch.core.bbox import normalize_bbox
    from vidar_tpu_torch.uniad.loss import UniADTargets
    predict_steps = model.predict_steps
    occ_frames = model.occ_head.n_future_blocks - 1
    plan_steps = model.planning_head.planning_steps
    hh, ww = model.bev_h, model.bev_w
    boxes = np.zeros((1, max_gt, 9), np.float32)
    boxes[0, :num_gt, :2] = rng.uniform(-45, 45, (num_gt, 2))
    boxes[0, :, 3:6] = rng.uniform(0.5, 4.0, (max_gt, 3))
    boxes[0, :num_gt, 6] = rng.uniform(-np.pi, np.pi, num_gt)
    boxes[0, :num_gt, 7:9] = rng.uniform(-5, 5, (num_gt, 2))
    labels = np.zeros((1, max_gt), np.int32)
    labels[0, :num_gt] = np.arange(num_gt) % 10
    tb = np.zeros((1, frames, max_gt, 10), np.float32)
    for t in range(frames):
        b9 = boxes[0].copy()
        b9[:, 0] += t - frames + 1
        tb[0, t] = normalize_bbox(torch.from_numpy(b9)).numpy()
    ids = np.full((1, frames, max_gt), -1, np.int32)
    ids[0, :, :num_gt] = np.arange(num_gt)
    occ = np.zeros((1, max_gt, occ_frames, hh, ww), np.float32)
    occ[0, :num_gt, :, hh // 2 - hh // 20:hh // 2 + hh // 20 + 1,
        ww // 2 - ww // 20:ww // 2 + ww // 20 + 1] = 1.0
    map_masks = np.zeros((1, max_map, hh, ww), np.float32)
    map_masks[0, :map_gt, ::7] = 1.0
    ego = np.zeros((frames, 3, 3), np.float32)
    ego[:] = np.eye(3)
    arrays = dict(
        gt_boxes=boxes, gt_labels=labels,
        num_valid_gt=np.array([num_gt], np.int32),
        map_boxes=rng.uniform(0.2, 0.8, (1, max_map, 4)).astype(np.float32),
        map_labels=(np.arange(max_map, dtype=np.int32) % 3)[None],
        num_valid_map=np.array([map_gt], np.int32),
        gt_traj=np.cumsum(rng.normal(0, 1, (1, max_gt, predict_steps, 2)),
                          2).astype(np.float32),
        gt_traj_valid=np.ones((1, max_gt, predict_steps), np.float32),
        sdc_traj=np.stack([np.zeros(plan_steps), 2.0 * np.arange(
            1, plan_steps + 1), np.zeros(plan_steps)], -1)[None].astype(
                np.float32),
        sdc_mask=np.ones((1, plan_steps), np.float32),
        gt_occ=occ, map_masks=map_masks, track_boxes=tb,
        track_labels=np.repeat(labels[:, None], frames, 1), track_ids=ids,
        track_num=np.full((1, frames), num_gt, np.int32),
        l2g_r=ego[None], l2g_t=np.zeros((1, frames, 3), np.float32),
        timestamp=(0.5 * np.arange(frames, dtype=np.float32))[None])
    return UniADTargets(**{k: torch.from_numpy(v).to(dev)
                           for k, v in arrays.items()})


def _straight(fn, *args, use_reentrant=None, **kwargs):
    """``torch.utils.checkpoint.checkpoint`` without the recomputation."""
    return fn(*args, **kwargs)


def _recompute_layout(name, frames):
    """Replace the ``checkpoint`` names of ``models/vidar.py`` (the
    backbone, camera by camera) and ``uniad/uniad.py`` (a frame's BEV
    encoder, called once a frame) so that a step of ``frames`` frames
    recomputes what ``name`` says: ``none`` (the cameras still one at a
    time), ``backbone``, ``keep_last`` (and every frame's encoder but the
    last) or ``shipped`` (every frame's). -> a function that puts the
    names back."""
    from torch.utils.checkpoint import checkpoint
    from vidar_tpu_torch.models import vidar
    from vidar_tpu_torch.uniad import uniad
    calls = []

    def all_but_last(fn, *args, **kwargs):
        calls.append(fn)
        last = len(calls) % frames == 0
        return (_straight if last else checkpoint)(fn, *args, **kwargs)

    vidar.checkpoint = _straight if name == 'none' else checkpoint
    uniad.checkpoint = {'none': _straight, 'backbone': _straight,
                        'keep_last': all_but_last}.get(name, checkpoint)

    def restore():
        vidar.checkpoint = uniad.checkpoint = checkpoint
    return restore


def clip_memory(frame_counts) -> int:
    """UniAD's clip train step (``vidar_e2e.py`` in f32, ``init_weights_``
    from seed 0, TF32 off, as phase 11a builds it; ``make_synthetic_batch``
    with 6 cameras at 928x1600 and ``_uniad_targets``' 40 agents) at each
    of ``frame_counts`` frames under each ``_recompute_layout``: two steps,
    the peak reset before each; prints both peaks, the second step's
    seconds, the forward's peak and what the forward leaves allocated for
    the backward, or "out of memory"; the card first and a JSON line of
    every number last."""
    from vidar_tpu_torch.core.builder import build_model
    from vidar_tpu_torch.core.config import load_config
    from vidar_tpu_torch.data import make_synthetic_batch
    from vidar_tpu_torch.train import UniADTrainStep, make_optimizer

    card = _nvidia_smi()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda:0')
    mcfg = load_config(str(UNIAD_E2E_CONFIG))['model']
    model = build_model(mcfg, device=dev)
    model.init_weights_(torch.Generator(device=dev).manual_seed(0))
    model.train()
    step = UniADTrainStep(model, make_optimizer(model, device=dev),
                          task_loss_weight=mcfg['task_loss_weight'],
                          device=dev)
    command = torch.tensor([2], dtype=torch.int32, device=dev)
    forward = {}
    backward = step.backward

    def split_backward(total):
        forward['peak'] = torch.cuda.max_memory_allocated() / 2**30
        forward['left'] = torch.cuda.memory_allocated() / 2**30
        backward(total)

    step.backward = split_backward
    ih, iw = UNIAD_IMAGE
    rows = []
    for frames in frame_counts:
        clip = make_synthetic_batch(np.random.default_rng(1), bs=1,
                                    queue_length=frames - 1,
                                    future_length=1, num_cams=UNIAD_CAMS,
                                    img_h=ih, img_w=iw, max_points=64,
                                    device=dev)
        targets = _uniad_targets(np.random.default_rng(2), frames, dev,
                                 model)
        for name in ('none', 'backbone', 'keep_last', 'shipped'):
            row = dict(layout=name, frames=frames)
            restore = _recompute_layout(name, frames)
            try:
                for k in (1, 2):
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    step((clip, targets, command))
                    torch.cuda.synchronize()
                    row[f'step{k}_s'] = time.perf_counter() - t0
                    row[f'step{k}_peak_gib'] = (
                        torch.cuda.max_memory_allocated() / 2**30)
                row.update(forward_peak_gib=forward['peak'],
                           forward_left_gib=forward['left'])
            except torch.cuda.OutOfMemoryError:
                row['out_of_memory'] = True
                model.zero_grad(set_to_none=True)
            finally:
                restore()
            torch.cuda.empty_cache()
            rows.append(row)
            print(f'uniad clip step, {frames} frames, recomputed: {name}: ' + (
                'out of memory' if row.get('out_of_memory') else
                f'peak {row["step1_peak_gib"]:.2f} / '
                f'{row["step2_peak_gib"]:.2f} GiB (step 1 / 2), step 2 '
                f'{row["step2_s"]:.3f} s, its forward peak '
                f'{row["forward_peak_gib"]:.2f} GiB, left for the backward '
                f'{row["forward_left_gib"]:.2f} GiB') + f' on {card}',
                flush=True)
        del clip, targets
    print(json.dumps(dict(card=card, clip_memory=rows)))
    return 0


def _uniad_fixture(pkl, root):
    """Phase 9's fixture as UniAD reads it: its first sample's GT boxes
    persist through the scene as the same instances (``gt_instance_tokens``),
    each moving by its velocity. -> the pkl's path."""
    with open(pkl, 'rb') as f:
        data = pickle.load(f)
    base = data['infos'][0]
    for i, info in enumerate(data['infos']):
        boxes = base['gt_boxes'].copy()
        boxes[:, :2] += 0.5 * i * base['gt_velocity']
        info.update(gt_boxes=boxes, gt_names=base['gt_names'],
                    gt_velocity=base['gt_velocity'],
                    gt_attrs=base['gt_attrs'],
                    num_lidar_pts=base['num_lidar_pts'],
                    valid_flag=base['valid_flag'],
                    gt_instance_tokens=np.array(
                        [f'inst{k}' for k in range(len(boxes))]))
    out = os.path.join(root, 'infos_uniad.pkl')
    with open(out, 'wb') as f:
        pickle.dump(data, f)
    return out


def _phase11(counted, card, check, tmp, fixture_pkl, dev='cuda:0'):
    """UniAD at the released widths (``vidar_e2e.py``: embed 256, BEV
    200x200, 900 track queries, 300 map queries, 6 cameras, R101 with DCN
    in stages 3-4, latent rendering at layer 2, 12 steps x 6 modes), f32,
    ``init_weights_`` from seed 0. a: the library: 3 streamed eval frames
    on a synthetic batch of 6 x 928x1600, a fourth timed stage by stage,
    then the clip train step at 2 frames (the warm-up) and at the
    config's 6 (timed), each with its launches by case held to the counts
    the code gives (``_uniad_clip_launches``); b: the train
    CLI on ``vidar_e2e.py`` (1 step of the config's clip, its launches
    held likewise) and its UniAD eval (4 samples of one scene),
    ``base_track_map.py`` (1 step of a 2-frame clip), on phase 9's JPEG
    fixture made UniAD's (``_uniad_fixture``). ``check`` holds every
    kernel of the library path and of the e2e train and eval runs against
    its plain version on their kept inputs. -> {path: {kernel:
    launches}}."""
    from vidar_tpu_torch.core.builder import build_model
    from vidar_tpu_torch.core.config import apply_overrides, load_config
    from vidar_tpu_torch.data import make_synthetic_batch
    from vidar_tpu_torch.ops import dcn, latent_render, msda
    from vidar_tpu_torch.tools import test as test_cli
    from vidar_tpu_torch.tools import train as train_cli
    from vidar_tpu_torch.train import UniADTrainStep, make_optimizer
    from vidar_tpu_torch.uniad import planning_head

    dev = torch.device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    forward = [msda.KERNEL, dcn.SAMPLE, latent_render.FIRST_HIT,
               latent_render.AGGREGATE]
    backward = [msda.BACKWARD, latent_render.FIRST_HIT_BACKWARD,
                latent_render.AGGREGATE_BACKWARD]
    runs = {}

    def need(name, kernels, launches):
        runs[name] = launches
        never = [k.name for k in kernels if launches[k.name] <= 0]
        if never:
            raise RuntimeError(f'phase 11 {name}: kernels {never} never '
                               f'launched')
        if launches[dcn.KERNEL.name] or launches[dcn.SAMPLE16.name]:
            raise RuntimeError(f'phase 11 {name}: the f32 UniAD ran a bf16 '
                               f'kernel (K2 or K10)')

    cfg = load_config(str(UNIAD_E2E_CONFIG))
    mcfg = cfg['model']
    frames_cfg = cfg['data']['train']['queue_length'] + 1
    model = build_model(mcfg, device=dev)
    model.init_weights_(torch.Generator(device=dev).manual_seed(0))
    model.eval()
    print(f'phase 11: UniAD ({UNIAD_E2E_CONFIG.relative_to(ROOT)}), f32, '
          f'{sum(p.numel() for p in model.parameters())} parameters',
          flush=True)

    # -- 11a: 3 streamed eval frames on a synthetic batch
    ih, iw = UNIAD_IMAGE
    batch = make_synthetic_batch(np.random.default_rng(0), bs=1,
                                 queue_length=0, future_length=1,
                                 num_cams=UNIAD_CAMS, img_h=ih, img_w=iw,
                                 max_points=64, device=dev)
    command = torch.tensor([2], dtype=torch.int32, device=dev)
    keepers = _uniad_keepers(mcfg, 'uniad_eval', train=False)

    def stream():
        outs, times = [], []
        tracks, prev_bev = model.init_stream(1, dev)
        with torch.inference_mode():
            for k in range(3):
                t0 = time.perf_counter()
                b = dataclasses.replace(
                    batch, can_bus=batch.can_bus + 2.0 * k,
                    rotate_angle=batch.rotate_angle + 1.0 * k)
                out = model(b, tracks, prev_bev,
                            torch.full((1,), k > 0, device=dev), command)
                tracks, prev_bev = out['tracks'], out['bev']
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                outs.append(out)
        return outs, times

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (outs, times), launches = _run_counted(counted, keepers, stream)
    peak = torch.cuda.max_memory_allocated()
    need('uniad_eval', forward, launches)
    eval_by_case = {k: dict(kp.counts) for k, kp in keepers.items()}
    out = outs[-1]
    for name, t in (('det', out['det']['all_bbox_preds']),
                    ('motion', out['motion']['all_traj_preds']),
                    ('occ', out['occ']['ins_occ_logits']),
                    ('plan', out['plan']['sdc_traj']),
                    ('seg', out['seg']['outputs_coords'])):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f'phase 11a: non-finite {name} outputs')
    want = (3, 1, model.num_query + 1, model.motion_head.num_anchor,
            model.predict_steps, 5)
    if tuple(out['motion']['all_traj_preds'].shape) != want:
        raise RuntimeError('phase 11a: motion outputs of shape '
                           f'{tuple(out["motion"]["all_traj_preds"].shape)}')
    print(f'uniad eval (3 streamed frames, {UNIAD_CAMS} x {ih}x{iw}): '
          f'{" ".join(f"{t:.4f}" for t in times)} s/frame (the first with '
          f'warm-up); peak memory {peak / 2**30:.2f} GiB; tracks alive '
          f'{int((out["tracks"].obj_idxes >= 0).sum())}; launches '
          f'{json.dumps(launches)} on {card}', flush=True)
    tracks, prev_bev = out['tracks'], out['bev']
    del outs, out
    check('uniad_eval', keepers, launches)

    # -- 11a: where a frame's time goes: a fourth frame, stage by stage
    torch.backends.cudnn.allow_tf32 = False      # check turned it back on
    trk = model.track
    stages = [(trk, 'backbone_forward', 'backbone+FPN'),
              (trk.pts_bbox_head_bev, 'forward', 'BEV encoder'),
              (trk.det_head, 'forward', 'track decoder'),
              (trk.tracker, 'update', 'tracker'),
              (model.seg_head, 'forward', 'panoptic head'),
              (model.motion_head, 'forward', 'motion head'),
              (model.occ_head, 'forward', 'occupancy head'),
              (model.planning_head, 'forward', 'planning head'),
              (trk, 'refresh_tracks', 'memory bank+QIM')]
    top = len(stages)
    occ, plan = model.occ_head, model.planning_head
    # inside the two heads at the full map (occupancy, planning)
    stages += [(occ.dense_decoder, 'forward', 'occupancy: dense decoder')]
    stages += [(getattr(occ, n), 'forward', 'occupancy: transformer layers')
               for n, _ in occ.named_children()
               if n.startswith('trans_layers_')]
    stages += [(plan.attn_module, 'forward', 'planning: attention'),
               (planning_head, 'collision_optimize',
                'planning: collision optimisation')]
    stages += [(getattr(plan, f'bev_adapter_{i}'), 'forward',
                'planning: BEV adapter') for i in range(3)]
    with torch.inference_mode():
        b = dataclasses.replace(batch, can_bus=batch.can_bus + 6.0,
                                rotate_angle=batch.rotate_angle + 3.0)
        by_stage, frame_ms = _stage_times(stages, lambda: model(
            b, tracks, prev_bev, torch.ones(1, dtype=torch.bool, device=dev),
            command))
    del tracks, prev_bev
    by_stage['rest'] = frame_ms - sum(by_stage[name]
                                      for _, _, name in stages[:top])
    print('uniad eval frame by stage (a fourth streamed frame, CUDA events, '
          f'ms): {json.dumps({k: round(v, 3) for k, v in by_stage.items()})}'
          f'; whole frame {frame_ms:.3f} ms on {card}', flush=True)

    # -- 11a: the clip train step at the config's frames, and at 2
    torch.backends.cudnn.allow_tf32 = False      # check turned it back on
    model.train()
    step = UniADTrainStep(model, make_optimizer(model, device=dev),
                          task_loss_weight=mcfg['task_loss_weight'],
                          device=dev)

    def counted_step(n_frames):
        """A clip step of n_frames, counted, its launches by case held ->
        (clip, targets, metrics, launches, keepers, s, peak bytes)."""
        clip = make_synthetic_batch(np.random.default_rng(1), bs=1,
                                    queue_length=n_frames - 1,
                                    future_length=1, num_cams=UNIAD_CAMS,
                                    img_h=ih, img_w=iw, max_points=64,
                                    device=dev)
        targets = _uniad_targets(np.random.default_rng(2), n_frames, dev,
                                 model)
        keepers = _uniad_keepers(mcfg, 'uniad_train', train=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics, launches = _run_counted(
            counted, keepers, lambda: step((clip, targets, command)))
        took = time.perf_counter() - t0
        need('uniad_train', forward + backward, launches)
        if not all(np.isfinite(v) for v in metrics.values()):
            raise RuntimeError(f'phase 11a: non-finite step metrics '
                               f'{metrics}')
        _hold_clip_launches(
            f'uniad clip step ({n_frames} frames)', keepers,
            _uniad_clip_launches(eval_by_case, 3, n_frames, UNIAD_CAMS))
        return (clip, targets, metrics, launches, keepers, took,
                torch.cuda.max_memory_allocated())

    # the warm-up at 2 frames, then the config's clip, timed
    two = counted_step(2)
    print(f'uniad clip step 1 (warm-up) at 2 frames: {two[-2]:.3f} s, peak '
          f'memory {two[-1] / 2**30:.2f} GiB (nothing recomputed: '
          f'{UNIAD_2FRAME_NO_RECOMPUTE_GIB} GiB) on {card}', flush=True)
    del two
    clip, targets, metrics, launches, keepers, step_s, peak = counted_step(
        frames_cfg)
    kept = sum(_nbytes(v) for kp in keepers.values()
               for a in kp.inputs.values() for v in a.values()
               if torch.is_tensor(v))
    print(f'uniad clip step 2: {frames_cfg} frames (the config\'s '
          f'queue_length + 1) x {UNIAD_CAMS} x {ih}x{iw}, 40 agents: '
          f'{step_s:.4f} s/it, peak memory {peak / 2**30:.2f} GiB (the '
          f'kernels\' kept inputs {kept / 2**30:.2f} GiB of it at most); '
          f'metrics {json.dumps(metrics)}; launches {json.dumps(launches)} '
          f'on {card}', flush=True)
    runs['uniad_train'] = launches        # the config's clip's
    check('uniad_train', keepers, launches)
    del keepers, model, step, clip, targets, batch
    torch.cuda.empty_cache()

    # -- 11b: the CLIs, as phase 9 runs them (PyTorch's default switches)
    torch.backends.cudnn.allow_tf32 = True
    pkl = _uniad_fixture(fixture_pkl, tmp)
    data = [f'data.{s}.{k}={v}' for s in ('train', 'test')
            for k, v in (('ann_file', pkl), ('data_root', tmp))]

    def run(name, fn, argv, kernels, keepers=None):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, launches = _run_counted(counted, keepers or {},
                                     lambda: fn(argv))
        print(f'cli {name}: {time.perf_counter() - t0:.2f} s wall, peak '
              f'device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}'
              f' GiB, launches {json.dumps(launches)} on {card}',
              flush=True)
        need(f'cli_{name}', kernels, launches)
        return out

    work = f'{tmp}/uniad_e2e'
    keepers = _uniad_keepers(mcfg, 'cli_uniad_e2e', train=True)
    out = run('uniad_e2e', train_cli.main,
              [str(UNIAD_E2E_CONFIG), '--work-dir', work, '--max-steps',
               '1', '--cfg-options', *data, 'log_interval=1'],
              forward + backward, keepers)
    _train_log('uniad_e2e', out, 1)
    _hold_clip_launches(
        f'cli uniad_e2e (1 step of {frames_cfg} frames)', keepers,
        _uniad_clip_launches(eval_by_case, 3, frames_cfg, UNIAD_CAMS))
    check('cli_uniad_e2e', keepers, runs['cli_uniad_e2e'])
    keepers = _uniad_keepers(mcfg, 'cli_uniad_eval', train=False)
    metrics = run('uniad_eval', test_cli.main,
                  [str(UNIAD_E2E_CONFIG), f'{work}/latest', '--max-samples',
                   '4', '--out', f'{tmp}/uniad.json', '--cfg-options',
                   *data], forward, keepers)
    _finite_metrics('uniad_eval', metrics, UNIAD_KEYS)
    print('cli uniad_eval: ' + ', '.join(f'{k} {float(metrics[k]):.4f}'
                                         for k in UNIAD_KEYS), flush=True)
    check('cli_uniad_eval', keepers, runs['cli_uniad_eval'])
    shutil.rmtree(work)
    out = run('uniad_track_map', train_cli.main,
              [str(UNIAD_TRACK_MAP_CONFIG), '--work-dir',
               f'{tmp}/uniad_track_map', '--max-steps', '1',
               '--cfg-options', *data, 'log_interval=1',
               f'data.train.queue_length={UNIAD_SHORT_CLIP - 1}'],
              [msda.KERNEL, dcn.SAMPLE, msda.BACKWARD])
    _train_log('uniad_track_map', out, 1)
    if runs['cli_uniad_track_map'][latent_render.FIRST_HIT.name]:
        raise RuntimeError('cli uniad_track_map: the stock encoder ran '
                           'latent rendering')
    shutil.rmtree(f'{tmp}/uniad_track_map')
    return runs


# ------------------------------------- phase 12: data preparation and more

NUSC_CAMERAS = ('CAM_FRONT', 'CAM_FRONT_RIGHT', 'CAM_FRONT_LEFT', 'CAM_BACK',
                'CAM_BACK_LEFT', 'CAM_BACK_RIGHT')
# each camera's yaw in the ego frame (x forward, y left), degrees
NUSC_CAMERA_YAW = (0.0, -55.0, 55.0, 180.0, 110.0, -110.0)
# raw nuScenes categories of the tables' instances, an attribute of each and
# the detection class the converter must map each onto
NUSC_CATEGORIES = (
    ('vehicle.car', 'vehicle.moving', 'car'),
    ('vehicle.truck', 'vehicle.parked', 'truck'),
    ('vehicle.construction', 'vehicle.stopped', 'construction_vehicle'),
    ('vehicle.bus.rigid', 'vehicle.moving', 'bus'),
    ('vehicle.trailer', 'vehicle.parked', 'trailer'),
    ('movable_object.barrier', None, 'barrier'),
    ('vehicle.motorcycle', 'cycle.with_rider', 'motorcycle'),
    ('vehicle.bicycle', 'cycle.without_rider', 'bicycle'),
    ('human.pedestrian.adult', 'pedestrian.moving', 'pedestrian'),
    ('movable_object.trafficcone', None, 'traffic_cone'))
NUSC_LOCATIONS = ('boston-seaport', 'singapore-onenorth',
                  'singapore-queenstown', 'singapore-hollandvillage')
# the lidar's mounting on the ego, as nuScenes' LIDAR_TOP: 0.94 m ahead,
# 1.84 m up, turned -90 degrees about z
NUSC_LIDAR2EGO = ([0.943713, 0.0, 1.84023],
                  [math.cos(-math.pi / 4), 0.0, 0.0, math.sin(-math.pi / 4)])


def _yaw_quat(yaw):
    return [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]


def _rot_quat(r):
    """A rotation matrix's unit quaternion [w, x, y, z] (w >= 0)."""
    w = math.sqrt(max(0.0, 1.0 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
    x = math.copysign(math.sqrt(max(0.0, 1 + r[0, 0] - r[1, 1] - r[2, 2]))
                      / 2, r[2, 1] - r[1, 2])
    y = math.copysign(math.sqrt(max(0.0, 1 - r[0, 0] + r[1, 1] - r[2, 2]))
                      / 2, r[0, 2] - r[2, 0])
    z = math.copysign(math.sqrt(max(0.0, 1 - r[0, 0] - r[1, 1] + r[2, 2]))
                      / 2, r[1, 0] - r[0, 1])
    return [w, x, y, z]


def _ego_at(scene, s):
    """The ego's global pose s seconds into a scene: 5 m/s along a gentle
    curve -> (translation [3], yaw)."""
    x0, y0 = 300.0 + 1000.0 * scene, 600.0 + 200.0 * scene
    return (np.array([x0 + 5.0 * s, y0 + 0.05 * s * s, 0.0]),
            math.atan2(0.1 * s, 5.0))


def _map_json(scene, seconds):
    """A map expansion along a scene's ego path: road segments (every
    20 m), a road divider and lane dividers on both sides, and a
    pedestrian crossing every 30 m."""
    nodes, lines, polys = [], [], []
    out = dict(road_divider=[], lane_divider=[], ped_crossing=[],
               road_segment=[])

    def node(x, y):
        nodes.append(dict(token=f'n{len(nodes)}', x=float(x), y=float(y)))
        return nodes[-1]['token']

    def poly(pts, kind):
        tok = f'p{len(polys)}'
        polys.append(dict(token=tok, exterior_node_tokens=[node(*p)
                                                           for p in pts]))
        out[kind].append(dict(token=f'{kind}{len(out[kind])}',
                              polygon_token=tok))

    def path(s):
        t, _ = _ego_at(scene, s)
        return t[0], t[1]

    s_all = np.arange(-12.0, seconds + 12.0, 2.0)
    for off, kind in ((0.0, 'road_divider'), (3.5, 'lane_divider'),
                      (-3.5, 'lane_divider')):
        tok = f'l{len(lines)}'
        lines.append(dict(token=tok, node_tokens=[
            node(*np.add(path(s), (0.0, off))) for s in s_all]))
        out[kind].append(dict(token=f'{kind}{len(out[kind])}',
                              line_token=tok))
    for s in np.arange(-12.0, seconds + 12.0, 4.0):
        (xa, ya), (xb, yb) = path(s), path(s + 4.0)
        poly([(xa, ya - 8), (xb, yb - 8), (xb, yb + 8), (xa, ya + 8)],
             'road_segment')
    for s in np.arange(-6.0, seconds + 6.0, 6.0):
        x, y = path(s)
        poly([(x - 2, y - 7), (x + 2, y - 7), (x + 2, y + 7), (x - 2, y + 7)],
             'ped_crossing')
    return dict(node=nodes, line=lines, polygon=polys, **out)


def _write_nuscenes_tables(root, *, scenes=2, keyframes=40,
                           img_hw=(900, 1600), num_points=34720,
                           instances=40, sweeps=9, canbus=None,
                           version='v1.0-trainval', jpegs=None, first=0,
                           seed=0):
    """nuScenes v1.0 tables under ``root/version`` for ``scenes`` scenes of
    ``keyframes`` 2 Hz keyframes each (40: 20 s, a nuScenes scene), as the
    devkit lays them out: sample, sample_data (6 cameras and LIDAR_TOP per
    keyframe, plus ``sweeps`` lidar sweeps at 20 Hz between keyframes),
    calibrated_sensor, ego_pose, sensor, scene, log and, but in a test
    version, sample_annotation, instance, category and attribute
    (``instances`` tracked instances a keyframe, each in every keyframe of
    its scene), the scenes numbered from ``first``. Each camera's JPEG
    (``jpegs``, one per camera, else an encode of ``_camera_image``) is
    written once and shared by its rows; each keyframe gets its own
    ``num_points`` seeded lidar points and its sweeps share them.
    ``can_bus/<scene>_pose.json`` at 50 Hz for each scene where ``canbus``
    (default all) says so, and ``maps/expansion/<location>.json`` along
    the ego path. -> truth: {scene name: dict(token, samples: [dict(token,
    timestamp, ego (translation, rotation)), ...], boxes: per keyframe the
    [instances, 7] global boxes (x y z w l h yaw), names: each instance's
    detection class, canbus: the written messages, [] where none)}."""
    rng = np.random.default_rng(seed)
    canbus = (True,) * scenes if canbus is None else canbus
    canbus = dict(zip(range(first, first + scenes), canbus))
    h, w = img_hw
    tdir = os.path.join(root, version)
    for d in (tdir, os.path.join(root, 'samples', 'LIDAR_TOP'),
              os.path.join(root, 'can_bus'),
              os.path.join(root, 'maps', 'expansion')):
        os.makedirs(d, exist_ok=True)
    if jpegs is None:
        jpegs = [_encode_jpeg(_camera_image(rng, h, w))
                 for _ in NUSC_CAMERAS]
    cam_files = []
    for c, cam in enumerate(NUSC_CAMERAS):
        os.makedirs(os.path.join(root, 'samples', cam), exist_ok=True)
        cam_files.append(f'samples/{cam}/{cam}.jpg')
        with open(os.path.join(root, cam_files[-1]), 'wb') as f:
            f.write(jpegs[c % len(jpegs)])
    sensors, calib = [], []
    intrinsic = [[1266.4, 0.0, w / 2], [0.0, 1266.4, h / 2],
                 [0.0, 0.0, 1.0]]
    for c, cam in enumerate(NUSC_CAMERAS + ('LIDAR_TOP',)):
        sensors.append(dict(token=f'sensor_{cam}', channel=cam,
                            modality='lidar' if cam == 'LIDAR_TOP'
                            else 'camera'))
        if cam == 'LIDAR_TOP':
            t, q, k = NUSC_LIDAR2EGO[0], NUSC_LIDAR2EGO[1], []
        else:
            a = math.radians(NUSC_CAMERA_YAW[c])
            fwd = np.array([math.cos(a), math.sin(a), 0.0])
            right = np.array([math.sin(a), -math.cos(a), 0.0])
            q = _rot_quat(np.stack([right, [0.0, 0.0, -1.0], fwd], 1))
            t, k = list(fwd * 1.2 + [0.0, 0.0, 1.5]), intrinsic
        calib.append(dict(token=f'calib_{cam}', sensor_token=f'sensor_{cam}',
                          translation=list(t), rotation=list(q),
                          camera_intrinsic=k))
    categories = [dict(token=f'cat{k}', name=n, description='')
                  for k, (n, _, _) in enumerate(NUSC_CATEGORIES)]
    attr_names = sorted({a for _, a, _ in NUSC_CATEGORIES if a})
    attributes = [dict(token=f'attr_{a}', name=a) for a in attr_names]
    tables = {k: [] for k in ('sample', 'sample_data', 'ego_pose', 'scene',
                              'log', 'sample_annotation', 'instance')}
    truth = {}
    for sc in range(first, first + scenes):
        name = f'scene-{sc + 1:04d}'
        t0 = 1533151603547590 + sc * 3600 * 10 ** 6
        tables['log'].append(dict(token=f'log{sc}', logfile=name,
                                  location=NUSC_LOCATIONS[sc % 4]))
        with open(os.path.join(root, 'maps', 'expansion',
                               f'{NUSC_LOCATIONS[sc % 4]}.json'), 'w') as f:
            json.dump(_map_json(sc, keyframes / 2), f)
        stoks = [f'{name}_s{i:02d}' for i in range(keyframes)]
        tables['scene'].append(dict(
            token=f'scene{sc}', name=name, log_token=f'log{sc}',
            nbr_samples=keyframes, first_sample_token=stoks[0],
            last_sample_token=stoks[-1], description=''))
        if canbus[sc]:
            # 50 Hz, each keyframe half way between two messages: the
            # converter keeps the first of the two
            msgs = []
            for k in range(int(keyframes / 2 * 50) + 50):
                s = (k - 25) / 50.0
                p, yaw = _ego_at(sc, s)
                msgs.append(dict(utime=t0 + k * 20000 - 490000,
                                 pos=p.tolist(), orientation=_yaw_quat(yaw),
                                 accel=[0.1 * s, 0.01, 9.81],
                                 rotation_rate=[0.0, 0.0, 0.02],
                                 vel=[5.0, 0.1 * s, 0.0]))
            with open(os.path.join(root, 'can_bus', f'{name}_pose.json'),
                      'w') as f:
                json.dump(msgs, f)
        # the scene's instances: offsets from the ego's start, velocities
        off = rng.uniform(-40, 40, (instances, 2))
        vel = rng.uniform(-1, 1, (instances, 2))
        size = rng.uniform(0.5, 4.0, (instances, 3))
        yaw_i = rng.uniform(-np.pi, np.pi, instances)
        cats = [k % len(NUSC_CATEGORIES) for k in range(instances)]
        itoks = [f'{name}_inst{k}' for k in range(instances)]
        samples, boxes = [], []
        prev_lidar = None
        for i, stok in enumerate(stoks):
            ts = t0 + i * 500000
            p, yaw = _ego_at(sc, i / 2)
            samples.append(dict(token=stok, timestamp=ts,
                                ego=(p.tolist(), _yaw_quat(yaw))))
            tables['sample'].append(dict(
                token=stok, timestamp=ts, scene_token=f'scene{sc}',
                prev=stoks[i - 1] if i else '',
                next=stoks[i + 1] if i + 1 < keyframes else ''))
            # the lidar sweeps before this keyframe (none before the first)
            lfile = f'samples/LIDAR_TOP/{stok}.bin'
            r = rng.uniform(2.0, 50.0, num_points)
            az = rng.uniform(-np.pi, np.pi, num_points)
            np.stack([r * np.cos(az), r * np.sin(az),
                      rng.uniform(-1.8, 2.0, num_points),
                      rng.uniform(0, 255, num_points),
                      np.zeros(num_points)], 1).astype(np.float32).tofile(
                os.path.join(root, lfile))
            chain = [(ts - (sweeps - j) * 50000, False, j)
                     for j in range(sweeps)] if i else []
            chain.append((ts, True, sweeps))
            for t_sd, key, j in chain:
                sd_tok = f'{stok}_lidar{j}'
                pj, yj = _ego_at(sc, (t_sd - t0) / 1e6)
                tables['ego_pose'].append(dict(token=f'ego_{sd_tok}',
                                               timestamp=t_sd,
                                               translation=pj.tolist(),
                                               rotation=_yaw_quat(yj)))
                row = dict(token=sd_tok, sample_token=stok,
                           ego_pose_token=f'ego_{sd_tok}',
                           calibrated_sensor_token='calib_LIDAR_TOP',
                           timestamp=t_sd, fileformat='pcd',
                           is_key_frame=key, height=0, width=0,
                           filename=lfile, next='',
                           prev=prev_lidar['token'] if prev_lidar else '')
                if prev_lidar:
                    prev_lidar['next'] = sd_tok
                tables['sample_data'].append(row)
                prev_lidar = row
            for c, cam in enumerate(NUSC_CAMERAS):
                sd_tok = f'{stok}_{cam}'
                t_c = ts + 5000 * c
                pc_, yc = _ego_at(sc, (t_c - t0) / 1e6)
                tables['ego_pose'].append(dict(token=f'ego_{sd_tok}',
                                               timestamp=t_c,
                                               translation=pc_.tolist(),
                                               rotation=_yaw_quat(yc)))
                tables['sample_data'].append(dict(
                    token=sd_tok, sample_token=stok,
                    ego_pose_token=f'ego_{sd_tok}',
                    calibrated_sensor_token=f'calib_{cam}', timestamp=t_c,
                    fileformat='jpg', is_key_frame=True, height=h, width=w,
                    filename=cam_files[c], prev='', next=''))
            # the instances follow the ego, each drifting by its velocity
            b = np.zeros((instances, 7))
            b[:, :2] = p[:2] + off + vel * (i / 2)
            b[:, 2] = rng.uniform(0.5, 1.5, instances)
            b[:, 3:6] = size
            b[:, 6] = yaw_i
            boxes.append(b)
            for k in range(instances):
                tables['sample_annotation'].append(dict(
                    token=f'{itoks[k]}_a{i}', sample_token=stok,
                    instance_token=itoks[k], visibility_token='4',
                    attribute_tokens=([f'attr_{NUSC_CATEGORIES[cats[k]][1]}']
                                      if NUSC_CATEGORIES[cats[k]][1]
                                      else []),
                    translation=b[k, :3].tolist(), size=b[k, 3:6].tolist(),
                    rotation=_yaw_quat(b[k, 6]),
                    prev=f'{itoks[k]}_a{i - 1}' if i else '',
                    next=(f'{itoks[k]}_a{i + 1}' if i + 1 < keyframes
                          else ''),
                    num_lidar_pts=int(rng.integers(0, 60)),
                    num_radar_pts=int(rng.integers(0, 3))))
        for k in range(instances):
            tables['instance'].append(dict(
                token=itoks[k], category_token=f'cat{cats[k]}',
                nbr_annotations=keyframes,
                first_annotation_token=f'{itoks[k]}_a0',
                last_annotation_token=f'{itoks[k]}_a{keyframes - 1}'))
        truth[name] = dict(token=f'scene{sc}', samples=samples, boxes=boxes,
                           names=[NUSC_CATEGORIES[c][2] for c in cats],
                           canbus=msgs if canbus[sc] else [])
    tables.update(sensor=sensors, calibrated_sensor=calib,
                  category=categories, attribute=attributes)
    if 'test' in version:
        for k in ('sample_annotation', 'instance', 'category', 'attribute'):
            del tables[k]
    for k, rows in tables.items():
        with open(os.path.join(tdir, f'{k}.json'), 'w') as f:
            json.dump(rows, f)
    return truth



def _check_converted(infos, truth):
    """The converter's infos (every split) against the tables
    ``_write_nuscenes_tables`` wrote (``truth``), computed here on their
    own: one info per keyframe, each scene's ``frame_idx`` 0, 1, ... in
    time order; ``can_bus`` the nearest CAN-bus message (the first of two
    equally near), zeros where the scene has none; ``gt_boxes`` the written
    global boxes carried into the lidar frame (centre, size, and the yaw in
    the SECOND convention, -yaw - pi/2) to 1e-9; ``gt_names`` their
    detection classes. Raises on any difference -> {scene: infos}."""
    by_scene = {}
    for info in infos:
        by_scene.setdefault(info['scene_token'], []).append(info)
    l2e_r = _quat_rot(NUSC_LIDAR2EGO[1])
    l2e_t = np.asarray(NUSC_LIDAR2EGO[0])
    lidar_yaw = math.atan2(l2e_r[1, 0], l2e_r[0, 0])
    out = {}
    for name, sc in truth.items():
        got = sorted(by_scene.pop(sc['token'], []),
                     key=lambda i: i['timestamp'])
        if len(got) != len(sc['samples']):
            raise RuntimeError(f'{name}: {len(got)} infos for '
                               f'{len(sc["samples"])} keyframes')
        if [i['frame_idx'] for i in got] != list(range(len(got))):
            raise RuntimeError(f'{name}: frame_idx '
                               f'{[i["frame_idx"] for i in got]}')
        for k, (info, s) in enumerate(zip(got, sc['samples'])):
            if info['token'] != s['token']:
                raise RuntimeError(f'{name}: keyframe {k} is '
                                   f'{info["token"]}')
            want = np.zeros(18)
            if sc['canbus']:
                gap = [abs(m['utime'] - s['timestamp'])
                       for m in sc['canbus']]
                m = sc['canbus'][gap.index(min(gap))]
                want[:16] = (m['pos'] + m['orientation'] + m['accel'] +
                             m['rotation_rate'] + m['vel'])
            if not np.array_equal(info['can_bus'], want):
                raise RuntimeError(f'{name} keyframe {k}: can_bus '
                                   f'{info["can_bus"]} != {want}')
            e2g_t, e2g_q = s['ego']
            e2g_r = _quat_rot(e2g_q)
            boxes = sc['boxes'][k]
            centre = ((boxes[:, :3] - e2g_t) @ e2g_r - l2e_t) @ l2e_r
            ego_yaw = math.atan2(e2g_r[1, 0], e2g_r[0, 0])
            yaw = -(boxes[:, 6] - ego_yaw - lidar_yaw) - np.pi / 2
            gb = np.asarray(info['gt_boxes'])
            dyaw = np.angle(np.exp(1j * (gb[:, 6] - yaw)))
            err = max(np.abs(gb[:, :3] - centre).max(),
                      np.abs(gb[:, 3:6] - boxes[:, 3:6]).max(),
                      np.abs(dyaw).max())
            if gb.shape != boxes.shape or err > 1e-9:
                raise RuntimeError(f'{name} keyframe {k}: gt_boxes off the '
                                   f'written boxes by {err}')
            if list(info['gt_names']) != sc['names']:
                raise RuntimeError(f'{name} keyframe {k}: gt_names '
                                   f'{list(info["gt_names"])}')
        out[name] = got
    if by_scene:
        raise RuntimeError(f'infos of unknown scenes {sorted(by_scene)}')
    return out


def _quat_rot(q):
    """A unit quaternion's rotation matrix (nuScenes [w, x, y, z])."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])

FULLSET_CONFIG = (ROOT / 'configs' / 'vidar_pretrain' / 'nusc_fullset' /
                  'vidar_full_nusc_1future.py')
# phase 12's tables: two nuScenes scenes of 40 keyframes (trainval) and one
# (test), the converted pkls' counts
P12_SCENES, P12_KEYFRAMES = 2, 40
# the auction's total against scipy's: within G * eps, eps its own
# max(span of the costs, 1) * 1e-3, plus f32 rounding of the two sums
AUCTION_EPS_SCALE = 1e-3


def _cli_run(counted, card, name, fn, argv, keepers=None):
    """One CLI run in this process with every kernel's count set to 0 ->
    (what it returned, {kernel: launches}); prints its wall time, peak
    device memory and launches."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches = _run_counted(counted, keepers or {}, lambda: fn(argv))
    print(f'cli {name}: {time.perf_counter() - t0:.2f} s wall, peak device '
          f'memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, '
          f'launches {json.dumps(launches)} on {card}', flush=True)
    return out, launches


def _need(name, launches, kernels, absent=(), phase=12):
    never = [k.name for k in kernels if launches[k.name] <= 0]
    ran = [k.name for k in absent if launches[k.name]]
    if never or ran:
        raise RuntimeError(f'phase {phase} {name}: kernels {never} never '
                           f'launched, {ran} launched off their path')


def _phase12_data(tmp, jpegs):
    """12a-b: nuScenes tables written (``_write_nuscenes_tables``), then the
    port's data-preparation CLIs on them as users run them: the converter
    (trainval and test), the map converter on the train pkl, the k-means
    anchors (6 modes, 12 steps) and merge-fullset; each output checked
    against what was written. -> dict of the outputs' paths."""
    from vidar_tpu_torch.data import nuscenes_converter
    from vidar_tpu_torch.tools import data_tools, map_converter

    t0 = time.perf_counter()
    truth = _write_nuscenes_tables(tmp, scenes=P12_SCENES,
                                   keyframes=P12_KEYFRAMES, jpegs=jpegs)
    _write_nuscenes_tables(tmp, scenes=1, keyframes=P12_KEYFRAMES,
                           jpegs=jpegs, version='v1.0-test', first=P12_SCENES,
                           seed=1)
    samples = (P12_SCENES + 1) * P12_KEYFRAMES
    print(f'phase 12a: nuScenes v1.0 tables, {P12_SCENES} trainval scenes '
          f'and 1 test scene of {P12_KEYFRAMES} keyframes (6 JPEG cameras '
          f'900x1600 shared by the rows, 34720 lidar points a keyframe, 9 '
          f'sweeps at 20 Hz between keyframes, 40 instances, CAN bus at 50 '
          f'Hz, map expansions), written in {time.perf_counter() - t0:.1f} s',
          flush=True)
    t0 = time.perf_counter()
    nuscenes_converter.main([tmp, '--out-dir', tmp])
    nuscenes_converter.main([tmp, '--out-dir', tmp, '--version',
                             'v1.0-test'])
    conv_s = time.perf_counter() - t0
    pkl = {s: os.path.join(tmp, f'nuscenes_infos_temporal_{s}.pkl')
           for s in ('train', 'val', 'test', 'traintest')}
    infos = {}
    for s in ('train', 'val', 'test'):
        with open(pkl[s], 'rb') as f:
            infos[s] = pickle.load(f)['infos']
    _check_converted(infos['train'] + infos['val'], truth)
    if (len(infos['test']) != P12_KEYFRAMES or
            [i['frame_idx'] for i in infos['test']] !=
            list(range(P12_KEYFRAMES)) or 'gt_boxes' in infos['test'][0]):
        raise RuntimeError('phase 12b: the test split\'s infos')
    print(f'phase 12b: converter {conv_s:.3f} s for {samples} samples, '
          f'{conv_s / samples * 1e3:.2f} ms of host time a sample; infos '
          f'train {len(infos["train"])}, val {len(infos["val"])}, test '
          f'{len(infos["test"])}; frame_idx, the nearest CAN-bus pose and '
          f'the GT boxes in the lidar frame equal the tables\'', flush=True)

    t0 = time.perf_counter()
    maps = os.path.join(tmp, 'nuscenes_map_anns_train.pkl')
    n = map_converter.main(['--data-root', tmp, '--infos', pkl['train'],
                            '--out', maps])
    with open(maps, 'rb') as f:
        anns = pickle.load(f)
    per = [len(a['labels']) for a in anns.values()]
    classes = sorted({int(c) for a in anns.values() for c in a['labels']})
    if n != len(infos['train']) or min(per) == 0 or classes != [0, 1, 2]:
        raise RuntimeError(f'phase 12b: map anns for {n} samples, '
                           f'{min(per)}-{max(per)} elements, classes '
                           f'{classes}')
    anchors = os.path.join(tmp, 'motion_anchor_infos_mode6.pkl')
    out = data_tools.main(['kmeans-anchors', pkl['train'], anchors])
    a = np.stack(out['anchors_all'])
    if a.shape != (4, 6, 12, 2) or not np.isfinite(a).all() or not any(
            out['meta']['counts']):
        raise RuntimeError(f'phase 12b: anchors of shape {a.shape}, '
                           f'counts {out["meta"]["counts"]}')
    data_tools.main(['merge-fullset', pkl['train'], pkl['test'],
                     pkl['traintest']])
    with open(pkl['traintest'], 'rb') as f:
        merged = pickle.load(f)['infos']
    stamps = [i['timestamp'] for i in merged]
    if len(merged) != len(infos['train']) + len(infos['test']) or \
            stamps != sorted(stamps):
        raise RuntimeError('phase 12b: the merged fullset pkl')
    print(f'phase 12b: map anns for {n} samples ({min(per)}-{max(per)} '
          f'elements, classes {classes}); k-means anchors {a.shape} from '
          f'{out["meta"]["counts"]} trajectories per class group; fullset '
          f'pkl {len(merged)} infos; {time.perf_counter() - t0:.2f} s',
          flush=True)
    return dict(pkl=pkl, maps=maps, anchors=anchors, root=tmp)


def _phase12_uniad(counted, card, paths):
    """12c: ``vidar_e2e.py`` through the train CLI for 1 step on the
    converted train pkl with its map gt and k-means anchors (a 2-frame
    clip, ``UNIAD_SHORT_CLIP``), then its UniAD eval on the val pkl. -> ({run:
    launches}, the trained model's element count, the config's count by
    ``count_params``)."""
    from vidar_tpu_torch.core.builder import build_dataset
    from vidar_tpu_torch.core.config import apply_overrides, load_config
    from vidar_tpu_torch.ops import dcn, latent_render, msda
    from vidar_tpu_torch.tools import analysis
    from vidar_tpu_torch.tools import test as test_cli
    from vidar_tpu_torch.tools import train as train_cli

    pkl, root = paths['pkl'], paths['root']
    opts = [f'data.train.ann_file={pkl["train"]}',
            f'data.train.data_root={root}',
            f'data.train.map_ann_file={paths["maps"]}',
            f'data.test.ann_file={pkl["val"]}', f'data.test.data_root={root}',
            f'model.anchor_info_path={paths["anchors"]}']
    # the map gt reaches the targets: a train sample's map elements
    cfg = apply_overrides(load_config(str(UNIAD_E2E_CONFIG)),
                          opts + ['data.train.queue_length=1'])
    _, targets, _ = build_dataset(cfg['data']['train'])[0]
    n_map = int(targets.num_valid_map.reshape(-1)[0])
    if n_map <= 0:
        raise RuntimeError('phase 12c: no map gt in a train sample')
    runs = {}
    forward = [msda.KERNEL, dcn.SAMPLE, latent_render.FIRST_HIT,
               latent_render.AGGREGATE]
    backward = [msda.BACKWARD, latent_render.FIRST_HIT_BACKWARD,
                latent_render.AGGREGATE_BACKWARD]
    work = f'{root}/uniad_e2e'
    frames = load_config(str(UNIAD_E2E_CONFIG))['data']['train'][
        'queue_length'] + 1
    out, launches = _cli_run(
        counted, card, 'p12_uniad_e2e', train_cli.main,
        [str(UNIAD_E2E_CONFIG), '--work-dir', work, '--max-steps', '1',
         '--cfg-options', *opts, 'log_interval=1',
         f'data.train.queue_length={UNIAD_SHORT_CLIP - 1}'])
    runs['p12_uniad_e2e'] = launches
    _need('uniad_e2e', launches, forward + backward,
          (dcn.KERNEL, dcn.SAMPLE16))
    _train_log('p12_uniad_e2e', out, 1)
    model = out.pop('model')
    if model.anchors.abs().sum() == 0 or not torch.isfinite(
            model.anchors).all():
        raise RuntimeError('phase 12c: the k-means anchors did not load')
    mp = [m['map.loss'] for m in out['log']]
    if not all(np.isfinite(v) and v > 0 for v in mp):
        raise RuntimeError(f'phase 12c: map losses {mp}')
    built = analysis.param_counts(model)[0]
    counted_cfg = analysis.count_params(str(UNIAD_E2E_CONFIG))
    print(f'phase 12c: {UNIAD_SHORT_CLIP}-frame clips (a depth cut: the '
          f'config\'s {frames} frames run in phase 11); map gt: '
          f'{n_map} elements in train sample 0; map.loss {mp} (finite, > 0); '
          f'k-means anchors {tuple(model.anchors.shape)} loaded; s/it '
          f'{[round(1 / m["it/s"], 3) for m in out["log"]]} on {card}',
          flush=True)
    del model, out
    torch.cuda.empty_cache()
    metrics, launches = _cli_run(
        counted, card, 'p12_uniad_eval', test_cli.main,
        [str(UNIAD_E2E_CONFIG), f'{work}/latest', '--max-samples', '2',
         '--out', f'{root}/uniad_p12.json', '--cfg-options', *opts])
    runs['p12_uniad_eval'] = launches
    _need('uniad_eval', launches, forward, (dcn.KERNEL, dcn.SAMPLE16))
    _finite_metrics('p12_uniad_eval', metrics, UNIAD_KEYS)
    print('cli p12_uniad_eval: ' + ', '.join(
        f'{k} {float(metrics[k]):.4f}' for k in UNIAD_KEYS), flush=True)
    shutil.rmtree(work)
    return runs, built, counted_cfg


def _phase12_fullset(counted, card, paths):
    """12d: the fullset pre-training config for 1 step on the merged
    traintest pkl -> {run: launches}."""
    from vidar_tpu_torch.ops import dcn, latent_render, msda
    from vidar_tpu_torch.tools import train as train_cli
    pkl, root = paths['pkl'], paths['root']
    out, launches = _cli_run(
        counted, card, 'p12_fullset', train_cli.main,
        [str(FULLSET_CONFIG), '--work-dir', f'{root}/fullset', '--max-steps',
         '1', '--cfg-options', f'data.train.ann_file={pkl["traintest"]}',
         f'data.train.data_root={root}', f'data.test.ann_file={pkl["val"]}',
         f'data.test.data_root={root}', 'log_interval=1'])
    _need('fullset', launches,
          [msda.KERNEL, dcn.SAMPLE, latent_render.FIRST_HIT,
           latent_render.AGGREGATE, msda.BACKWARD,
           latent_render.FIRST_HIT_BACKWARD,
           latent_render.AGGREGATE_BACKWARD], (dcn.KERNEL, dcn.SAMPLE16))
    _train_log('p12_fullset', out, 1)
    print(f'phase 12d: {FULLSET_CONFIG.relative_to(ROOT)}, 1 step on '
          f'the merged traintest pkl on {card}', flush=True)
    shutil.rmtree(f'{root}/fullset')
    return {'p12_fullset': launches}


def _p12_keepers(run, train):
    """The bf16 fine-tune's keepers: each kernel's first input of each
    case, named ``run:case`` (K1 and K5 by attention, K2 by ResNet stage
    and image count, K3/K4 and K6/K7, K8 ``run:encoder``)."""
    from vidar_tpu_torch.ops import dcn, latent_render, msda

    def msda_case(a):
        return f'{run}:{_msda_case(a) or "other"}'
    keepers = {msda.KERNEL.name: _Keeper(msda_case),
               dcn.KERNEL.name: _Keeper(
                   lambda a: f'{run}:{_dcn_image_case(a)}'),
               latent_render.FIRST_HIT.name: _Keeper(
                   lambda a: f'{run}:encoder'),
               latent_render.AGGREGATE.name: _Keeper(
                   lambda a: f'{run}:encoder')}
    if train:
        keepers.update({
            msda.BACKWARD.name: _Keeper(msda_case),
            latent_render.FIRST_HIT_BACKWARD.name: _Keeper(
                lambda a: f'{run}:encoder'),
            latent_render.AGGREGATE_BACKWARD.name: _Keeper(
                lambda a: f'{run}:encoder')})
    return keepers


def _phase12_bf16(counted, card, check, paths, dev):
    """12e: ``BEVFormerFP16`` (bf16 compute, f32 parameters) at the
    fine-tune's full width and depth on phase 6's synthetic batch (5 x 6 x
    928x1600, 40 GT boxes of 128), random 0.02-scale weights: the
    full-window eval and 3 streamed frames, then a train step, every
    kernel counted and held against its plain version on the bf16 inputs
    it kept (``check``); then the fine-tune train CLI with
    ``model.type=BEVFormer_fp16`` for 1 step on the converted train pkl
    and its test CLI on the val pkl. -> ({run: launches}, the model's
    last-layer class logits and boxes of the window eval, for 12f)."""
    from vidar_tpu_torch.configs import vidar_finetune_1_8_nusc_3future
    from vidar_tpu_torch.data import make_synthetic_det_batch
    from vidar_tpu_torch.evals.det_runner import DetectionRunner
    from vidar_tpu_torch.models import BEVFormerFP16
    from vidar_tpu_torch.ops import dcn, latent_render, msda
    from vidar_tpu_torch.tools import test as test_cli
    from vidar_tpu_torch.tools import train as train_cli
    from vidar_tpu_torch.train import DetTrainStep, make_optimizer

    torch.backends.cudnn.allow_tf32 = False
    forward = [msda.KERNEL, dcn.KERNEL, latent_render.FIRST_HIT,
               latent_render.AGGREGATE]
    backward = [msda.BACKWARD, latent_render.FIRST_HIT_BACKWARD,
                latent_render.AGGREGATE_BACKWARD]
    runs = {}
    det = BEVFormerFP16(**vidar_finetune_1_8_nusc_3future(),
                        device=dev).eval()
    det.randomize_(torch.Generator(device=dev).manual_seed(12), 0.02)
    q, cams, ih, iw, n_gt, max_gt = 4, 6, 928, 1600, 40, 128
    batch = make_synthetic_det_batch(
        np.random.default_rng(0), bs=1, queue_length=q, num_cams=cams,
        img_h=ih, img_w=iw, max_points=64, max_gt=max_gt, num_gt=n_gt,
        device=dev)
    full = DetectionRunner(det, device=dev)
    stream = DetectionRunner(det, streaming=True, device=dev)
    frames = [(_window(batch, q - 1 + k), _stream_meta(k)) for k in range(3)]

    def det_eval():
        times = []
        out = {}
        for name, fn in [('full', lambda: full(batch))] + [
                (f'stream{k}', lambda b=b, m=m: stream(b, m))
                for k, (b, m) in enumerate(frames)]:
            t0 = time.perf_counter()
            out[name] = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, times

    keepers = _p12_keepers('bf16_eval', train=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (samples, times), launches = _run_counted(counted, keepers, det_eval)
    peak = torch.cuda.max_memory_allocated()
    runs['p12_bf16_eval'] = launches
    _need('bf16 eval', launches, forward, (dcn.SAMPLE, dcn.SAMPLE16))
    for name, (pred, gt) in samples.items():
        _check_detections(name, pred, gt, 10)
    print(f'phase 12e: BEVFormer_fp16 eval (bf16, 5 x {cams} x {ih}x{iw}, '
          f'900 queries, 200x200 BEV): full window {times[0]:.4f} s (with '
          f'warm-up), streamed frames '
          f'{" ".join(f"{t:.4f}" for t in times[1:])}'
          f' s; peak memory {peak / 2**30:.2f} GiB; launches '
          f'{json.dumps(launches)} on {card}', flush=True)
    check('bf16_eval', keepers, launches)
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        preds = det(batch.frames, train=False)
    logits = (preds['all_cls_scores'][-1][0].float(),
              preds['all_bbox_preds'][-1][0].float())
    del preds, samples, full, stream

    step = DetTrainStep(det, make_optimizer(det, device=dev),
                        generator=torch.Generator(device=dev).manual_seed(13),
                        device=dev)
    keepers = _p12_keepers('bf16_train', train=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, launches = _run_counted(counted, keepers, lambda: step(batch))
    warm = time.perf_counter() - t0
    runs['p12_bf16_train'] = launches
    _need('bf16 train step', launches, forward + backward,
          (dcn.SAMPLE, dcn.SAMPLE16))
    if not all(np.isfinite(v) for v in metrics.values()) or not \
            metrics['grad_norm'] > 0:
        raise RuntimeError(f'phase 12e: step metrics {metrics}')
    check('bf16_train', keepers, launches)
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = step(batch)
    torch.cuda.synchronize()
    st = time.perf_counter() - t0
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f'phase 12e: step metrics {metrics}')
    print(f'phase 12e: BEVFormer_fp16 train step 1 (warm-up) {warm:.3f} s, '
          f'step 2 {st:.4f} s/it, peak memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss '
          f'{metrics["loss"]:.5f}, grad_norm {metrics["grad_norm"]:.5g} on '
          f'{card}', flush=True)
    del det, step, batch
    torch.cuda.empty_cache()

    # the fine-tune CLIs as users select the variant, on the converted data
    torch.backends.cudnn.allow_tf32 = True
    pkl, root = paths['pkl'], paths['root']
    opts = [f'data.train.ann_file={pkl["train"]}',
            f'data.train.data_root={root}',
            f'data.test.ann_file={pkl["val"]}', f'data.test.data_root={root}',
            'model.type=BEVFormer_fp16', 'log_interval=1']
    work = f'{root}/ft16'
    out, launches = _cli_run(
        counted, card, 'p12_bf16_finetune', train_cli.main,
        [str(FINETUNE_CONFIG), '--work-dir', work, '--max-steps', '1',
         '--cfg-options', *opts])
    runs['p12_bf16_finetune'] = launches
    if type(out['model']).__name__ != 'BEVFormerFP16':
        raise RuntimeError(f'phase 12e: the CLI built '
                           f'{type(out["model"]).__name__}')
    _need('bf16 fine-tune CLI', launches, forward + backward,
          (dcn.SAMPLE, dcn.SAMPLE16))
    _train_log('p12_bf16_finetune', out, 1)
    del out
    metrics, launches = _cli_run(
        counted, card, 'p12_bf16_det_eval', test_cli.main,
        [str(FINETUNE_CONFIG), f'{work}/latest', '--max-samples', '2',
         '--cfg-options', *opts])
    runs['p12_bf16_det_eval'] = launches
    _need('bf16 test CLI', launches, forward, (dcn.SAMPLE, dcn.SAMPLE16))
    _finite_metrics('p12_bf16_det_eval', metrics, ('NDS', 'mAP'))
    print(f'cli p12_bf16_det_eval: NDS {float(metrics["NDS"]):.4f}, mAP '
          f'{float(metrics["mAP"]):.4f}', flush=True)
    shutil.rmtree(work)
    return runs, logits


def _phase12_matchers(card, logits, dev):
    """12f: ``hungarian_assign(impl='auction')`` on the card against scipy
    on the fine-tune's cost [900, G] (the bf16 eval's last-layer logits and
    boxes against G random GT boxes, the head's focal + L1 cost), G = 40
    and 200: every GT owned once, the total within G * eps of scipy's."""
    from vidar_tpu_torch.core import bbox as bbox_core
    cls, boxes = logits
    rng = np.random.default_rng(14)
    for g in (40, 200):
        gt = np.zeros((g, 9), np.float32)
        gt[:, :2] = rng.uniform(-45, 45, (g, 2))
        gt[:, 2] = rng.uniform(-2, 0, g)
        gt[:, 3:6] = rng.uniform(0.5, 4.0, (g, 3))
        gt[:, 6] = rng.uniform(-np.pi, np.pi, g)
        gt_n = bbox_core.normalize_bbox(torch.from_numpy(gt).to(dev))
        labels = torch.from_numpy(rng.integers(0, 10, g)).to(dev)
        cost = (bbox_core.focal_loss_cost(cls, labels) +
                bbox_core.bbox3d_l1_cost(boxes, gt_n))
        times = {}
        for impl in ('scipy', 'auction', 'scipy', 'auction'):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            owner = bbox_core.hungarian_assign(cost, g, impl=impl)
            torch.cuda.synchronize()
            times[impl] = time.perf_counter() - t0   # the second of each
            if impl == 'scipy':
                exact = owner
        _, iters = bbox_core.auction_assign(cost, g, return_iters=True)
        c, owner, exact = cost.double().cpu(), owner.cpu(), exact.cpu()
        total = float(c[owner >= 0, owner[owner >= 0]].sum())
        opt = float(c[exact >= 0, exact[exact >= 0]].sum())
        eps = max(float(c.max() - c.min()), 1.0) * AUCTION_EPS_SCALE
        owned = sorted(owner[owner >= 0].tolist())
        print(f'phase 12f: matcher on the fine-tune cost [900, {g}]: '
              f'auction {times["auction"] * 1e3:.2f} ms ({iters} rounds, on '
              f'the card), scipy {times["scipy"] * 1e3:.2f} ms (copy to the '
              f'host + linear_sum_assignment); totals {total:.4f} vs '
              f'{opt:.4f}, G*eps {g * eps:.4f} on {card}', flush=True)
        if owned != list(range(g)) or total > opt + g * eps + 1e-6 * abs(
                opt):
            raise RuntimeError(f'phase 12f: the auction at G = {g} is off '
                               f'scipy\'s optimum')


def _phase12_analysis(counted, card, paths, forecast_s, dev):
    """12g: ``tools/analysis.py`` on the card: ``count_params`` of
    ``vidar_1_8_nusc_3future`` against the model built from it,
    ``benchmark`` (3 samples, bf16, 928x1600) beside phase 4's forecast,
    ``profile_trace`` (a Chrome trace holding the forecast's ``timer``
    spans and device kernels), ``visibility_scan`` on the converted train
    pkl. -> {run: launches}."""
    from vidar_tpu_torch.core.builder import build_model
    from vidar_tpu_torch.core.config import load_config
    from vidar_tpu_torch.ops import dcn, latent_render, msda
    from vidar_tpu_torch.tools import analysis

    model = build_model(load_config(str(PRETRAIN_CONFIG))['model'],
                        device=dev)
    built = analysis.param_counts(model)[0]
    del model
    total = analysis.count_params(str(PRETRAIN_CONFIG))
    if total != built:
        raise RuntimeError(f'phase 12g: count_params {total} != {built}')
    fps, launches = _run_counted(counted, {}, lambda: analysis.benchmark(
        str(PRETRAIN_CONFIG), samples=3, device=dev))
    _need('benchmark', launches, [msda.KERNEL, dcn.KERNEL,
                                  latent_render.FIRST_HIT,
                                  latent_render.AGGREGATE],
          (dcn.SAMPLE, dcn.SAMPLE16, msda.BACKWARD))
    print(f'phase 12g: count_params {total} = the built model\'s; '
          f'benchmark {fps:.4f} samples/s = {1 / fps:.4f} s/sample (phase 4: '
          f'{forecast_s:.4f} s/sample) on {card}', flush=True)
    trace = analysis.profile_trace(str(PRETRAIN_CONFIG),
                                   f'{paths["root"]}/trace', device=dev)
    with open(trace) as f:
        events = json.load(f)['traceEvents']
    names = {e.get('name') for e in events}
    spans = sorted(n for n in names if str(n).startswith('forecast/'))
    kernels = sum(1 for e in events if e.get('cat') == 'kernel')
    if spans != ['forecast/backbone', 'forecast/decode', 'forecast/encode',
                 'forecast/rollout'] or not kernels:
        raise RuntimeError(f'phase 12g: trace spans {spans}, {kernels} '
                           f'device kernels')
    print(f'phase 12g: profile trace {os.path.getsize(trace)} bytes, '
          f'{len(events)} events, {kernels} device kernels, spans {spans}',
          flush=True)
    os.remove(trace)
    t0 = time.perf_counter()
    rep = analysis.visibility_scan(
        str(PRETRAIN_CONFIG), max_samples=1, cfg_options=[
            f'data.train.ann_file={paths["pkl"]["train"]}',
            f'data.train.data_root={paths["root"]}'])
    if not 0 < rep['visible_frac_peak'] <= 1:
        raise RuntimeError(f'phase 12g: visibility {rep}')
    print(f'phase 12g: visibility_scan on the converted train pkl in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    return {'p12_benchmark': launches}


def _phase12_video(counted, card, dev):
    """12h: one video-replay train step (``make_video_train_step``) of
    ``vidar_base`` in bf16 with f32 parameters at full width (bs 1, 4+1
    frames x 6 x 928x1600, 32768 GT points), random 0.02-scale weights: a
    warm-up step and a timed one. -> {run: launches}."""
    from vidar_tpu_torch.configs import vidar_base
    from vidar_tpu_torch.data import make_synthetic_batch
    from vidar_tpu_torch.models import ViDAR
    from vidar_tpu_torch.ops import dcn, latent_render, msda
    from vidar_tpu_torch.train import make_optimizer
    from vidar_tpu_torch.train.video_runner import make_video_train_step

    torch.backends.cudnn.allow_tf32 = False
    model = ViDAR(**vidar_base(), dtype=torch.bfloat16, device=dev)
    model.randomize_(torch.Generator(device=dev).manual_seed(15), 0.02)
    batch = make_synthetic_batch(np.random.default_rng(3), bs=1,
                                 queue_length=4, future_length=3, num_cams=6,
                                 img_h=928, img_w=1600, max_points=32768,
                                 device=dev)
    step = make_video_train_step(
        model, make_optimizer(model, device=dev),
        generator=torch.Generator(device=dev).manual_seed(16), device=dev)
    t0 = time.perf_counter()
    metrics, launches = _run_counted(counted, {}, lambda: step(batch))
    warm = time.perf_counter() - t0
    _need('video step', launches,
          [msda.KERNEL, dcn.KERNEL, latent_render.FIRST_HIT,
           latent_render.AGGREGATE, msda.BACKWARD,
           latent_render.FIRST_HIT_BACKWARD,
           latent_render.AGGREGATE_BACKWARD], (dcn.SAMPLE, dcn.SAMPLE16))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = step(batch)
    torch.cuda.synchronize()
    st = time.perf_counter() - t0
    if not all(np.isfinite(v) for v in metrics.values()) or not \
            metrics['grad_norm'] > 0:
        raise RuntimeError(f'phase 12h: video step metrics {metrics}')
    print(f'phase 12h: video train step (vidar_base bf16, 4 history frames '
          f'replayed without gradient, the current one with): warm-up '
          f'{warm:.3f} s, then {st:.4f} s/it, peak memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss '
          f'{metrics["loss"]:.5f}, grad_norm {metrics["grad_norm"]:.5g}; '
          f'launches {json.dumps(launches)} on {card}', flush=True)
    del model, step, batch
    torch.cuda.empty_cache()
    return {'p12_video_step': launches}


def _phase12(counted, card, check, fixture_dir, forecast_s, dev='cuda:0'):
    """Phase 12: the data path as users run it, end to end, then the rest
    of the fine-tune, the analysis tools and the video step (12a-h). ->
    ({run: launches}, the converted tables' paths, which phase 13 reads;
    they stay under ``fixture_dir``)."""
    dev = torch.device(dev)
    t0 = time.perf_counter()
    tmp = os.path.join(fixture_dir, 'nusc_tables')
    jpegs = []
    for c in range(6):
        with open(os.path.join(fixture_dir, 'samples', f'img_0_{c}.jpg'),
                  'rb') as f:
            jpegs.append(f.read())
    paths = _phase12_data(tmp, jpegs)
    runs, built, counted_cfg = _phase12_uniad(counted, card, paths)
    if built != counted_cfg:
        raise RuntimeError(f'phase 12g: count_params of vidar_e2e.py '
                           f'{counted_cfg} != the trained model\'s {built}')
    print(f'phase 12g: count_params(vidar_e2e.py) {counted_cfg} = the '
          f'trained model\'s', flush=True)
    runs.update(_phase12_fullset(counted, card, paths))
    bf16_runs, logits = _phase12_bf16(counted, card, check, paths, dev)
    runs.update(bf16_runs)
    _phase12_matchers(card, logits, dev)
    del logits
    runs.update(_phase12_analysis(counted, card, paths, forecast_s, dev))
    runs.update(_phase12_video(counted, card, dev))
    print(f'phase 12: {time.perf_counter() - t0:.1f} s', flush=True)
    return runs, paths

# ------------------------------ phase 13: the BEVFormerV2 family and tools

TINY_CONFIG = ROOT / 'configs' / 'tiny' / 'vidar_tiny.py'
# the fine-tune config shrunk to tests/test_torch_cli.py's sizes, for the
# detection dump that 13e renders
FINETUNE_TINY = [
    'model.embed_dims=32', 'model.bev_h=12', 'model.bev_w=12',
    'model.num_query=24', 'model.backbone_depth=50',
    'model.encoder_num_layers=2', 'model.latent_render_lids=(1,)',
    "model.latent_render_cfg={'pred_height': 4, 'grid_num': 8, "
    "'grid_step': 0.5, 'reduction': 8, 'act': 'sigmoid', 'embed_dims': 32}",
    'data.train.bev_size=(12,12)', 'data.test.bev_size=(12,12)',
    'data.train.queue_length=2', 'data.test.queue_length=2']
# R101's deformable blocks in stages 3-4 (backbone_dcn (F, F, T, T))
R101_DCN_BLOCKS = 23 + 3
# 13a's small check: tests/test_torch_bevformer_v2.py's model with DCN in
# stages 3-4, so that K9 runs too
V2_TINY = dict(embed_dims=32, bev_h=8, bev_w=8, num_cams=3, num_query=16,
               backbone_depth=50, backbone_dcn=(False, False, True, True),
               frames=(-1, 0), num_fusion=1, encoder_num_layers=1)
# 13d: vidar_base's grid (16 x 200 x 200), 3 frames, 32,768 rays
VOXEL_GRID, VOXEL_FRAMES, VOXEL_RAYS = (16, 200, 200), 3, 32768
VOXEL_STEPS = 417                    # Z + H + W + 1


def _read_png(path):
    """This script's own PNG reader (zlib; rows of filter type 0, as the
    port's writer makes them): an 8-bit RGB PNG -> [h, w, 3] uint8."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise RuntimeError(f'{path}: not a PNG')
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b'IHDR':
            hdr = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
    w, h, depth, ctype = hdr[:4]
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8).reshape(
        h, 1 + 3 * w)
    if (depth, ctype) != (8, 2) or raw[:, 0].any():
        raise RuntimeError(f'{path}: PNG of depth {depth}, type {ctype}, '
                           f'row filters {sorted(set(raw[:, 0]))}')
    return raw[:, 1:].reshape(h, w, 3)


def _png_check(path, shape, colors):
    """A PNG of ``shape`` [h, w] holding every one of ``colors`` ('#rrggbb')
    -> its pixel counts of each."""
    img = _read_png(path)
    if img.shape[:2] != tuple(shape):
        raise RuntimeError(f'{path}: {img.shape[:2]}, not {shape}')
    counts = {}
    for c in colors:
        rgb = np.array([int(c[i:i + 2], 16) for i in (1, 3, 5)], np.uint8)
        counts[c] = int((img == rgb).all(-1).sum())
        if not counts[c]:
            raise RuntimeError(f'{path}: no pixel of colour {c}')
    return counts


class _Mono(torch.nn.Module):
    """13b's DD3D: VoVNet-99 (eSE), the port's FPN to 5 levels at 256
    channels (strides 8-128) and ``NuScenesDD3D``. ``losses`` runs one
    camera image of one sample through it against the sample's targets."""

    def __init__(self, dev, image, gt, inv_k):
        super().__init__()
        from vidar_tpu_torch.models.dd3d import NuScenesDD3D
        from vidar_tpu_torch.models.fpn import FPN
        from vidar_tpu_torch.models.vovnet import VoVNet
        self.img_backbone = VoVNet('V-99-eSE', device=dev)
        self.img_neck = FPN((512, 768, 1024), 256, num_outs=5, device=dev)
        self.head = NuScenesDD3D(channels=256, device=dev)
        self.image, self.gt, self.inv_k = image, gt, inv_k

    def forward(self):
        return self.head(self.img_neck(self.img_backbone(self.image)))

    def losses(self):
        return self.head.loss(self(), self.gt, self.inv_k)


def _phase13_mono(card, dev, tables):
    """13b: DD3D on one camera image of one sample of phase 12's converted
    train pkl (``NuScenesMonoDataset``, its JPEG camera through the port's
    decoder): forward, ``loss`` on the sample's targets, backward, then
    ``inference`` with the class-wise NMS. -> the model, which 13a's train
    step reads for its mono losses."""
    from vidar_tpu_torch.data.nuscenes_mono import NuScenesMonoDataset

    ds = NuScenesMonoDataset(tables['pkl']['train'], data_root=tables['root'])
    item = next(ds[i] for i in range(len(ds)) if ds[i]['num_valid'] > 0)
    t0 = time.perf_counter()
    img = ds.load_image(item)
    load_s = time.perf_counter() - t0
    mean = np.array([103.530, 116.280, 123.675], np.float32)
    image = torch.from_numpy(img - mean)[None].to(dev)
    gt = {k: torch.as_tensor(np.asarray(item[k])).to(dev) for k in (
        'boxes2d', 'labels', 'num_valid', 'quat', 'proj_ctr', 'depth',
        'size')}
    inv_k = torch.linalg.inv(torch.from_numpy(item['intrinsics']).double()
                             ).float().to(dev)
    mono = _Mono(dev, image, gt, inv_k)
    _unit_scale_(mono, torch.Generator(device=dev).manual_seed(131))
    mono.train()
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        mono.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        losses = mono.losses()
        sum(losses.values()).backward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    vals = {k: float(v.detach()) for k, v in losses.items()}
    grads = [p.grad for p in mono.parameters() if p.grad is not None]
    # a positive location of the sample's boxes carries a box loss
    if not all(np.isfinite(v) for v in vals.values()) or not grads or \
            not all(bool(torch.isfinite(g).all()) for g in grads) or \
            not vals['loss_box2d_reg'] > 0:
        raise RuntimeError(f'phase 13b: DD3D losses {vals}')
    mono.eval()
    t0 = time.perf_counter()
    with torch.inference_mode():
        det = mono.head.inference(mono(), inv_k)
        torch.cuda.synchronize()
    inf_s = time.perf_counter() - t0
    kept = int((det['scores'] > 0).sum())
    if not (bool(torch.isfinite(det['corners3d']).all()) and
            det['scores'].shape == (100,) and 0 < kept):
        raise RuntimeError(f'phase 13b: DD3D inference kept {kept}')
    print(f'phase 13b: DD3D (VoVNet V-99-eSE + FPN 5 x 256, strides 8-128) '
          f'on {item["image_path"].split("/")[-1]} ({img.shape[0]}x'
          f'{img.shape[1]}, decoded in {load_s:.3f} s, '
          f'{int(item["num_valid"])} GT boxes): forward + loss + backward '
          f'{" ".join(f"{t:.4f}" for t in times)} s (first with warm-up), '
          f'peak memory {peak / 2**30:.2f} GiB; losses {json.dumps(vals)}; '
          f'inference with NMS {inf_s:.4f} s, {kept} detections kept of '
          f'{mono.head.pre_nms_topk} candidates on {card}', flush=True)
    mono.train()
    return mono


def _phase13_v2(counted, card, check, dev, mono):
    """13a: BEVFormerV2 at the JAX defaults (embed 256, BEV 200x200, 900
    queries, R101 with DCN in stages 3-4, 6 encoder layers, num_fusion 3),
    frames (-1, 0), f32, bs 1, 6 cameras at 928x1600, 40 GT boxes of 128,
    random 0.02-scale weights: the eval forward and ``get_bboxes``, then a
    train step (forward, ``loss`` with ``mono``'s DD3D losses through the
    mono hook, backward, ``make_optimizer``'s AdamW over both models),
    each counted and its kernels held against their plain versions on the
    kept inputs; then the small-input check, card kernels vs the CPU's
    plain versions. -> {run: launches}."""
    from vidar_tpu_torch.core.builder import build_model
    from vidar_tpu_torch.data import (make_synthetic_batch,
                                      make_synthetic_det_batch)
    from vidar_tpu_torch.models import BEVFormerV2
    from vidar_tpu_torch.ops import dcn, msda
    from vidar_tpu_torch.train import make_optimizer

    runs = {}
    model = build_model(dict(type='BEVFormerV2', frames=(-1, 0)), device=dev)
    model.randomize_(torch.Generator(device=dev).manual_seed(13), 0.02)
    layers, q = 6, model.pts_bbox_head_det.num_query
    batch = make_synthetic_det_batch(
        np.random.default_rng(0), bs=1, queue_length=1, num_cams=6,
        img_h=928, img_w=1600, max_points=64, max_gt=128, num_gt=40,
        device=dev)
    frames = len(model.frames)
    # by the code: a frame's encode runs K1 in each layer's TSA and SCA,
    # the decoder K1 in each of its 6 layers, the backbone K9 in each
    # deformable block; the step's backward K5 for frame 0's attentions
    # only, and its camera-sequential backbone K9 once a camera forward
    # and once again in the recompute
    want = {'v2_eval': {msda.KERNEL.name: 2 * layers * frames + 6,
                        dcn.SAMPLE.name: R101_DCN_BLOCKS * frames,
                        msda.BACKWARD.name: 0},
            'v2_step': {msda.KERNEL.name: 2 * layers * frames + 6,
                        msda.BACKWARD.name: 2 * layers + 6,
                        dcn.SAMPLE.name: R101_DCN_BLOCKS * (1 + 2 * 6)}}

    def keepers(train):
        k = {msda.KERNEL.name: _Keeper(lambda a: _msda_case(a, 'v2_')),
             dcn.SAMPLE.name: _Keeper(
                 lambda a: f'v2_{_dcn_image_case(a)}')}
        if train:
            k[msda.BACKWARD.name] = _Keeper(lambda a: _msda_case(a, 'v2_'))
        return k

    def need(run, launches):
        runs[run] = launches
        got = {k: launches[k] for k in want[run]}
        off = [k.name for k in (dcn.KERNEL, dcn.SAMPLE16) if launches[k.name]]
        if got != want[run] or off:
            raise RuntimeError(f'phase 13a {run}: launches {got}, by the '
                               f'code {want[run]}; {off} launched off the '
                               f'path')

    def evaluate():
        with torch.inference_mode():
            preds = model(batch.frames, train=False)
            return preds, model.get_bboxes(preds)

    model.eval()
    kept = keepers(False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (preds, det), launches = _run_counted(counted, kept, evaluate)
    warm = time.perf_counter() - t0
    need('v2_eval', launches)
    if not (bool(torch.isfinite(preds['all_cls_scores']).all()) and
            bool(torch.isfinite(det['bboxes']).all()) and
            tuple(preds['all_cls_scores'].shape) == (6, 1, q, 10)):
        raise RuntimeError('phase 13a: non-finite or malformed V2 outputs')
    check('v2_eval', kept, launches)
    del preds, det
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        t0 = time.perf_counter()
        evaluate()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    print(f'phase 13a: BEVFormerV2 eval (f32, frames (-1, 0), 6 x 928x1600, '
          f'900 queries, 200x200 BEV, R101-DCN, 6 encoder layers, fusion 3 x '
          f'512): {warm:.3f} s with warm-up, then '
          f'{" ".join(f"{t:.4f}" for t in times)} s -> '
          f'{sum(times) / len(times):.4f} s/it, peak memory '
          f'{peak / 2**30:.2f} GiB on {card}', flush=True)

    both = torch.nn.ModuleDict(dict(v2=model, mono=mono))
    opt = make_optimizer(both, device=dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    model.train()

    def step():
        opt.zero_grad(set_to_none=True)
        preds = model(batch.frames, train=True, generator=gen)
        losses = model.loss(preds, batch.gt_bboxes, batch.gt_labels,
                            batch.num_valid_gt, mono.losses())
        sum(losses.values()).backward()
        norm = opt.step()
        return {k: float(v.detach()) for k, v in losses.items()}, float(norm)

    before = [p.detach().clone() for p in model.parameters()]
    kept = keepers(True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (losses, norm), launches = _run_counted(counted, kept, step)
    warm = time.perf_counter() - t0
    need('v2_step', launches)
    moved = sum(bool((p.detach() != b).any())
                for p, b in zip(model.parameters(), before))
    del before
    mono_keys = sorted(k for k in losses if k.endswith('_mono'))
    if not (all(np.isfinite(v) for v in losses.values()) and norm > 0 and
            moved and len(mono_keys) == 8):
        raise RuntimeError(f'phase 13a: step losses {losses}, norm {norm}, '
                           f'{moved} parameters moved')
    check('v2_step', kept, launches)
    times = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        losses, norm = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    print(f'phase 13a: BEVFormerV2 train step (frame 0 with gradient, its '
          f'backbone camera by camera; the DD3D mono losses {mono_keys} '
          f'through the hook x {model.mono_loss_weight}): {warm:.3f} s with '
          f'warm-up, then {" ".join(f"{t:.4f}" for t in times)} s -> '
          f'{sum(times) / len(times):.4f} s/it, peak memory '
          f'{peak / 2**30:.2f} GiB; {moved} of {len(list(model.parameters()))}'
          f' V2 parameters moved; grad_norm {norm:.5g}; losses '
          f'{json.dumps(losses)} on {card}', flush=True)
    del model, both, opt
    torch.cuda.empty_cache()

    # small input: card kernels vs the CPU's plain versions, same weights
    # and batch
    tiny = BEVFormerV2(**V2_TINY, device=dev).eval()
    _unit_scale_(tiny, torch.Generator(device=dev).manual_seed(15))
    tiny_cpu = BEVFormerV2(**V2_TINY, device='cpu').eval()
    tiny_cpu.load_state_dict({k: v.cpu() for k, v in
                              tiny.state_dict().items()})
    sb = make_synthetic_batch(np.random.default_rng(0), bs=1,
                              queue_length=1, future_length=0, num_cams=3,
                              img_h=64, img_w=64, max_points=64,
                              device='cpu')
    for k in counted:
        k.launches = 0
    sides = []
    for m, d in ((tiny, dev), (tiny_cpu, 'cpu')):
        with torch.inference_mode():
            sides.append(m(sb.to(d), train=False))
    if not (msda.KERNEL.launches and dcn.SAMPLE.launches):
        raise RuntimeError('phase 13a: the small V2 ran no K1 or K9')
    errs = {k: ((sides[0][k].cpu() - sides[1][k]).abs().max() /
                sides[1][k].abs().max()).item()
            for k in ('all_cls_scores', 'all_bbox_preds')}
    print(f'phase 13a: small input (V2 tiny, DCN in stages 3-4, 64x64, f32), '
          f'card vs CPU plain, max err / max|CPU|: {json.dumps(errs)}',
          flush=True)
    # f32 on both sides: sums in other orders through ~60 layers, the CPU
    # tests' 1e-3 against the JAX package
    if max(errs.values()) > 1e-3:
        raise RuntimeError('phase 13a: the small V2 disagrees with the CPU')
    return runs


def _phase13_internimage(counted, card, check, dev):
    """13c: InternImage-T (channels 64, depths (4, 4, 18, 4), groups (4, 8,
    16, 32)) on one frame's 6 images at 928x1600, 0.02-scale inputs'
    weights as ``_unit_scale_``: forward, backward (a sum of squares over
    its outputs), one ``make_layer_decay_optimizer`` step; DCNv3 runs K1
    and K5, once each a block, held against their plain versions at each
    stage's kept inputs; then ``dcnv3_core`` (the msda route) against
    ``dcnv3_core_plain`` at each stage's shape. -> {run: launches}."""
    from vidar_tpu_torch.models.internimage import InternImage
    from vidar_tpu_torch.ops import msda
    from vidar_tpu_torch.ops.dcnv3 import dcnv3_core, dcnv3_core_plain
    from vidar_tpu_torch.train import make_layer_decay_optimizer

    gen = torch.Generator(device=dev).manual_seed(16)
    net = torch.nn.ModuleDict(dict(img_backbone=InternImage(device=dev)))
    _unit_scale_(net, gen)
    blocks = sum(net.img_backbone.depths)
    opt = make_layer_decay_optimizer(net, device=dev)
    x = torch.randn(6, 928, 1600, 3, generator=gen, device=dev)

    def case(a):
        (h, w), = a['spatial_shapes']
        return f'dcnv3_{h}x{w}'

    def step():
        opt.zero_grad(set_to_none=True)
        outs = net.img_backbone(x)
        loss = sum((o.float() ** 2).mean() for o in outs)
        loss.backward()
        return float(loss), float(opt.step()), [tuple(o.shape) for o in outs]

    kept = {msda.KERNEL.name: _Keeper(case), msda.BACKWARD.name: _Keeper(case)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (loss, norm, shapes), launches = _run_counted(counted, kept, step)
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = (launches[msda.KERNEL.name], launches[msda.BACKWARD.name])
    if got != (blocks, blocks) or not (np.isfinite(loss) and norm > 0):
        raise RuntimeError(f'phase 13c: K1/K5 launches {got}, not '
                           f'{blocks} each; loss {loss}, norm {norm}')
    check('internimage', kept, launches)
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    st = time.perf_counter() - t0
    groups = {g['lr_mult'] for g in opt.param_groups}
    print(f'phase 13c: InternImage-T on 6 x 928x1600: outputs {shapes}; '
          f'forward + backward + layer-decay AdamW ({len(groups)} '
          f'multipliers) {warm:.3f} s with warm-up, then {st:.4f} s/it, '
          f'peak memory {peak / 2**30:.2f} GiB; DCNv3 K1 {got[0]} and K5 '
          f'{got[1]} launches ({blocks} blocks) on {card}', flush=True)
    del net, opt, x
    torch.cuda.empty_cache()

    # dcnv3_core's card route (K1, with its coordinate arithmetic) against
    # its plain gather at each stage's shape
    ch, hh, ww = 64, 232, 400
    for stage, g in enumerate((4, 8, 16, 32)):
        xs = torch.randn(6, hh, ww, ch, generator=gen, device=dev)
        off = torch.randn(6, hh, ww, g * 18, generator=gen, device=dev) * 2
        mk = torch.randn(6, hh, ww, g * 9, generator=gen, device=dev)
        keep = _Keeper(lambda a: 'x')
        msda.KERNEL.on_launch = keep
        got = dcnv3_core(xs, off, mk, groups=g)
        msda.KERNEL.on_launch = None
        want = dcnv3_core_plain(xs, off, mk, groups=g)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        ms = _time_ms(lambda: dcnv3_core(xs, off, mk, groups=g))
        plain_ms = _time_ms(lambda: dcnv3_core_plain(xs, off, mk, groups=g))
        bound_ms, by = _bound(*_cost(msda.KERNEL.name, keep.inputs['x'],
                                     _nbytes(got)))
        print(f'phase 13c: dcnv3_core stage {stage + 1} ({hh}x{ww}, C {ch}, '
              f'{g} groups x 9 points, 6 images): msda route {ms:.3f} ms, '
              f'plain {plain_ms:.3f} ms, K1 bound {bound_ms:.4f} ms ({by}); '
              f'max_abs_err {err:.3g} (max|plain| {scale:.4g}) on {card}',
              flush=True)
        # f32 sums in other orders and the (pixel + 0.5) / size round trip
        if not err <= 1e-4 * scale:
            raise RuntimeError(f'phase 13c: dcnv3_core stage {stage + 1} '
                               f'disagrees with its plain version')
        del xs, off, mk, got, want, keep
        ch, hh, ww = 2 * ch, -(-hh // 2), -(-ww // 2)
    return {'internimage': launches}


def _phase13_voxel(card, dev):
    """13d: the voxel renderer at ``vidar_base``'s grid: sigma [1, 3, 16,
    200, 200], 32,768 rays from 3 frame origins, ``max_steps`` 417:
    ``voxel_render_loss`` forward and backward, ``voxel_render_v2``; then a
    small-size check against the CPU."""
    from vidar_tpu_torch.ops import voxel_render as vr

    z, h, w = VOXEL_GRID
    rng = np.random.default_rng(17)

    def rays(n_rays, t, grid):
        zz, hh, ww = grid
        origin = np.array([[ww / 2, hh / 2, zz / 2]], np.float32) + \
            rng.uniform(-2, 2, (t, 3)).astype(np.float32)
        az = rng.uniform(-np.pi, np.pi, n_rays)
        el = rng.uniform(-0.15, 0.1, n_rays)
        length = rng.uniform(3, 0.7 * ww, n_rays)
        tindex = rng.integers(0, t, n_rays).astype(np.int32)
        tindex[::16] = -1                      # padding
        d = np.stack([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el),
                      np.sin(el)], -1)
        points = origin[np.maximum(tindex, 0)] + d * length[:, None]
        return (origin[None], points[None].astype(np.float32), tindex[None])

    origin, points, tindex = (torch.from_numpy(a).to(dev) for a in rays(
        VOXEL_RAYS, VOXEL_FRAMES, VOXEL_GRID))
    gen = torch.Generator(device=dev).manual_seed(18)
    sigma = (torch.rand(1, VOXEL_FRAMES, z, h, w, generator=gen,
                        device=dev) * 0.2).requires_grad_()
    regul = torch.rand(sigma.shape, generator=gen, device=dev)
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        sigma.grad = None
        t0 = time.perf_counter()
        pred, gt, per_ray = vr.voxel_render_loss(sigma, origin, points,
                                                 tindex, max_steps=VOXEL_STEPS)
        per_ray.sum().backward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    with torch.no_grad():
        v2 = vr.voxel_render_v2(sigma, origin, points, tindex, regul,
                                max_steps=VOXEL_STEPS)
        torch.cuda.synchronize()
    v2_s = time.perf_counter() - t0
    hit = int((gt > 0).sum())
    if not (bool(torch.isfinite(pred).all()) and hit > VOXEL_RAYS // 2 and
            bool(torch.isfinite(sigma.grad).all()) and
            float(sigma.grad.abs().sum()) > 0 and
            torch.equal(v2[0], pred.detach())):
        raise RuntimeError(f'phase 13d: voxel render: {hit} rays hit')
    print(f'phase 13d: voxel_render_loss (l1) at sigma {list(sigma.shape)}, '
          f'{VOXEL_RAYS} rays ({hit} hit the grid), max_steps {VOXEL_STEPS}: '
          f'forward + backward {" ".join(f"{t:.4f}" for t in times)} s (first'
          f' with warm-up), peak memory {peak / 2**30:.2f} GiB; '
          f'voxel_render_v2 {v2_s:.4f} s, ray_pred mean '
          f'{v2[2][v2[3] > 0].mean().item():.4f} on {card}', flush=True)
    del pred, gt, per_ray, v2, sigma, regul

    # small size: the card against the CPU, forward and d sigma
    small = [torch.from_numpy(a) for a in rays(64, 2, (4, 8, 8))]
    s_cpu = torch.from_numpy(rng.uniform(0, 0.6, (1, 2, 4, 8, 8)).astype(
        np.float32))
    sides = []
    for d in (dev, 'cpu'):
        s = s_cpu.to(d).requires_grad_()
        pred, _, per_ray = vr.voxel_render_loss(
            s, *(a.to(d) for a in small), max_steps=32)
        per_ray.sum().backward()
        sides.append((pred.detach().cpu(), s.grad.cpu()))
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(*sides)]
    print(f'phase 13d: small size (2 x 4x8x8, 64 rays), card vs CPU: pred '
          f'{errs[0]:.3g}, d sigma {errs[1]:.3g} of the largest', flush=True)
    if max(errs) > 1e-5:
        raise RuntimeError('phase 13d: the voxel renderer on the card '
                           'disagrees with the CPU')


def _phase13_viz(counted, card, tmp, data):
    """13e: the test CLI's ``--viz-pcd`` on the tiny forecast config (6
    cameras) on phase 9's fixture, ``tools.visualize detections`` on a
    ``--dump-viz`` pickle of the fine-tune config at test size and
    ``browse`` on the fixture; every PNG read back by ``_read_png``. ->
    {run: launches}."""
    from vidar_tpu_torch.tools import test as test_cli
    from vidar_tpu_torch.tools import visualize

    runs, t0 = {}, time.perf_counter()
    prefix = os.path.join(tmp, 'dbg', 'pred_pcd')
    tiny = [o for o in data if o.startswith('data.test')] + [
        'model.num_cams=6']
    _, runs['viz_forecast_cli'] = _cli_run(
        counted, card, 'test --viz-pcd (vidar_tiny)', test_cli.main,
        [str(TINY_CONFIG), '--max-samples', '1', '--viz-pcd', '--viz-path',
         prefix, '--cfg-options', *tiny])
    plots = sorted(p for p in os.listdir(os.path.dirname(prefix))
                   if p.startswith('pred_pcd_sample0_'))
    if not plots:
        raise RuntimeError('phase 13e: --viz-pcd wrote no plot')
    n = visualize.BEV_PIXELS
    pcd = [_png_check(os.path.join(tmp, 'dbg', p), (n, n), (
        visualize.PRED_COLOR, visualize.GT_PCD_COLOR)) for p in plots]
    dump = os.path.join(tmp, 'dump_viz.pkl')
    _, runs['viz_dump_cli'] = _cli_run(
        counted, card, 'test --dump-viz (fine-tune at test size)',
        test_cli.main, [str(FINETUNE_CONFIG), '--max-samples', '1',
                        '--dump-viz', dump, '--cfg-options', *data,
                        *FINETUNE_TINY])
    det_dir = os.path.join(tmp, 'viz_det')
    if visualize.main(['detections', dump, '--out-dir', det_dir,
                       '--num-samples', '1']) != 1:
        raise RuntimeError('phase 13e: detections rendered nothing')
    with open(dump, 'rb') as f:
        rec = pickle.load(f)['s0']
    cams, ih, iw = rec['images'].shape[:3]
    step = max(1, -(-iw // visualize.PANEL_WIDTH))
    grid = _png_check(os.path.join(det_dir, 's0.png'),
                      (4 * -(-ih // step), 3 * -(-iw // step)), ())
    bev = _png_check(os.path.join(det_dir, 's0_bev.png'), (n, n),
                     (visualize.GT_BOX_COLOR,))
    browse_dir = os.path.join(tmp, 'browse')
    if visualize.main(['browse', str(TINY_CONFIG), '--out-dir', browse_dir,
                       '--num-samples', '2', '--cfg-options',
                       *[o for o in data if o.startswith('data.train')]]
                      ) != 2:
        raise RuntimeError('phase 13e: browse rendered no sample')
    browse = [_png_check(os.path.join(browse_dir, f'sample{i}.png'), (n, n),
                         (visualize.PRED_COLOR,)) for i in range(2)]
    print(f'phase 13e: --viz-pcd wrote {len(plots)} plots ({n}x{n}; pred '
          f'and GT pixels {[list(c.values()) for c in pcd]}); the '
          f'detection render of a {cams}-camera {ih}x{iw} dump: grid '
          f'{grid}, BEV GT pixels {list(bev.values())}; browse: 2 plots '
          f'({[list(c.values()) for c in browse]} points); every PNG read '
          f'back by this script\'s decoder; {time.perf_counter() - t0:.1f} s',
          flush=True)
    return runs


def _phase13(counted, card, check, dev, fixture_dir, tables, data):
    """Phase 13: the BEVFormerV2 family, the voxel renderer and the
    visualisation tool (13a-e). ``check(run, keepers, launches)`` holds
    each kept K1, K5 and K9 input against its plain version. ->
    {run: launches}."""
    dev = torch.device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    spans = {}
    mono = _phase13_mono(card, dev, tables)
    spans['13b'] = time.perf_counter() - t0
    runs = _phase13_v2(counted, card, check, dev, mono)
    spans['13a'] = time.perf_counter() - t0 - sum(spans.values())
    del mono
    torch.cuda.empty_cache()
    runs.update(_phase13_internimage(counted, card, check, dev))
    spans['13c'] = time.perf_counter() - t0 - sum(spans.values())
    _phase13_voxel(card, dev)
    spans['13d'] = time.perf_counter() - t0 - sum(spans.values())
    runs.update(_phase13_viz(counted, card, fixture_dir, data))
    spans['13e'] = time.perf_counter() - t0 - sum(spans.values())
    print(f'phase 13: {time.perf_counter() - t0:.1f} s '
          f'({json.dumps({k: round(v, 1) for k, v in spans.items()})})',
          flush=True)
    return runs


# ------------------------------------ phase 14: the rest of the matrix

BEVFORMER_SMALL_CONFIG = ROOT / 'configs' / 'bevformer' / 'bevformer_small.py'
BEVFORMER_TINY_CONFIG = ROOT / 'configs' / 'bevformer' / 'bevformer_tiny.py'
FINETUNE_1FUTURE_CONFIG = (ROOT / 'configs' / 'vidar_finetune' /
                           'nusc_1_4_subset' / 'vidar_1_8_nusc_1future.py')
SUBMIT_CONFIG = (ROOT / 'configs' / 'vidar_pretrain' / 'OpenScene' /
                 'submit_vidar_OpenScene_mini_full_3future.py')
UNIAD_VIDAR_TRACK_MAP_CONFIG = (ROOT / 'configs' / 'uniad' /
                                'stage1_track_map' / 'vidar_track_map.py')
UNIAD_BASE_E2E_CONFIG = (ROOT / 'configs' / 'uniad' / 'stage2_e2e' /
                         'base_e2e.py')
# 14f: every loss term of the fine-tune's first step with cudnn's TF32
# switch on when the CLI starts within this of the same step with it off
# (relative). The CLIs turn it off for an f32 model; with TF32 in its
# convolutions a loss term moved by up to 5.9e-2 (ROADMAP.md §3)
TF32_LOSS_RTOL = 1e-2


def _phase14_tf32(run, data, tmp, dev):
    """14f: the released f32 fine-tune config through the train CLI, 2
    steps from one init checkpoint on the same batches (``--deterministic
    --seed 0``), with cudnn's TF32 switch on (PyTorch's default) and off
    as the CLI starts: each loss term, the gradient norm and the relative
    difference between the two runs' updates (all of them, and the
    largest of a parameter). Step 1 runs before any update, so its loss
    terms show the forward's numerics alone, and it raises where one
    differs by more than ``TF32_LOSS_RTOL``: the CLI computes an f32
    model's convolutions in f32 either way. Step 2 is printed, not held:
    the backward's f32 atomics sum in an order that changes from run to
    run, and Adam's first update turns a gradient that is rounding noise
    (an attention key bias) into a step of the learning rate, so two f32
    runs already differ there."""
    from vidar_tpu_torch.core.builder import build_model
    from vidar_tpu_torch.core.checkpoint import save_checkpoint
    from vidar_tpu_torch.core.config import load_config
    from vidar_tpu_torch.tools import train as train_cli

    # both runs load one init (the CLI's: seed 0)
    model = build_model(load_config(str(FINETUNE_CONFIG))['model'],
                        device=dev)
    model.init_weights_(torch.Generator(device=dev).manual_seed(0))
    init_dir = f'{tmp}/p14_tf32_init'
    save_checkpoint(init_dir, {'model': model, 'step': 0})
    init = {n: p.detach().cpu() for n, p in model.named_parameters()}
    tensors = len(model.state_dict())
    del model
    logs, updates = {}, {}
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        name = f'tf32_{"on" if tf32 else "off"}'
        work = f'{tmp}/p14_{name}'
        out = run(name, train_cli.main,
                  [str(FINETUNE_CONFIG), '--work-dir', work, '--load-from',
                   init_dir, '--max-steps', '2', '--deterministic', '--seed',
                   '0', '--cfg-options', *data, 'log_interval=1'])
        if out['loaded'] != tensors:
            raise RuntimeError(f'phase 14f: {out["loaded"]} tensors loaded '
                               f'of the init\'s {tensors}')
        _train_log(f'p14_{name}', out, 2)
        logs[tf32] = out['log']
        updates[tf32] = {n: p.detach().cpu() - init[n]
                         for n, p in out.pop('model').named_parameters()}
        del out
        shutil.rmtree(work)
        torch.cuda.empty_cache()
    shutil.rmtree(init_dir)
    torch.backends.cudnn.allow_tf32 = True
    worst = []
    for s, (on, off) in enumerate(zip(logs[True], logs[False])):
        terms = {k: abs(on[k] - off[k]) / max(abs(off[k]), 1e-12)
                 for k in off if 'loss' in k}
        worst.append(max(terms.values()))
        print(f'phase 14f step {s + 1}: the switch on vs off: ' + '; '.join(
            f'{k} {on[k]:.6g} vs {off[k]:.6g} (rel {terms[k]:.3g})'
            for k in sorted(terms)) + f'; grad_norm {on["grad_norm"]:.6g} '
            f'vs {off["grad_norm"]:.6g}', flush=True)
    rel = {n: ((updates[True][n] - u).abs().max() / u.abs().max()).item()
           for n, u in updates[False].items() if u.abs().max() > 0}
    name = max(rel, key=rel.get)
    total = math.sqrt(
        sum(float((updates[True][n] - u).square().sum())
            for n, u in updates[False].items()) /
        sum(float(u.square().sum()) for u in updates[False].values()))
    print(f'phase 14f: {len(rel)} parameters updated; the two runs\' '
          f'updates {total:.3g} apart relative to their norm, a parameter\'s '
          f'by at most {rel[name]:.3g} ({name}); the largest loss term '
          f'difference at step 1 {worst[0]:.3g} (limit {TF32_LOSS_RTOL}), '
          f'at step 2 {worst[1]:.3g}', flush=True)
    if worst[0] > TF32_LOSS_RTOL:
        raise RuntimeError(f'phase 14f: with cudnn\'s TF32 switch on a loss '
                           f'term moves by {worst[0]:.3g} of its f32 value')


def _phase14_submission(run, os_data, tmp):
    """14d: the OpenScene submission config through the test CLI on 2
    samples of phase 9's 8-camera fixture (5 history frames, the ego mask
    off, the config's ``_submission`` writer on): one depth file per future
    frame a sample, as many finite lines as that frame's rays in
    ``pred_dist``."""
    from vidar_tpu_torch.core.config import load_config
    from vidar_tpu_torch.tools import test as test_cli
    sub = f'{tmp}/p14_submission'
    rays = {}
    save = test_cli.save_submission

    def counting(pred_dist, frame_idx, sample_idx, out_dir):
        rays[sample_idx] = {int(f): int((frame_idx == f).sum())
                            for f in np.unique(frame_idx) if f > 0}
        return save(pred_dist, frame_idx, sample_idx, out_dir)

    test_cli.save_submission = counting
    try:
        metrics = run('submission', test_cli.main,
                      [str(SUBMIT_CONFIG), '--max-samples', '2',
                       '--cfg-options', *os_data,
                       f'model._submission_path={sub}'], keep=True)
    finally:
        test_cli.save_submission = save
    _finite_metrics('p14_submission', metrics, ('frame.6.chamfer_distance',))
    cfg = load_config(str(SUBMIT_CONFIG))
    futures = cfg['model']['test_future_frame_num']
    want = {f'sample{i}_{f}.txt' for i in range(2)
            for f in range(1, futures + 1)}
    if set(os.listdir(sub)) != want or sorted(rays) != ['sample0',
                                                        'sample1']:
        raise RuntimeError(f'phase 14d: submission files '
                           f'{sorted(os.listdir(sub))}')
    lines = {}
    for i in range(2):
        for f in range(1, futures + 1):
            vals = np.loadtxt(f'{sub}/sample{i}_{f}.txt', ndmin=1)
            lines[f'sample{i}_{f}'] = len(vals)
            if (len(vals) != rays[f'sample{i}'].get(f)
                    or not np.isfinite(vals).all()):
                raise RuntimeError(f'phase 14d: sample{i}_{f}.txt holds '
                                   f'{len(vals)} lines for '
                                   f'{rays[f"sample{i}"].get(f)} rays')
    print(f'phase 14d: {len(want)} depth files ({futures} future frames x '
          f'2 samples), lines = rays of pred_dist, all finite: '
          f'{json.dumps(lines)}; ego mask {cfg["data"]["test"]["ego_mask"]},'
          f' history {cfg["data"]["test"]["queue_length"]} frames',
          flush=True)
    shutil.rmtree(sub)


def _phase14(counted, card, check, tmp, data, os_data, fixture_pkl,
             dev='cuda:0'):
    """Phase 14: the released configs that no earlier phase runs, at their
    widths, through the CLIs on phase 9's fixtures with PyTorch's default
    numerics switches (a: ``bevformer_small.py`` 1 step and the detection
    eval of 1 sample; b: ``bevformer_tiny.py`` likewise, from init, with no
    DCN kernel; c: the 1-future fine-tune (grid step 1.0) 1 step; d: the
    OpenScene submission; e: ``vidar_track_map.py`` and ``base_e2e.py`` 1
    step each at a 2-frame clip; f: the fine-tune with cudnn's TF32 switch
    on against off as the CLI starts). Each run's wall time, s/it, peak
    memory and launches are printed; ``check(run, keepers, launches)``
    holds the kernels against their plain versions on the inputs of every
    run but ``base_e2e`` and f's. -> {run: launches}."""
    from vidar_tpu_torch.core.config import load_config
    from vidar_tpu_torch.ops import dcn, latent_render, msda
    from vidar_tpu_torch.tools import test as test_cli
    from vidar_tpu_torch.tools import train as train_cli

    dev = torch.device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    msda_k = [msda.KERNEL, msda.BACKWARD]
    render = [latent_render.FIRST_HIT, latent_render.AGGREGATE]
    render_bwd = [latent_render.FIRST_HIT_BACKWARD,
                  latent_render.AGGREGATE_BACKWARD]
    bf16 = [dcn.KERNEL, dcn.SAMPLE16]
    # each run's kernels that must launch and those that must not
    kernels = {
        'small_train': (msda_k + [dcn.SAMPLE], bf16 + render + render_bwd),
        'small_eval': ([msda.KERNEL, dcn.SAMPLE], bf16 + render),
        'tiny_train': (msda_k, bf16 + [dcn.SAMPLE] + render + render_bwd),
        'tiny_eval': ([msda.KERNEL], bf16 + [dcn.SAMPLE] + render),
        'ft_1future': (msda_k + [dcn.SAMPLE] + render + render_bwd, bf16),
        'submission': ([msda.KERNEL, dcn.SAMPLE] + render, bf16),
        'vidar_track_map': (msda_k + [dcn.SAMPLE] + render + render_bwd,
                            bf16),
        'base_e2e': (msda_k + [dcn.SAMPLE], bf16 + render + render_bwd),
        'tf32_on': (msda_k + [dcn.SAMPLE] + render + render_bwd, bf16),
        'tf32_off': (msda_k + [dcn.SAMPLE] + render + render_bwd, bf16),
    }
    runs, spans = {}, {}
    t0 = time.perf_counter()

    def run(name, fn, argv, keep=False, keepers=None):
        train = fn is train_cli.main
        if keep and keepers is None:
            keepers = _cli_keepers(f'p14_{name}', train)
        out, launches = _cli_run(counted, card, f'p14_{name}', fn, argv,
                                 keepers)
        runs[f'p14_{name}'] = launches
        _need(name, launches, *kernels[name], phase=14)
        if keepers is not None:
            t_check = time.perf_counter()
            check(f'p14_{name}', keepers, launches)
            print(f'p14_{name}: the kernel checks took '
                  f'{time.perf_counter() - t_check:.1f} s', flush=True)
        return out

    def span(label):
        spans[label] = time.perf_counter() - t0 - sum(spans.values())

    # a, b: BEVFormer-small and -tiny; their released load_from (an
    # FCOS3D and a torchvision R50 .pth) is not in the checkout, so the
    # train CLI trains from init
    opts = data + ['log_interval=1']
    for name, cfg_path in (('small', BEVFORMER_SMALL_CONFIG),
                           ('tiny', BEVFORMER_TINY_CONFIG)):
        work = f'{tmp}/p14_{name}'
        out = run(f'{name}_train', train_cli.main,
                  [str(cfg_path), '--work-dir', work, '--max-steps', '1',
                   '--cfg-options', *opts], keep=True)
        _train_log(f'p14_{name}_train', out, 1)
        if out['loaded'] or out['torch_import'] is not None:
            raise RuntimeError(f'phase 14 {name}: loaded {out["loaded"]} '
                               f'tensors, not trained from init')
        del out
        metrics = run(f'{name}_eval', test_cli.main,
                      [str(cfg_path), f'{work}/latest', '--max-samples', '1',
                       '--cfg-options', *data], keep=True)
        _finite_metrics(f'p14_{name}_eval', metrics, ('NDS', 'mAP'))
        m = load_config(str(cfg_path))['model']
        print(f'phase 14{"a" if name == "small" else "b"}: '
              f'{cfg_path.relative_to(ROOT)} (BEV {m["bev_h"]}x'
              f'{m["bev_w"]}, {m["encoder_num_layers"]} encoder layers, '
              f'R{m["backbone_depth"]}, DCN {m["backbone_dcn"]}) from init: '
              f'NDS {float(metrics["NDS"]):.4f}, mAP '
              f'{float(metrics["mAP"]):.4f}', flush=True)
        shutil.rmtree(work)
        span('14a' if name == 'small' else '14b')

    # c: the 1-future fine-tune, grid step 1.0
    out = run('ft_1future', train_cli.main,
              [str(FINETUNE_1FUTURE_CONFIG), '--work-dir',
               f'{tmp}/p14_ft_1future', '--max-steps', '1', '--cfg-options',
               *opts], keep=True)
    _train_log('p14_ft_1future', out, 1)
    del out
    shutil.rmtree(f'{tmp}/p14_ft_1future')
    span('14c')

    _phase14_submission(run, os_data, tmp)
    span('14d')

    # e: UniAD's track-map stage with latent rendering and the e2e stage
    # without, at a 2-frame clip, on phase 11's UniAD fixture
    pkl = _uniad_fixture(fixture_pkl, tmp)
    udata = [f'data.{s}.{k}={v}' for s in ('train', 'test')
             for k, v in (('ann_file', pkl), ('data_root', tmp))]
    udata += [f'data.train.queue_length={UNIAD_SHORT_CLIP - 1}',
              'log_interval=1']
    for name, cfg_path in (('vidar_track_map', UNIAD_VIDAR_TRACK_MAP_CONFIG),
                           ('base_e2e', UNIAD_BASE_E2E_CONFIG)):
        keepers = (_uniad_keepers(load_config(str(cfg_path))['model'],
                                  f'p14_{name}', train=True)
                   if name == 'vidar_track_map' else None)
        out = run(name, train_cli.main,
                  [str(cfg_path), '--work-dir', f'{tmp}/p14_{name}',
                   '--max-steps', '1', '--cfg-options', *udata],
                  keepers=keepers)
        _train_log(f'p14_{name}', out, 1)
        del out
        shutil.rmtree(f'{tmp}/p14_{name}')
    print(f'phase 14e: vidar_track_map.py and base_e2e.py at a '
          f'{UNIAD_SHORT_CLIP}-frame clip (depth cut: the configs\' 6 '
          f'frames run in phase 11a-b)', flush=True)
    span('14e')

    _phase14_tf32(run, data, tmp, dev)
    span('14f')
    print(f'phase 14: {time.perf_counter() - t0:.1f} s '
          f'({json.dumps({k: round(v, 1) for k, v in spans.items()})})',
          flush=True)
    return runs


# ------------------------------------- phase 10: data parallelism

# phase 10a's comparison of two ranks with one bs-2 process, as phase 5's
# small-input train check holds the card to the CPU: the bf16 model's
# losses to 2e-2 of each (the f32 fine-tune's to 1e-3, the CPU tests'
# tolerance against the JAX package), and the flattened gradients and
# updates at cosine 0.99, each gradient tensor (above 1e-3 of the largest)
# at 0.9. The two sides batch the same samples differently (convolution
# algorithms, sum orders) and the backward kernels' atomics reorder f32
# sums from run to run.
DP_LOSS_RTOL = {'pretrain': 2e-2, 'finetune': 1e-3}
DP_MIN_COSINE, DP_MIN_TENSOR_COSINE = 0.99, 0.9
# phase 10b: step 1's losses and the forecast eval's metrics through the
# CLIs on NCCL against the same runs without a process group; the f32
# forward kernels' relative tolerance (TOLERANCES['msda_forward'])
DP_CLI_RTOL = 1e-4
# a rank of phase 10 that has not ended in this time has hung
DP_RANK_TIMEOUT = 600


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _no_dropout_(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _take(batch, r):
    """Sample r of a batch dataclass, as a batch of one."""
    return type(batch)(**{
        f.name: (_take(v, r) if dataclasses.is_dataclass(v)
                 else v[r:r + 1].clone())
        for f in dataclasses.fields(batch)
        for v in (getattr(batch, f.name),)})


def _dp_inputs(dev):
    """Phase 10a's models and two-sample batches on ``dev``, the same in
    every process: ``vidar_base`` in bf16 with f32 parameters, phase 5's
    shapes and 0.02-scale weights, and the fine-tune at test size in f32
    with the small checks' unit-scale weights; no grid mask and no
    dropout, so that the draws of the two ranks and of one process agree.
    The forecast batch's sample 1 has a quarter of its 32768 GT points as
    padding, so the samples' counts of GT points and valid rays differ; the
    detection batch has 0 GT boxes in sample 0 and 40 in sample 1."""
    from vidar_tpu_torch.configs import vidar_base, vidar_finetune_tiny
    from vidar_tpu_torch.data import (make_synthetic_batch,
                                      make_synthetic_det_batch)
    from vidar_tpu_torch.models import BEVFormer, ViDAR
    model = ViDAR(**vidar_base(use_grid_mask=False), dtype=torch.bfloat16,
                  device=dev)
    model.randomize_(torch.Generator(device=dev).manual_seed(2), 0.02)
    batch = make_synthetic_batch(np.random.default_rng(0), bs=2,
                                 queue_length=4, future_length=3, num_cams=6,
                                 img_h=928, img_w=1600, max_points=32768,
                                 device=dev)
    tindex = batch.gt_tindex.clone()
    tindex[1, ::4] = -1
    batch.gt_tindex = tindex
    det = BEVFormer(**vidar_finetune_tiny(use_grid_mask=False), device=dev)
    _unit_scale_(det, torch.Generator(device=dev).manual_seed(5))
    det_batch = make_synthetic_det_batch(np.random.default_rng(0), bs=2,
                                         max_gt=64, num_gt=40, device=dev)
    det_batch.gt_bboxes[0] = 0.0
    det_batch.gt_labels[0] = 0
    det_batch.num_valid_gt[0] = 0
    return _no_dropout_(model), batch, _no_dropout_(det), det_batch


def _state_digest(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in model.state_dict().values():
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_run(model, batch, det, det_batch, dev, timed_steps):
    """One process's part of phase 10a (a rank, or the bs-2 reference):
    rank 0's weights broadcast (where a process group exists), a counted
    warm-up ``TrainStep`` whose metrics, summed gradients and update are
    kept (f32, on the host), ``timed_steps`` timed steps with the gradient
    all-reduce timed inside, the parameters' digest after each step, then
    one counted ``DetTrainStep`` of the small fine-tune, kept the same way.
    -> a dict of all that."""
    from vidar_tpu_torch.ops import dcn, latent_render, msda
    from vidar_tpu_torch.parallel import broadcast_parameters_
    from vidar_tpu_torch.train import (DetTrainStep, TrainStep,
                                       make_optimizer)
    counted = [msda.KERNEL, dcn.KERNEL, latent_render.FIRST_HIT,
               latent_render.AGGREGATE, msda.BACKWARD,
               latent_render.FIRST_HIT_BACKWARD,
               latent_render.AGGREGATE_BACKWARD, dcn.SAMPLE, dcn.SAMPLE16]

    def counted_step(fn, m, b):
        before = {n: p.detach().float().clone()
                  for n, p in m.named_parameters()}
        for k in counted:
            k.launches = 0
        metrics = fn(b)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in counted}
        grads = {n: (p.grad.float().cpu() if p.grad is not None else
                     torch.zeros(p.shape)) for n, p in m.named_parameters()}
        update = {n: (p.detach().float() - before[n]).cpu()
                  for n, p in m.named_parameters()}
        return dict(metrics=metrics, launches=launches, grads=grads,
                    update=update, digests=[_state_digest(m)])

    broadcast_parameters_(model)
    broadcast_parameters_(det)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = TrainStep(model, make_optimizer(model, device=dev), device=dev)
    reduce_s = []
    sum_gradients = step._sum_gradients

    def timed_sum_gradients():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sum_gradients()
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)

    step._sum_gradients = timed_sum_gradients
    out = dict(pretrain=counted_step(step, model, batch))
    times = []
    for _ in range(timed_steps):
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        out['pretrain']['digests'].append(_state_digest(model))
        if not all(np.isfinite(v) for v in metrics.values()):
            raise RuntimeError(f'phase 10a: non-finite metrics {metrics}')
    out['times'] = times
    out['reduce_s'] = reduce_s[1:]           # the timed steps'
    out['grad_bytes'] = sum(p.grad.numel() * p.grad.element_size()
                            for p in model.parameters()
                            if p.grad is not None)
    out['peak'] = torch.cuda.max_memory_allocated()
    dstep = DetTrainStep(det, make_optimizer(det, device=dev), device=dev)
    out['finetune'] = counted_step(dstep, det, det_batch)
    return out


def _phase10_rank(r, port, path):
    """Rank r of phase 10a, in a process of its own: joins the Gloo group
    of two ranks on the one card, takes sample r of phase 10a's batches,
    runs ``_dp_run`` and saves it to ``path`` (rank 1 without the host
    copies of the gradients and updates)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vidar_tpu_torch.parallel import (local_device,
                                          maybe_initialize_distributed,
                                          shutdown)
    import torch.distributed as dist
    maybe_initialize_distributed(f'127.0.0.1:{port}', 2, r, device='cuda',
                                 backend='gloo')
    try:
        dev = local_device('cuda')
        model, batch, det, det_batch = _dp_inputs(dev)
        batch, det_batch = _take(batch, r), _take(det_batch, r)
        out = _dp_run(model, batch, det, det_batch, dev, timed_steps=1)
        out['backend'], out['device'] = dist.get_backend(), str(dev)
        if r:
            for part in ('pretrain', 'finetune'):
                out[part].pop('grads')
                out[part].pop('update')
        torch.save(out, path)
    finally:
        shutdown()


def _join_ranks(procs, timeout=DP_RANK_TIMEOUT):
    """Wait for every rank process; one that fails or outlives ``timeout``
    ends them all (the others would wait for it in a collective), and
    raises."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f'phase 10: rank exit codes {codes}')


def _spawn_ranks(target, args_of_rank):
    import multiprocessing
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=target, args=args)
             for args in args_of_rank]
    for p in procs:
        p.start()
    _join_ranks(procs)


def _dp_compare(label, ref, got):
    """A two-rank step (rank 0's kept copy) against the bs-2 reference:
    losses, gradients and updates (cosines), grad_norm; raises beyond the
    phase's tolerances."""
    loss_err, cos, per_tensor = _grad_agreement(
        [({k: got['metrics'][k] for k in ref['metrics'] if k != 'grad_norm'
           and k != 'sca_overflow'}, got['grads']),
         ({k: ref['metrics'][k] for k in ref['metrics'] if k != 'grad_norm'
           and k != 'sca_overflow'}, ref['grads'])])
    flat = [torch.cat([u[n].reshape(-1) for n in ref['update']]).double()
            for u in (got['update'], ref['update'])]
    upd_cos = torch.nn.functional.cosine_similarity(*flat, 0).item()
    norm_err = (abs(got['metrics']['grad_norm'] - ref['metrics']['grad_norm'])
                / ref['metrics']['grad_norm'])
    worst = min(per_tensor, key=per_tensor.get)
    print(f'phase 10a {label}: two ranks vs one process at bs 2: losses '
          f'{json.dumps({k: [got["metrics"][k], ref["metrics"][k]] for k in ref["metrics"]})}; '
          f'max loss diff {loss_err:.3g} of each, grad_norm diff '
          f'{norm_err:.3g}; gradient cosine {cos:.6f} (flattened), min per '
          f'tensor {per_tensor[worst]:.4f} ({worst}); update cosine '
          f'{upd_cos:.6f}', flush=True)
    tol = DP_LOSS_RTOL[label]
    if (loss_err > tol or norm_err > tol or cos < DP_MIN_COSINE or
            per_tensor[worst] < DP_MIN_TENSOR_COSINE or
            upd_cos < DP_MIN_COSINE):
        raise RuntimeError(f'phase 10a {label}: the two ranks disagree with '
                           f'the one bs-2 process')


def _phase10a(card, tmp):
    """Two Gloo ranks on the one card against one process at bs 2 (run
    first, alone): -> {rank: {part: {kernel: launches}}}."""
    from vidar_tpu_torch.ops import dcn
    dev = torch.device('cuda:0')
    torch.cuda.empty_cache()
    print('phase 10a: one process at bs 2 (the reference), then two Gloo '
          'ranks of one sample each on cuda:0 (randomness off: no grid '
          'mask, no dropout, Gumbel argmax)', flush=True)
    t0 = time.perf_counter()
    model, batch, det, det_batch = _dp_inputs(dev)
    ref = _dp_run(model, batch, det, det_batch, dev, timed_steps=1)
    del model, batch, det, det_batch
    torch.cuda.empty_cache()
    print(f'phase 10a reference (bs 2, one process): step '
          f'{ref["times"][0]:.4f} s/it, peak memory '
          f'{ref["peak"] / 2**30:.2f} GiB, {time.perf_counter() - t0:.1f} s '
          f'in all, on {card}', flush=True)
    t0 = time.perf_counter()
    port = _free_port()
    paths = [f'{tmp}/dp_rank{r}.pt' for r in range(2)]
    _spawn_ranks(_phase10_rank, [(r, port, paths[r]) for r in range(2)])
    ranks = [torch.load(p, weights_only=False) for p in paths]
    print(f'phase 10a: the two ranks ran in {time.perf_counter() - t0:.1f} '
          f's (spawn, build load, setup, 2 + 1 steps)', flush=True)
    for part in ('pretrain', 'finetune'):
        a, b = (res[part] for res in ranks)
        if a['digests'] != b['digests'] or a['metrics'] != b['metrics']:
            raise RuntimeError(f'phase 10a {part}: the two ranks\' '
                               f'parameters or metrics differ')
        print(f'phase 10a {part}: the ranks\' parameters bit-identical after '
              f'each of {len(a["digests"])} steps', flush=True)
        _dp_compare(part, ref[part], ranks[0][part])
    need = [k for k in ranks[0]['pretrain']['launches']
            if k not in (dcn.SAMPLE.name, dcn.SAMPLE16.name)]
    for r, res in enumerate(ranks):
        print(f'phase 10a rank {r} ({res["backend"]} on {res["device"]}): '
              f'timed steps {" ".join(f"{t:.4f}" for t in res["times"])} '
              f's/it (two ranks share the card: not a speed), gradient '
              f'all-reduce {" ".join(f"{t:.4f}" for t in res["reduce_s"])} '
              f's a step for {res["grad_bytes"] / 2**20:.1f} MiB of f32 '
              f'gradients, peak memory {res["peak"] / 2**30:.2f} GiB; '
              f'launches {json.dumps(res["pretrain"]["launches"])}, '
              f'fine-tune step {json.dumps(res["finetune"]["launches"])} on '
              f'{card}', flush=True)
        if res['backend'] != 'gloo':
            raise RuntimeError(f'phase 10a rank {r}: backend '
                               f'{res["backend"]}')
        never = [k for k in need if res['pretrain']['launches'][k] <= 0]
        if never:
            raise RuntimeError(f'phase 10a rank {r}: kernels {never} never '
                               f'launched in the step')
        if (res['pretrain']['launches'][dcn.SAMPLE.name] or
                res['pretrain']['launches'][dcn.SAMPLE16.name]):
            raise RuntimeError('phase 10a: the bf16 step ran K9 or K10')
    return {r: {part: res[part]['launches'] for part in ('pretrain',
                                                         'finetune')}
            for r, res in enumerate(ranks)}


def _phase10b(card, tmp, data):
    """The train CLI (1 step) and the test CLI's forecast eval (2
    samples) on the released pre-training config with ``--coordinator
    --num-processes 1 --process-id 0`` (NCCL), against the same runs
    without a process group. Both evals read the single run's checkpoint.
    The train runs load one sample at a time (``--deterministic``): with
    the CLI's 4 loader threads the train split's augmentation draws from
    the dataset's one RNG in the threads' order. The evals load on the
    test CLI's 4 threads: the test split's point subsample (above
    ``max_points``) is drawn from (seed, frame index) alone."""
    import torch.distributed as dist
    from vidar_tpu_torch.tools import test as test_cli
    from vidar_tpu_torch.tools import train as train_cli
    opts = data + ['data.train.load_frame_interval=1', 'log_interval=1']
    backends = {}

    def probe(fn, name):
        def wrapped(args):
            backends[name] = (dist.get_backend() if dist.is_initialized()
                              else None)
            return fn(args)
        return wrapped

    train, evaluate = train_cli._train, test_cli._evaluate
    train_cli._train = probe(train, 'train')
    test_cli._evaluate = probe(evaluate, 'test')
    runs = {}
    try:
        for mode in ('single', 'nccl'):
            flags = [] if mode == 'single' else [
                '--num-processes', '1', '--process-id', '0', '--coordinator']
            t0 = time.perf_counter()
            out = train_cli.main(
                [str(PRETRAIN_CONFIG), '--work-dir', f'{tmp}/dp_{mode}',
                 '--max-steps', '1', '--deterministic',
                 *(flags + [f'127.0.0.1:{_free_port()}'] if flags else []),
                 '--cfg-options', *opts])
            metrics = test_cli.main(
                [str(PRETRAIN_CONFIG), f'{tmp}/dp_single/latest',
                 '--max-samples', '2',
                 *(flags + [f'127.0.0.1:{_free_port()}'] if flags else []),
                 '--cfg-options', *data])
            runs[mode] = (out['log'], metrics, dict(backends))
            print(f'phase 10b {mode}: backend during the train run '
                  f'{backends["train"]}, during the eval {backends["test"]};'
                  f' {time.perf_counter() - t0:.1f} s for 1 step and 2 '
                  f'eval samples on {card}', flush=True)
    finally:
        train_cli._train, test_cli._evaluate = train, evaluate
    (log_s, met_s, be_s), (log_n, met_n, be_n) = runs['single'], runs['nccl']
    keys = [k for k in log_s[0] if k.startswith('frame.') or k == 'loss']
    err = max(abs(log_n[0][k] - log_s[0][k]) / max(abs(log_s[0][k]), 1e-12)
              for k in keys)
    flat_s = {f'{f}.{k}': v for f, fv in met_s.items() for k, v in fv.items()}
    flat_n = {f'{f}.{k}': v for f, fv in met_n.items() for k, v in fv.items()}
    eval_err = max(abs(flat_n[k] - v) / max(abs(v), 1e-12)
                   for k, v in flat_s.items())
    print(f'phase 10b: NCCL at world size 1 vs no process group: step 1 '
          f'losses max rel diff {err:.3g}; forecast eval metrics (4 loader '
          f'threads) max rel diff {eval_err:.3g}; step 1 loss '
          f'{log_n[0]["loss"]:.6f} vs {log_s[0]["loss"]:.6f}', flush=True)
    if be_s != {'train': None, 'test': None} or be_n != {'train': 'nccl',
                                                         'test': 'nccl'}:
        raise RuntimeError(f'phase 10b: backends {be_s} and {be_n}')
    if err > DP_CLI_RTOL or eval_err > DP_CLI_RTOL or sorted(
            flat_s) != sorted(flat_n):
        raise RuntimeError('phase 10b: the NCCL run differs from the run '
                           'without a process group')


# phase 11c: a UniAD rank that runs out of device memory exits with this
# code, and the two ranks run again at one frame fewer
UNIAD_DP_OOM_EXIT = 75


def _phase11c_rank(r, port, path, frames):
    """Rank r of phase 11c, in a process of its own: joins the Gloo group
    of two ranks on the one card, builds ``vidar_e2e.py`` (f32, seed 0,
    dropout off, rank 0's weights broadcast), takes its own ``frames``-frame
    clip (rank 0: 40 agents and 8 map elements, rank 1: 24 and 3, other
    images), runs one counted ``UniADTrainStep`` (its warm-up included)
    with the gradient all-reduce timed inside, and saves the metrics,
    launches, time, gradient bytes, peak memory and the parameters' digest
    after the step to ``path``. Out of device memory it exits at once with
    ``UNIAD_DP_OOM_EXIT`` (the other rank, waiting in a collective, is
    ended by ``_join_ranks``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    from vidar_tpu_torch.core.builder import build_model
    from vidar_tpu_torch.core.config import load_config
    from vidar_tpu_torch.data import make_synthetic_batch
    from vidar_tpu_torch.ops import dcn, latent_render, msda
    from vidar_tpu_torch.parallel import (broadcast_parameters_,
                                          local_device,
                                          maybe_initialize_distributed,
                                          shutdown)
    from vidar_tpu_torch.train import UniADTrainStep, make_optimizer
    maybe_initialize_distributed(f'127.0.0.1:{port}', 2, r, device='cuda',
                                 backend='gloo')
    try:
        dev = local_device('cuda')
        mcfg = load_config(str(UNIAD_E2E_CONFIG))['model']
        model = _no_dropout_(build_model(mcfg, device=dev))
        model.init_weights_(torch.Generator(device=dev).manual_seed(0))
        broadcast_parameters_(model)
        model.train()
        ih, iw = UNIAD_IMAGE
        clip = make_synthetic_batch(np.random.default_rng(1 + r), bs=1,
                                    queue_length=frames - 1, future_length=1,
                                    num_cams=UNIAD_CAMS, img_h=ih, img_w=iw,
                                    max_points=64, device=dev)
        targets = _uniad_targets(np.random.default_rng(2 + r), frames, dev,
                                 model, num_gt=(40, 24)[r],
                                 map_gt=(8, 3)[r])
        command = torch.tensor([2], dtype=torch.int32, device=dev)
        step = UniADTrainStep(model, make_optimizer(model, device=dev),
                              task_loss_weight=mcfg['task_loss_weight'],
                              device=dev)
        reduce_s = []
        sum_gradients = step._sum_gradients

        def timed_sum_gradients():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sum_gradients()
            torch.cuda.synchronize()
            reduce_s.append(time.perf_counter() - t0)

        step._sum_gradients = timed_sum_gradients
        kernels = [msda.KERNEL, msda.BACKWARD, dcn.SAMPLE, dcn.KERNEL,
                   dcn.SAMPLE16, latent_render.FIRST_HIT,
                   latent_render.AGGREGATE, latent_render.FIRST_HIT_BACKWARD,
                   latent_render.AGGREGATE_BACKWARD]
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            metrics = step((clip, targets, command))
        except torch.cuda.OutOfMemoryError as e:
            print(f'phase 11c rank {r}: out of device memory at {frames} '
                  f'frames ({str(e).splitlines()[0][:120]})', flush=True)
            os._exit(UNIAD_DP_OOM_EXIT)
        torch.cuda.synchronize()
        out = dict(times=[time.perf_counter() - t0], reduce_s=reduce_s,
                   digests=[_state_digest(model)], metrics=[metrics],
                   launches={k.name: k.launches for k in kernels},
                   grad_bytes=sum(p.grad.numel() * p.grad.element_size()
                                  for p in model.parameters()
                                  if p.grad is not None),
                   peak=torch.cuda.max_memory_allocated(),
                   backend=dist.get_backend(), device=str(dev))
        torch.save(out, path)
    finally:
        shutdown()


def _phase11c(card, tmp, fixture_pkl):
    """UniAD across processes: two Gloo ranks of ``vidar_e2e.py`` on the one
    card, each with a clip of its own, at the config's clip or, where a
    rank runs out of device memory, one frame fewer each time (a depth
    cut, printed), their parameters bit-identical after the step; then
    the UniAD train (1 step of a 2-frame clip) and test CLIs (1 sample)
    on NCCL at world size 1; then, where the machine shows two
    cards, the train CLI at two NCCL ranks on them at the config's clip.
    -> {rank: {kernel: launches}} of the ranks' warm-up steps."""
    import multiprocessing
    import torch.distributed as dist
    from vidar_tpu_torch.core.config import load_config
    from vidar_tpu_torch.ops import dcn, latent_render, msda
    from vidar_tpu_torch.tools import test as test_cli
    from vidar_tpu_torch.tools import train as train_cli
    frames_cfg = load_config(str(UNIAD_E2E_CONFIG))['data']['train'][
        'queue_length'] + 1
    print(f'phase 11c: two Gloo ranks of UniAD '
          f'({UNIAD_E2E_CONFIG.relative_to(ROOT)}, f32, one clip each, '
          f'dropout off) on cuda:0', flush=True)
    torch.cuda.empty_cache()
    paths = [f'{tmp}/uniad_dp_rank{r}.pt' for r in range(2)]
    ctx = multiprocessing.get_context('spawn')
    for frames in range(frames_cfg, 0, -1):
        t0 = time.perf_counter()
        port = _free_port()
        procs = [ctx.Process(target=_phase11c_rank,
                             args=(r, port, paths[r], frames))
                 for r in range(2)]
        for p in procs:
            p.start()
        try:
            _join_ranks(procs)
            break
        except RuntimeError:
            if UNIAD_DP_OOM_EXIT not in [p.exitcode for p in procs]:
                raise
        print(f'phase 11c: two ranks out of device memory at {frames} '
              f'frames', flush=True)
    else:
        raise RuntimeError('phase 11c: two UniAD ranks fit on the card at '
                           'no clip length')
    cut = 'none, ' if frames == frames_cfg else ''
    print(f'phase 11c: depth cut: {cut}{frames} of the config\'s '
          f'{frames_cfg} frames a rank; the two ranks ran in '
          f'{time.perf_counter() - t0:.1f} s (spawn, build load, setup, 1 '
          f'step)', flush=True)
    ranks = [torch.load(p, weights_only=False) for p in paths]
    a, b = ranks
    if a['digests'] != b['digests'] or a['metrics'] != b['metrics']:
        raise RuntimeError('phase 11c: the two ranks\' parameters or metrics '
                           'differ')
    print(f'phase 11c: the ranks\' parameters bit-identical after the '
          f'step; the global batch\'s metrics '
          f'{json.dumps(a["metrics"][0])}', flush=True)
    need = [msda.KERNEL, msda.BACKWARD, dcn.SAMPLE, latent_render.FIRST_HIT,
            latent_render.AGGREGATE, latent_render.FIRST_HIT_BACKWARD,
            latent_render.AGGREGATE_BACKWARD]
    for r, res in enumerate(ranks):
        print(f'phase 11c rank {r} ({res["backend"]} on {res["device"]}): '
              f'step {res["times"][0]:.4f} s/it (with warm-up; two ranks '
              f'share the card: not a speed), '
              f'gradient all-reduce {" ".join(f"{t:.4f}" for t in res["reduce_s"])} '
              f's a step for {res["grad_bytes"] / 2**20:.1f} MiB of f32 '
              f'gradients, peak memory {res["peak"] / 2**30:.2f} GiB; '
              f'launches {json.dumps(res["launches"])} on {card}',
              flush=True)
        if res['backend'] != 'gloo':
            raise RuntimeError(f'phase 11c rank {r}: backend '
                               f'{res["backend"]}')
        if not all(np.isfinite(v) for m in res['metrics']
                   for v in m.values()):
            raise RuntimeError(f'phase 11c rank {r}: non-finite metrics')
        never = [k.name for k in need if res['launches'][k.name] <= 0]
        if never or res['launches'][dcn.KERNEL.name] or \
                res['launches'][dcn.SAMPLE16.name]:
            raise RuntimeError(f'phase 11c rank {r}: launches '
                               f'{res["launches"]}')
    launches = {r: res['launches'] for r, res in enumerate(ranks)}
    del ranks, a, b
    torch.cuda.empty_cache()

    # the CLIs on NCCL at world size 1
    pkl = _uniad_fixture(fixture_pkl, tmp)
    data = [f'data.{s}.{k}={v}' for s in ('train', 'test')
            for k, v in (('ann_file', pkl), ('data_root', tmp))]
    backends = {}

    def probe(fn, name):
        def wrapped(args):
            backends[name] = (dist.get_backend() if dist.is_initialized()
                              else None)
            return fn(args)
        return wrapped

    train, evaluate = train_cli._train, test_cli._evaluate
    train_cli._train = probe(train, 'train')
    test_cli._evaluate = probe(evaluate, 'test')
    work = f'{tmp}/uniad_nccl'
    flags = ['--num-processes', '1', '--process-id', '0', '--coordinator']
    try:
        t0 = time.perf_counter()
        out = train_cli.main([str(UNIAD_E2E_CONFIG), '--work-dir', work,
                              '--max-steps', '1', *flags,
                              f'127.0.0.1:{_free_port()}', '--cfg-options',
                              *data, 'log_interval=1',
                              'data.train.queue_length='
                              f'{UNIAD_SHORT_CLIP - 1}'])
        _train_log('uniad_nccl', out, 1)
        del out
        torch.cuda.empty_cache()
        metrics = test_cli.main([str(UNIAD_E2E_CONFIG), f'{work}/latest',
                                 '--max-samples', '1', *flags,
                                 f'127.0.0.1:{_free_port()}',
                                 '--cfg-options', *data])
    finally:
        train_cli._train, test_cli._evaluate = train, evaluate
    _finite_metrics('uniad_nccl_eval', metrics, UNIAD_KEYS)
    if backends != {'train': 'nccl', 'test': 'nccl'}:
        raise RuntimeError(f'phase 11c: backends {backends}')
    print(f'phase 11c: the UniAD train CLI (1 step of {UNIAD_SHORT_CLIP} '
          f'frames) and test CLI (1 sample) on NCCL at world size 1 in '
          f'{time.perf_counter() - t0:.1f} s; ' + ', '.join(
              f'{k} {float(metrics[k]):.4f}' for k in UNIAD_KEYS), flush=True)
    shutil.rmtree(work)
    torch.cuda.empty_cache()

    n = torch.cuda.device_count()
    if n < 2:
        print(f'phase 11c (two UniAD ranks on two cards over NCCL): not run, '
              f'the machine shows {n} card', flush=True)
    else:
        t0 = time.perf_counter()
        argv = [str(UNIAD_E2E_CONFIG), '--work-dir', f'{tmp}/uniad_two_cards',
                '--max-steps', '1', '--cfg-options', *data, 'log_interval=1']
        port = _free_port()
        _spawn_ranks(_phase10c_rank, [(r, port, argv) for r in range(2)])
        print(f'phase 11c: the UniAD train CLI at two ranks on cuda:0 and '
              f'cuda:1 over NCCL, 1 step of {frames_cfg} frames in '
              f'{time.perf_counter() - t0:.1f} s on {card}', flush=True)
    return launches


def _phase10c_rank(r, port, argv):
    from vidar_tpu_torch.tools import train as train_cli
    out = train_cli.main(argv + ['--coordinator', f'127.0.0.1:{port}',
                                 '--num-processes', '2', '--process-id',
                                 str(r)])
    if not all(np.isfinite(m['loss']) for m in out['log']):
        raise RuntimeError(f'phase 10c rank {r}: non-finite losses')


def _phase10c(card, tmp, data):
    """The train CLI at two ranks on two cards over NCCL, where the machine
    shows two cards."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f'phase 10c (two ranks on two cards over NCCL): not run, the '
              f'machine shows {n} card', flush=True)
        return
    t0 = time.perf_counter()
    argv = [str(PRETRAIN_CONFIG), '--work-dir', f'{tmp}/dp_two_cards',
            '--max-steps', '2', '--cfg-options', *data,
            'data.train.load_frame_interval=1', 'log_interval=1']
    port = _free_port()
    _spawn_ranks(_phase10c_rank, [(r, port, argv) for r in range(2)])
    print(f'phase 10c: the train CLI at two ranks on cuda:0 and cuda:1 '
          f'over NCCL, 2 steps in {time.perf_counter() - t0:.1f} s on '
          f'{card}', flush=True)


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
    # each phase's seconds, printed as it ends and all together at the end
    t_script = time.perf_counter()
    phase_s = {}

    def mark(label):
        phase_s[label] = round(time.perf_counter() - t_script -
                               sum(phase_s.values()), 1)
        print(f'phase {label}: {phase_s[label]} s (script '
              f'{time.perf_counter() - t_script:.1f} s)', flush=True)

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

    mark('0-1')

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

    mark('2')

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

    mark('3')

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

    mark('4')

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

    def compare_msda_backwards(kept, n):
        """K5 on every kept case -> [ok]."""
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
        return oks

    def compare_backwards(kept, render_case, n):
        """K5 on every kept case, K6/K7 and K8 on ``render_case`` -> [ok]."""
        oks = compare_msda_backwards(kept, n)
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

    # a timed step, then the forward alone as the step runs it (autograd
    # on, activations saved), its graph freed without a backward
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        metrics = step(tr_batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError('non-finite train metrics in the timed steps')
    fwd = []
    tr_model.train()
    for _ in range(TIMED_STEPS):
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

    mark('5')

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

    mark('6')

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

    # a timed step; then one with the host's Hungarian calls timed on
    # their own (a synchronisation before each)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMED_STEPS):
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

    mark('7')

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

    # -- phase 9: the train and test CLIs on the released configs at full
    # width, on a nuScenes-format fixture written here
    def check_cli(run, keepers, n):
        """Every kernel of a CLI run against its plain version on the f32
        inputs the run kept (K1 and K9 at each case, K3/K4 and, after a
        train run, K5 at each case and K6/K7 and K8), at the tolerances of
        phases 3-7; the comparisons run with cudnn's TF32 off, as there."""
        torch.backends.cudnn.allow_tf32 = False
        oks = []
        kept = keepers[msda.KERNEL.name].inputs
        for case, a in sorted(kept.items()):
            if a['value'].dtype != torch.float32:
                raise RuntimeError(f'{case}: K1 took {a["value"].dtype} '
                                   f'values on the f32 CLI path')
            oks.append(compare(
                msda.KERNEL, f'{case},float32', a,
                lambda a=a: msda.msda_forward_cuda(a['value'],
                                                   a['spatial_shapes'],
                                                   a['loc'], a['weights']),
                lambda a=a: msda.msdeform_attn_plain(a['value'],
                                                     a['spatial_shapes'],
                                                     a['loc'], a['weights']),
                n=n))
        for case, a in sorted(keepers[dcn.SAMPLE.name].inputs.items()):
            args = (a['x'], a['sx'], a['sy'], a['mask'])
            oks.append(compare_dcn_taps(
                dcn.SAMPLE, case, a,
                lambda args=args: dcn.dcn_sample_cuda(*args),
                lambda args=args: dcn.dcn_sample_plain(*args), n))
        # a model without latent rendering (BEVFormer, UniAD's base
        # stages) keeps no K3 input
        render = (f'{run}:encoder' in
                  keepers[latent_render.FIRST_HIT.name].inputs)
        if render:
            oks += compare_render(keepers, f'{run}:encoder', n)
        if msda.BACKWARD.name in keepers:
            oks += (compare_backwards(keepers, f'{run}:encoder', n)
                    if render else compare_msda_backwards(keepers, n))
        print(f'{run}: {len(oks)} kernel cases against their plain '
              f'versions on the CLI\'s own inputs, '
              f'{sum(oks)} within tolerance', flush=True)
        keepers.clear()
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = True
        if not all(oks):
            raise RuntimeError(f'{run}: a kernel disagrees with its plain '
                               f'version on the CLI path')

    def check_bf16(run, keepers, n):
        """Every kernel of a bf16 fine-tune run against its plain version on
        the bf16 inputs the run kept (K1 at each attention, the detection
        decoder's included, K2 at each ResNet call, K3/K4 and, after a
        train run, K5 at each attention and K6/K7 and K8), at the
        tolerances of phases 3-7, cudnn's TF32 off."""
        torch.backends.cudnn.allow_tf32 = False
        oks = []
        for case, a in sorted(keepers[msda.KERNEL.name].inputs.items()):
            if a['value'].dtype != torch.bfloat16:
                raise RuntimeError(f'{case}: K1 took {a["value"].dtype} '
                                   f'values on the bf16 path')
            oks.append(compare(
                msda.KERNEL, f'{case},bfloat16', a,
                lambda a=a: msda.msda_forward_cuda(a['value'],
                                                   a['spatial_shapes'],
                                                   a['loc'], a['weights']),
                lambda a=a: msda.msdeform_attn_plain(a['value'],
                                                     a['spatial_shapes'],
                                                     a['loc'], a['weights']),
                n=n))
        for case, a in sorted(keepers[dcn.KERNEL.name].inputs.items()):
            args = (a['x'], a['sx'], a['sy'], a['mask'], a['weight'])
            oks.append(compare(dcn.KERNEL, case, a,
                               lambda args=args: dcn.dcn_conv_cuda(*args),
                               lambda args=args: dcn.dcn_conv_plain(*args),
                               n=n))
        oks += compare_render(keepers, f'{run}:encoder', n)
        if msda.BACKWARD.name in keepers:
            oks += compare_backwards(keepers, f'{run}:encoder', n)
        print(f'{run}: {len(oks)} kernel cases against their plain '
              f'versions on the bf16 inputs, {sum(oks)} within tolerance',
              flush=True)
        keepers.clear()
        torch.cuda.empty_cache()
        if not all(oks):
            raise RuntimeError(f'{run}: a kernel disagrees with its plain '
                               f'version on the bf16 fine-tune')

    def check_v2(run, keepers, n):
        """Every kernel of a phase-13 run against its plain version on the
        f32 inputs the run kept: K1 at each attention (the V2 encoder's TSA
        and SCA, its detection decoder, InternImage's DCNv3 by stage), K9
        at each ResNet call, K5 at each case of a train run; at the
        tolerances of phases 3-7, cudnn's TF32 off."""
        torch.backends.cudnn.allow_tf32 = False
        oks = []
        for case, a in sorted(keepers[msda.KERNEL.name].inputs.items()):
            if a['value'].dtype != torch.float32:
                raise RuntimeError(f'{case}: K1 took {a["value"].dtype} '
                                   f'values on an f32 path')
            oks.append(compare(
                msda.KERNEL, f'{case},float32', a,
                lambda a=a: msda.msda_forward_cuda(a['value'],
                                                   a['spatial_shapes'],
                                                   a['loc'], a['weights']),
                lambda a=a: msda.msdeform_attn_plain(a['value'],
                                                     a['spatial_shapes'],
                                                     a['loc'], a['weights']),
                n=n))
        if dcn.SAMPLE.name in keepers:
            for case, a in sorted(keepers[dcn.SAMPLE.name].inputs.items()):
                args = (a['x'], a['sx'], a['sy'], a['mask'])
                oks.append(compare_dcn_taps(
                    dcn.SAMPLE, case, a,
                    lambda args=args: dcn.dcn_sample_cuda(*args),
                    lambda args=args: dcn.dcn_sample_plain(*args), n))
        if msda.BACKWARD.name in keepers:
            oks += compare_msda_backwards(keepers, n)
        print(f'{run}: {len(oks)} kernel cases against their plain '
              f'versions on the run\'s own inputs, {sum(oks)} within '
              f'tolerance', flush=True)
        keepers.clear()
        torch.cuda.empty_cache()
        if not all(oks):
            raise RuntimeError(f'{run}: a kernel disagrees with its plain '
                               f'version')

    mark('8')
    with tempfile.TemporaryDirectory() as fixture_dir:
        cli, data, os_data = _phase9(counted, card, check_cli, fixture_dir)
        fixture_pkl = data[0].split('=', 1)[1]
        mark('9')

        # -- phase 10: data parallelism across processes
        dp = _phase10a(card, fixture_dir)
        _phase10b(card, fixture_dir, data)
        _phase10c(card, fixture_dir, data)
        mark('10')

        # -- phase 11: UniAD, the library and the CLIs
        uniad = _phase11(counted, card, check_cli, fixture_dir, fixture_pkl)
        mark('11a-b')
        uniad_dp = _phase11c(card, fixture_dir, fixture_pkl)
        mark('11c')

        # -- phase 12: the data path from raw tables, the rest of the
        # fine-tune, the analysis tools and the video step
        later, tables = _phase12(counted, card, check_bf16, fixture_dir,
                                 forecast_s)
        mark('12')

        # -- phase 13: the BEVFormerV2 family, the voxel renderer and the
        # visualisation tool
        v2_runs = _phase13(counted, card, check_v2, dev, fixture_dir,
                           tables, data)
        mark('13')

        # -- phase 14: the released configs no earlier phase runs, and the
        # CLIs' TF32 against f32
        matrix = _phase14(counted, card, check_cli, fixture_dir, data,
                          os_data, fixture_pkl)
        mark('14')
    print(f'phase seconds: {json.dumps(phase_s)}; the script '
          f'{time.perf_counter() - t_script:.1f} s on {card}', flush=True)

    for r in results:
        base = r['name'].split('[')[0]
        r.setdefault('train_launches', train_launches[base])
        r['det_eval_launches'] = det_launches[base]
        r['det_train_launches'] = det_train_launches[base]
        r['all_dcn_launches'] = dcn_launches[base]
        for run, launches in cli.items():
            r[f'cli_{run}_launches'] = launches[base]
        for rank, parts in dp.items():
            r[f'dp_rank{rank}_launches'] = parts['pretrain'][base]
            r[f'dp_finetune_rank{rank}_launches'] = parts['finetune'][base]
        for rank, launches in uniad_dp.items():
            r[f'uniad_dp_rank{rank}_launches'] = launches[base]
        for run, launches in {**uniad, **later, **v2_runs,
                              **matrix}.items():
            r[f'{run}_launches'] = launches[base]
    print(json.dumps({'kernels': results}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--clip-memory']:
        sys.exit(clip_memory([int(n) for n in sys.argv[2:]] or [1, 2]))
    sys.exit(main())
