"""Evaluation CLI of the port (vidar_tpu/tools/test.py, one process per
card).

Runs the forecast eval loop: history encode + future rollout + depth
decode through ``ForecastRunner``, chamfer / ray-error metrics per frame,
aggregated like the reference (SURVEY §3.3), with challenge submission
dumps (``--submission``, reference vidar.py:504-519) and BEV plots of the
predicted and GT point clouds (``--viz-pcd``). A ``BEVFormer``
config runs the detection eval instead: the full window, or ``--streaming``
frame by frame on the cached BEV, through ``DetectionRunner``, then NDS /
mAP. A ``UniAD`` config streams the tracker over each scene and reports
``amota``, ``amotp``, ``NDS``, ``minADE``, ``planning.L2`` and
``planning.obj_box_col`` among its metrics.

Usage:
  python -m vidar_tpu_torch.tools.test CONFIG [CHECKPOINT_DIR | PTH]
      [--cfg-options k.ey=value ...] [--max-samples N] [--out FILE]
      [--submission] [--viz-pcd [--viz-path PREFIX]] [--streaming]
      [--dump-viz PKL] [--device cpu]
      [--coordinator HOST:PORT --num-processes N --process-id R]

It runs on the card (``--device cuda``, the default) unless the caller asks
for the CPU. A model that computes in f32 has its convolutions computed in
f32 (cuDNN's TF32 off while it runs; ``device.use_f32_convolutions``).
``main(argv)`` returns the metrics, so a script can call it in the same
process.

Across N processes (the three flags or the ``VIDAR_*`` environment, as the
train CLI) the forecast eval splits the samples into N contiguous blocks,
one a rank, and gathers their per-frame metrics on rank 0, which alone
aggregates, prints and writes them; the other ranks return None. The
detection eval, window or streaming, runs whole in every process (as in
JAX: streaming needs the continuous video); rank 0 alone prints and writes.
So does UniAD's eval, whose tracker streams over each scene; its other
ranks return None.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import bbox as bbox_core
from ..core.builder import build_dataset, build_model
from ..core.checkpoint import import_torch_checkpoint, load_params_partial
from ..core.config import apply_overrides, load_config
from ..data.prefetch import PrefetchLoader
from ..data.samplers import contiguous_shard
from ..device import use_f32_convolutions
from ..evals.det_runner import CLASS_NAMES, DetectionRunner
from ..evals.detection import evaluate_detection
from ..evals.forecast_runner import ForecastRunner
from ..evals.metrics import aggregate_frame_metrics, forecast_metrics
from ..models import BEVFormer
from ..parallel import (add_distributed_args, is_main, local_device,
                        maybe_initialize_distributed, process_gather_objects,
                        rank, shutdown, world_size)
from .visualize import viz_forecast


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(
        description='Evaluate a ViDAR model (PyTorch, one process per GPU)')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None,
                   help='checkpoint directory of vidar_tpu_torch, or a '
                        'reference .pth')
    p.add_argument('--cfg-options', nargs='+', default=None)
    p.add_argument('--out', default=None, help='json file for metrics')
    p.add_argument('--max-samples', type=int, default=None)
    p.add_argument('--submission', action='store_true')
    p.add_argument('--submission-path', default='submission/model')
    p.add_argument('--viz-pcd', action='store_true',
                   help='forecast eval: write BEV plots of the predicted vs '
                        'GT point clouds of each sample and future frame')
    p.add_argument('--viz-path', default='dbg/pred_pcd',
                   help='the plots\' path prefix: '
                        '<viz-path>_sample<i>_<frame>.png')
    p.add_argument('--dump-viz', default=None, metavar='PKL',
                   help='detection eval: dump per-sample images/lidar2img/'
                        'pred/gt for tools.visualize detections')
    p.add_argument('--streaming', action='store_true',
                   help='video streaming eval: single-frame forward with a '
                        'cached prev BEV + ego-motion rebasing (reference '
                        'video_test_mode, bevformer.py:291-324)')
    p.add_argument('--device', default='cuda',
                   help='torch device (default cuda; cpu only on request)')
    add_distributed_args(p)
    return p.parse_args(argv)


def save_submission(pred_dist, frame_idx, sample_idx, out_dir):
    """Per-frame depth txt files (reference vidar.py:504-519 contract)."""
    os.makedirs(out_dir, exist_ok=True)
    for f in sorted(set(frame_idx.tolist())):
        if f <= 0:
            continue
        d = pred_dist[frame_idx == f]
        path = os.path.join(out_dir, f'{sample_idx}_{f}.txt')
        with open(path, 'w') as fh:
            for v in d:
                fh.write(f'{v:f}\n')


def load_model_weights(model, checkpoint: Optional[str]):
    """The eval's weights: ``init_weights_`` from seed 0, then the tensors
    of ``checkpoint`` (a directory of the port, or a reference ``.pth``
    through its key mapping) that the model shares -> (tensors loaded,
    tensors kept from init)."""
    dev = next(model.parameters()).device
    model.init_weights_(torch.Generator(device=dev).manual_seed(0))
    if not checkpoint:
        return 0, len(model.state_dict())
    if checkpoint.endswith('.pth'):
        n_ok = len(import_torch_checkpoint(checkpoint, model).matched)
        return n_ok, len(model.state_dict()) - n_ok
    n_ok, n_skip = load_params_partial(checkpoint, model)
    if is_main():
        print(f'checkpoint {checkpoint}: {n_ok} tensors loaded, {n_skip} '
              f'kept from init', flush=True)
    return n_ok, n_skip


def _samples(dataset, indices):
    """The samples of ``indices`` in order, decoded by 4 loader threads."""
    return iter(PrefetchLoader(dataset.__getitem__, indices, num_threads=4,
                               depth=8))


def det_eval(args, cfg, model, dataset, device):
    """Detection eval: full-window (or streaming) forward + NMS-free decode
    + NDS/mAP (reference §3.3 applied to the fine-tune model; nuScenes
    protocol via evals/detection.py)."""
    class_names = tuple(cfg['data']['test'].get('classes', CLASS_NAMES))
    runner = DetectionRunner(model, streaming=args.streaming, device=device,
                             class_names=class_names)
    n = min(len(dataset), args.max_samples or len(dataset))
    predictions, ground_truth, viz_dump = {}, {}, {}
    for i, batch in enumerate(_samples(dataset, range(n))):
        meta = dataset.streaming_meta(i) if args.streaming else None
        pred, gt = runner(batch, meta)
        predictions[f's{i}'] = pred
        gt['attrs'] = np.asarray(dataset.det_gt_attrs(i))[:len(gt['boxes'])]
        ground_truth[f's{i}'] = gt
        if args.dump_viz:
            # current-frame cameras, min-max rescaled for display (the
            # pipeline images are mean/std normalised)
            imgs = batch.frames.images[0, -1].numpy()
            lo, hi = imgs.min(), imgs.max()
            viz_dump[f's{i}'] = dict(
                images=(imgs - lo) / max(hi - lo, 1e-6),
                lidar2img=batch.frames.lidar2img[0, -1].numpy(),
                pred={k: pred[k] for k in ('boxes', 'scores', 'labels')},
                gt={k: gt[k] for k in ('boxes', 'labels')})
        if (i + 1) % 10 == 0 and is_main():
            print(f'[{i + 1}/{n}]', flush=True)

    metrics = evaluate_detection(predictions, ground_truth, class_names)
    if not is_main():
        return metrics
    if args.dump_viz:
        os.makedirs(os.path.dirname(args.dump_viz) or '.', exist_ok=True)
        with open(args.dump_viz, 'wb') as f:
            pickle.dump(viz_dump, f)
        print(f'viz dump: {args.dump_viz} ({len(viz_dump)} samples)')
    for k, v in metrics.items():
        print(f'{k}: {v:.4f}')
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(metrics, f, indent=2)
    return metrics


def uniad_eval(args, cfg, model, dataset, device):
    """UniAD's end-to-end eval (vidar_tpu/tools/test.py:179-309): the
    tracker and the previous BEV streamed over each scene (reset at a scene
    change), then AMOTA / AMOTP (reference nuscenes_e2e_dataset.py:
    1161-1181), NDS / mAP on the tracked boxes, motion minADE / minFDE / MR
    / EPA and planning L2 / collision. Across processes every rank runs
    the whole split (as JAX's eval does); rank 0 alone prints and writes,
    and the other ranks return None."""
    from ..evals.tracking import evaluate_tracking
    from ..uniad.loss import _track_assign
    from ..uniad.metrics import MotionMetric, PlanningMetric

    n = min(len(dataset), args.max_samples or len(dataset))
    classes = tuple(cfg['data']['test'].get('classes', CLASS_NAMES))
    predictions, ground_truth, det_preds, det_gt = {}, {}, {}, {}
    motion_m = MotionMetric()
    tp = cfg['model'].get('planning_steps', 6)
    plan_m = PlanningMetric(n_future=tp)
    filter_thresh = cfg['model'].get('filter_score_thresh', 0.35)
    tracks, prev_bev, cur_scene = None, None, None
    with torch.inference_mode():
        for i, (frames, targets, command) in enumerate(
                _samples(dataset, range(n))):
            scene = dataset.data_infos[dataset.usable_index[i]][
                'scene_token']
            exists = torch.full((1,), scene == cur_scene, device=device)
            if scene != cur_scene:
                tracks, prev_bev = model.init_stream(1, device)
                cur_scene = scene
            out = model(frames.to(device), tracks, prev_bev, exists,
                        command.to(device), deterministic=True)
            tracks, prev_bev = out['tracks'], out['bev']

            sel = ((tracks.obj_idxes[0] >= 0) &
                   (tracks.scores[0] >= filter_thresh)).cpu().numpy()
            boxes9 = bbox_core.denormalize_bbox(
                tracks.pred_boxes[0]).cpu().numpy()
            tok = f's{i}'
            predictions[tok] = dict(
                boxes=boxes9[sel], scores=tracks.scores[0].cpu().numpy()[sel],
                labels=tracks.pred_logits[0].argmax(-1).cpu().numpy()[sel],
                track_ids=tracks.obj_idxes[0].cpu().numpy()[sel])
            g = int(targets.num_valid_gt[0])
            gt_ids = (targets.track_ids[0, -1].numpy()[:g]
                      if targets.track_ids is not None else np.arange(g))
            ground_truth[tok] = dict(
                boxes=targets.gt_boxes[0].numpy()[:g],
                labels=targets.gt_labels[0].numpy()[:g],
                track_ids=gt_ids, scene=scene)
            det_preds[tok] = {k: predictions[tok][k]
                              for k in ('boxes', 'scores', 'labels')}
            det_gt[tok] = {k: ground_truth[tok][k]
                           for k in ('boxes', 'labels')}

            # motion: the agents aligned to gt by the Hungarian match
            t_dev = targets.to(device)
            assigned = _track_assign(
                tracks.pred_logits, tracks.pred_boxes,
                bbox_core.normalize_bbox(t_dev.gt_boxes), t_dev.gt_labels,
                t_dev.num_valid_gt)[0].cpu().numpy()
            motion = out['motion']
            trajs = motion['all_traj_preds'][-1][0, :-1, ..., :2]
            scores_m = motion['all_traj_scores'][-1][0, :-1]
            safe = np.clip(assigned, 0, targets.gt_traj.shape[1] - 1)
            motion_m.update(trajs.cpu().numpy(), scores_m.cpu().numpy(),
                            targets.gt_traj[0].numpy()[safe],
                            targets.gt_traj_valid[0].numpy()[safe],
                            agent_mask=(assigned >= 0).astype(np.float32))

            # planning: collisions against the gt occupancy, resampled
            # onto the metric's 200x200 grid
            seg = targets.gt_occ[0].numpy().max(axis=0)       # [To, H, W]
            t_occ, hh, ww = seg.shape
            seg_t = np.zeros((tp, 200, 200), np.float32)
            yi = (np.arange(200) * hh) // 200
            xi = (np.arange(200) * ww) // 200
            for t in range(min(tp, t_occ)):
                seg_t[t] = seg[t][yi][:, xi]
            plan_m.update(out['plan']['sdc_traj'][:, :tp].cpu().numpy(),
                          targets.sdc_traj[:, :tp, :2].numpy(),
                          targets.sdc_mask[:, :tp].numpy(), seg_t[None])
            if (i + 1) % 10 == 0 and is_main():
                print(f'[{i + 1}/{n}]', flush=True)

    metrics = dict(evaluate_tracking(predictions, ground_truth, classes))
    det = evaluate_detection(det_preds, det_gt, classes)
    metrics['NDS'] = det.get('NDS', 0.0)
    metrics['mAP'] = det.get('mAP', 0.0)
    metrics.update(motion_m.compute())
    plan = plan_m.compute()
    metrics['planning.L2'] = float(np.mean(plan['L2']))
    metrics['planning.obj_box_col'] = float(np.mean(plan['obj_box_col']))
    if not is_main():
        return None
    for k, v in metrics.items():
        print(f'{k}: {float(v):.4f}')
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f, indent=2)
    return metrics


def forecast_eval(model, dataset, indices: Sequence[int], num_future: int,
                  pc_range, device, *,
                  submission_path: Optional[str] = None,
                  viz_path: Optional[str] = None):
    """The samples of ``indices`` through ``ForecastRunner`` -> their
    per-frame metric dicts (``forecast_metrics``), each written as a
    submission where ``submission_path`` is given and plotted
    (``tools.visualize.viz_forecast``) where ``viz_path`` is."""
    runner, results = None, []
    n = len(indices)
    for j, (i, batch) in enumerate(zip(indices, _samples(dataset, indices))):
        if runner is None:
            runner = ForecastRunner(model, batch.images.shape[3:5],
                                    num_future=num_future, device=device)
        decode = runner(batch)
        results.append(forecast_metrics(decode, pc_range, num_future + 1,
                                        device))
        if submission_path:
            save_submission(decode['pred_dist'][0].cpu().numpy(),
                            decode['frame_idx'][0].cpu().numpy(),
                            f'sample{i}', submission_path)
        if viz_path:
            viz_forecast(decode, pc_range, viz_path, f'sample{i}')
        if is_main() and ((j + 1) % 10 == 0 or j + 1 == n):
            print(f'[{j + 1}/{n}]', flush=True)
    return results


def run_val_evaluation(cfg, model, max_samples=None, device='cuda'):
    """In-training validation pass (CustomDistEvalHook._do_evaluate
    equivalent, reference eval_hooks.py:53-90): runs the val split through
    the matching eval protocol and returns a metrics dict (with a
    ``key_score`` entry usable for save_best), or None when no val split is
    configured or its data is missing."""
    val_cfg = cfg.get('data', {}).get('val') or cfg.get('data', {}).get(
        'test')
    if not val_cfg:
        return None
    try:
        dataset = build_dataset(val_cfg)
    except (FileNotFoundError, OSError) as e:
        print(f'eval skipped: val data unavailable ({e})')
        return None
    n = min(len(dataset), max_samples or len(dataset))
    if n == 0:
        return None

    if isinstance(model, BEVFormer):
        class_names = tuple(val_cfg.get('classes', CLASS_NAMES))
        runner = DetectionRunner(model, device=device,
                                 class_names=class_names)
        predictions, ground_truth = {}, {}
        for i, batch in enumerate(_samples(dataset, range(n))):
            pred, ground_truth[f's{i}'] = runner(batch)
            # no attributes on either side, as vidar_tpu/tools/test.py:
            # 346-354
            predictions[f's{i}'] = {k: pred[k]
                                    for k in ('boxes', 'scores', 'labels')}
        metrics = evaluate_detection(predictions, ground_truth, class_names)
        metrics['key_score'] = metrics.get('NDS', 0.0)
        return metrics

    num_future = cfg['model'].get('test_future_frame_num', 6)
    results = forecast_eval(model, dataset, range(n), num_future,
                            cfg['model']['pc_range'], device)
    agg = aggregate_frame_metrics(results)
    flat = {f'{fk}.{k}': v for fk, fv in agg.items() for k, v in fv.items()}
    cds = [v for k, v in flat.items() if k.endswith('chamfer_distance')]
    flat['key_score'] = -float(np.mean(cds)) if cds else 0.0
    return flat


def main(argv: Optional[Sequence[str]] = None):
    """-> the metrics (None on a rank other than 0 of a forecast or UniAD
    eval). A process group that it joined, it leaves before it returns."""
    args = parse_args(argv)
    joined = maybe_initialize_distributed(
        args.coordinator, args.num_processes, args.process_id,
        device=args.device)
    tf32 = torch.backends.cudnn.allow_tf32    # an f32 model turns it off
    try:
        return _evaluate(args)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        if joined:
            shutdown()


def _evaluate(args):
    device = local_device(args.device)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    uniad = cfg['model'].get('type', 'ViDAR') == 'UniAD'
    model = build_model(cfg['model'], device=device)
    use_f32_convolutions(model)
    dataset = build_dataset(cfg['data']['test'])
    load_model_weights(model, args.checkpoint)
    model.eval()
    if uniad:
        return uniad_eval(args, cfg, model, dataset, device)
    if isinstance(model, BEVFormer):
        return det_eval(args, cfg, model, dataset, device)
    if cfg['model'].get('_submission'):
        args.submission = True
        args.submission_path = cfg['model'].get('_submission_path',
                                                args.submission_path)

    num_future = cfg['model'].get('test_future_frame_num', 6)
    n = min(len(dataset), args.max_samples or len(dataset))
    # contiguous blocks keep each rank's video continuous (reference
    # samplers/distributed_sampler.py:22-41); rank 0 gathers them in order
    results = forecast_eval(
        model, dataset, contiguous_shard(n, rank(), world_size()),
        num_future, cfg['model']['pc_range'], device,
        submission_path=args.submission_path if args.submission else None,
        viz_path=args.viz_path if args.viz_pcd else None)
    results = [m for part in process_gather_objects(results) for m in part]
    if not is_main():
        return None
    agg = aggregate_frame_metrics(results)
    for fk, fv in agg.items():
        print(f'==== {fk} results: ====')
        for k, v in fv.items():
            print(f'{k}: {v}')
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(agg, f, indent=2)
    return agg


if __name__ == '__main__':
    main()
