"""Dataset pkl tools (the reference's tools/*.py data utilities; port of
vidar_tpu/tools/data_tools.py, numpy only).

Capability matches:
  * merge_fullset_pkl       <- tools/merge_nusc_fullset_pkl.py:1-14
  * collect_nuplan_data     <- tools/collect_nuplan_data.py:1-28
  * convert_submission_pkl  <- tools/convert_nuplan_submission_pkl.py:1-48
  * validate_submission     <- tools/validate_hf_submission.py:48-68
  * kmeans_motion_anchors   <- generator for the k-means trajectory-anchor
    pickle UniAD loads (reference UniAD/.../motion_head_plugin/
    base_motion_head.py:33-45, ``anchor_info_path=
    'data/others/motion_anchor_infos_mode6.pkl'``; UniAD ships the pickle
    without its generator — this rebuilds it from any infos pkl).

Usage (subcommands ``merge-fullset``, ``collect-nuplan``,
``convert-submission``, ``validate-submission``, ``kmeans-anchors``):
    python -m vidar_tpu_torch.tools.data_tools kmeans-anchors INFOS OUT \
        [--num-modes 6] [--steps 12] [--seed 0]
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
from typing import List


def merge_fullset_pkl(train_pkl: str, test_pkl: str, out_pkl: str) -> None:
    """Merge train+test info pkls for fullset pretraining."""
    with open(train_pkl, 'rb') as f:
        train = pickle.load(f)
    with open(test_pkl, 'rb') as f:
        test = pickle.load(f)
    infos = list(train['infos']) + list(test['infos'])
    infos = sorted(infos, key=lambda e: e['timestamp'])
    out = dict(infos=infos, metadata=train.get('metadata'))
    with open(out_pkl, 'wb') as f:
        pickle.dump(out, f)
    print(f'merged {len(train["infos"])} + {len(test["infos"])} -> '
          f'{len(infos)} infos at {out_pkl}')


def collect_nuplan_data(pkl_dir: str, out_dir: str,
                        train_ratio: float = 0.85) -> None:
    """Merge per-log OpenScene pkls and split train/val by log."""
    files = sorted(glob.glob(os.path.join(pkl_dir, '*.pkl')))
    split = int(len(files) * train_ratio)
    os.makedirs(out_dir, exist_ok=True)
    for name, group in (('train', files[:split]), ('val', files[split:])):
        infos: List = []
        for p in group:
            with open(p, 'rb') as f:
                data = pickle.load(f)
            infos.extend(data['infos'] if isinstance(data, dict) else data)
        out = os.path.join(out_dir, f'nuplan_infos_{name}.pkl')
        with open(out, 'wb') as f:
            pickle.dump(dict(infos=infos), f)
        print(f'{name}: {len(group)} logs, {len(infos)} infos -> {out}')


def convert_submission_pkl(depth_dir: str, meta_pkl: str, out_pkl: str
                           ) -> None:
    """Pack per-frame depth txt dumps into a challenge submission pkl."""
    import numpy as np
    with open(meta_pkl, 'rb') as f:
        meta = pickle.load(f)
    results = {}
    for token in meta['tokens'] if 'tokens' in meta else []:
        frames = []
        for fidx in range(1, 7):
            path = os.path.join(depth_dir, f'{token}_{fidx}.txt')
            with open(path) as fh:
                frames.append(np.asarray([float(x) for x in fh], np.float32))
        results[token] = frames
    with open(out_pkl, 'wb') as f:
        pickle.dump(results, f)
    print(f'packed {len(results)} samples -> {out_pkl}')


def validate_submission(submission_pkl: str, meta_pkl: str) -> bool:
    """Shape/count contract checks against the private-test meta."""
    with open(submission_pkl, 'rb') as f:
        sub = pickle.load(f)
    with open(meta_pkl, 'rb') as f:
        meta = pickle.load(f)
    ok = True
    expected = meta.get('counts', {})
    for token, frames in sub.items():
        if len(frames) != 6:
            print(f'{token}: expected 6 future frames, got {len(frames)}')
            ok = False
        if token in expected:
            for i, fr in enumerate(frames):
                if len(fr) != expected[token][i]:
                    print(f'{token} frame {i}: count mismatch '
                          f'{len(fr)} vs {expected[token][i]}')
                    ok = False
    print('submission valid' if ok else 'submission INVALID')
    return ok


# nuScenes det-class grouping used by UniAD's MotionHead
# (``group_id_list=[[0,1,2,3,4],[6,7],[8],[5,9]]`` over the 10-class list):
# vehicles / bikes / pedestrian / static obstacles.
MOTION_CLASS_GROUPS = (
    ('car', 'truck', 'construction_vehicle', 'bus', 'trailer'),
    ('motorcycle', 'bicycle'),
    ('pedestrian',),
    ('barrier', 'traffic_cone'),
)


def _kmeans(x, k: int, seed: int = 0, iters: int = 50):
    """Plain Lloyd's k-means with kmeans++ seeding (numpy, deterministic).

    x: [N, D]. Returns [k, D] centroids. N >= 1; when N < k, centroids
    repeat samples (matching "use what data there is" semantics).
    """
    import numpy as np
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    if n <= k:
        reps = -(-k // n)
        return np.tile(x, (reps, 1))[:k].copy()
    # kmeans++ init
    centers = [x[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(
            ((x[:, None] - np.stack(centers)[None]) ** 2).sum(-1),
            axis=1).astype(np.float64)
        tot = d2.sum()
        if tot <= 0:            # all points identical to a center
            centers.append(x[rng.integers(n)])
            continue
        centers.append(x[rng.choice(n, p=d2 / tot)])
    c = np.stack(centers)
    for _ in range(iters):
        assign = ((x[:, None] - c[None]) ** 2).sum(-1).argmin(1)
        new_c = np.stack([
            x[assign == j].mean(0) if np.any(assign == j) else c[j]
            for j in range(k)])
        if np.allclose(new_c, c):
            break
        c = new_c
    return c


def kmeans_motion_anchors(infos_pkl: str, out_pkl: str, num_modes: int = 6,
                          steps: int = 12, seed: int = 0,
                          class_groups=MOTION_CLASS_GROUPS) -> dict:
    """Cluster agent-frame future gt trajectories into motion anchors.

    Rebuilds UniAD's ``motion_anchor_infos_mode6.pkl``: for every agent
    with ``steps`` future keyframes inside its scene, the future centers
    are expressed in the agent frame at t0 (translated to its center,
    rotated by -yaw — the same frame ``MotionHead`` consumes anchors in,
    see ``uniad/functional.anchor_coordinate_transform``), pooled per
    class group and k-means'd into ``num_modes`` [steps, 2] anchors.

    Output pickle: {'anchors_all': [np.float32 [num_modes, steps, 2]] per
    group} — the exact structure the reference loads
    (base_motion_head.py:41-44).
    """
    import numpy as np
    from ..data.geometry import quat_to_rot

    with open(infos_pkl, 'rb') as f:
        data = pickle.load(f)
    infos = data['infos'] if isinstance(data, dict) else data

    scenes = {}
    for info in infos:
        scenes.setdefault(info.get('scene_token', 's0'), []).append(info)
    for sc in scenes.values():
        sc.sort(key=lambda e: e['timestamp'])

    def global_pose(info):
        """(l2g rot [3,3], l2g t [3]) from the info's pose chain."""
        l2e_r = quat_to_rot(info['lidar2ego_rotation'])
        l2e_t = np.asarray(info['lidar2ego_translation'], np.float64)
        e2g_r = quat_to_rot(info['ego2global_rotation'])
        e2g_t = np.asarray(info['ego2global_translation'], np.float64)
        return e2g_r @ l2e_r, e2g_r @ l2e_t + e2g_t

    group_of = {}
    for gi, names in enumerate(class_groups):
        for nm in names:
            group_of[nm] = gi
    trajs = [[] for _ in class_groups]

    for sc in scenes.values():
        # per-frame instance -> (global xy, global yaw, group)
        frame_maps = []
        for info in sc:
            m = {}
            boxes = np.asarray(info.get('gt_boxes', np.zeros((0, 7))))
            names = info.get('gt_names', [])
            toks = info.get('gt_instance_tokens',
                            info.get('instance_inds', []))
            if len(boxes) and len(toks):
                rot, tr = global_pose(info)
                # yaw of the COMPOSED lidar->global rotation (summing the
                # yaws of chained 3D rotations is only exact for pure-z
                # chains; real rigs carry roll/pitch in lidar2ego)
                lidar_yaw = float(np.arctan2(rot[1, 0], rot[0, 0]))
                for b, nm, tk in zip(boxes, list(names), list(toks)):
                    gi = group_of.get(str(nm))
                    if gi is None:
                        continue
                    gxyz = rot @ np.array([b[0], b[1], b[2]]) + tr
                    m[tk] = (gxyz[:2], float(b[6]) + lidar_yaw, gi)
            frame_maps.append(m)
        for i, m0 in enumerate(frame_maps):
            if i + steps >= len(frame_maps):
                break
            for tk, (xy0, yaw0, gi) in m0.items():
                fut = []
                for t in range(1, steps + 1):
                    hit = frame_maps[i + t].get(tk)
                    if hit is None:
                        break
                    fut.append(hit[0] - xy0)
                if len(fut) < steps:
                    continue
                c, s = np.cos(-yaw0), np.sin(-yaw0)
                r = np.array([[c, -s], [s, c]])
                trajs[gi].append((np.stack(fut) @ r.T).astype(np.float32))

    anchors_all = []
    for gi, ts in enumerate(trajs):
        if not ts:
            # no agents of this group in the data: zero anchors (shape-
            # compatible; the model's per-group selection just sees rest)
            anchors_all.append(np.zeros((num_modes, steps, 2), np.float32))
            continue
        flat = np.stack(ts).reshape(len(ts), steps * 2)
        c = _kmeans(flat, num_modes, seed=seed + gi)
        anchors_all.append(c.reshape(num_modes, steps, 2)
                           .astype(np.float32))

    out = dict(anchors_all=anchors_all,
               meta=dict(num_modes=num_modes, steps=steps,
                         class_groups=[list(g) for g in class_groups],
                         counts=[len(t) for t in trajs],
                         source=os.path.basename(infos_pkl)))
    with open(out_pkl, 'wb') as f:
        pickle.dump(out, f)
    print(f'kmeans anchors: groups={[len(t) for t in trajs]} trajectories '
          f'-> {num_modes} modes x {steps} steps each at {out_pkl}')
    return out


def main(argv=None):
    """-> what the subcommand's function returns."""
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest='cmd', required=True)
    m = sub.add_parser('merge-fullset')
    m.add_argument('train_pkl')
    m.add_argument('test_pkl')
    m.add_argument('out_pkl')
    c = sub.add_parser('collect-nuplan')
    c.add_argument('pkl_dir')
    c.add_argument('out_dir')
    c.add_argument('--train-ratio', type=float, default=0.85)
    s = sub.add_parser('convert-submission')
    s.add_argument('depth_dir')
    s.add_argument('meta_pkl')
    s.add_argument('out_pkl')
    v = sub.add_parser('validate-submission')
    v.add_argument('submission_pkl')
    v.add_argument('meta_pkl')
    k = sub.add_parser('kmeans-anchors')
    k.add_argument('infos_pkl')
    k.add_argument('out_pkl')
    k.add_argument('--num-modes', type=int, default=6)
    k.add_argument('--steps', type=int, default=12)
    k.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)
    if args.cmd == 'merge-fullset':
        return merge_fullset_pkl(args.train_pkl, args.test_pkl, args.out_pkl)
    if args.cmd == 'collect-nuplan':
        return collect_nuplan_data(args.pkl_dir, args.out_dir,
                                   args.train_ratio)
    if args.cmd == 'convert-submission':
        return convert_submission_pkl(args.depth_dir, args.meta_pkl,
                                      args.out_pkl)
    if args.cmd == 'validate-submission':
        return validate_submission(args.submission_pkl, args.meta_pkl)
    return kmeans_motion_anchors(args.infos_pkl, args.out_pkl,
                                 num_modes=args.num_modes, steps=args.steps,
                                 seed=args.seed)


if __name__ == '__main__':
    main()
