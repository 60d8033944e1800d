"""Auxiliary data converters (reference tools/data_converter + kitti2waymo;
port of vidar_tpu/tools/extra_converters.py, numpy and json only).

Compact devkit-free counterparts of the reference's mmdet3d-inherited
converters (SURVEY §2.6):

* :func:`create_groundtruth_database` —
  reference tools/data_converter/create_gt_database.py:100-338:
  crop per-gt-box lidar points from each frame into per-instance ``.bin``
  files + a db-infos pkl (the GT-sampling augmentation database). Unused by
  every released ViDAR config; provided for mmdet3d workflow parity.
* :func:`kitti2waymo` —
  reference projects/mmdet3d_plugin/core/evaluation/kitti2waymo.py:
  KITTI-format detection results -> Waymo submission records. The reference
  requires the ``waymo_open_dataset`` protos; where they are not installed
  the same records are pickled with identical field names, so the proto
  serialization is a drop-in swap.
* :func:`nuimage_to_coco` —
  reference tools/data_converter/nuimage_converter.py:63-235:
  nuImages raw JSON tables -> COCO-format annotation dict (bbox-only here;
  the reference additionally rasterizes segmentation masks).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# GT database (create_gt_database.py)
# ---------------------------------------------------------------------------

def points_in_rbbox(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """[N, >=3] points x [G, 7] (x y z w l h yaw, bottom-center) -> [N, G]
    bool membership (mmdet3d box_np_ops.points_in_rbbox equivalent)."""
    if len(boxes) == 0:
        return np.zeros((len(points), 0), bool)
    ctr = boxes[:, :3].copy()
    ctr[:, 2] += boxes[:, 5] / 2.0
    rel = points[:, None, :3] - ctr[None]
    c, s = np.cos(-boxes[:, 6]), np.sin(-boxes[:, 6])
    lx = rel[..., 0] * c - rel[..., 1] * s
    ly = rel[..., 0] * s + rel[..., 1] * c
    half = boxes[:, 3:6] / 2.0
    return ((np.abs(lx) <= half[:, 1]) & (np.abs(ly) <= half[:, 0]) &
            (np.abs(rel[..., 2]) <= half[:, 2]))


def create_groundtruth_database(ann_file: str, out_dir: str,
                                data_root: str = '',
                                db_name: str = 'nuscenes',
                                point_dims: int = 5) -> str:
    """Build ``{out_dir}/{db_name}_gt_database/*.bin`` + db-infos pkl."""
    with open(ann_file, 'rb') as f:
        data = pickle.load(f)
    infos = data['infos'] if isinstance(data, dict) else data
    db_dir = os.path.join(out_dir, f'{db_name}_gt_database')
    os.makedirs(db_dir, exist_ok=True)
    db_infos: Dict[str, List[dict]] = {}
    for idx, info in enumerate(infos):
        lp = info.get('lidar_path', '')
        if data_root and not os.path.isabs(lp):
            lp = os.path.join(data_root, lp)
        if not lp or not os.path.exists(lp):
            continue
        pts = np.fromfile(lp, np.float32).reshape(-1, point_dims)
        boxes = np.asarray(info.get('gt_boxes', np.zeros((0, 7))))
        names = info.get('gt_names', [])
        if not len(boxes):
            continue
        member = points_in_rbbox(pts, boxes)
        for gi in range(len(boxes)):
            name = str(names[gi]) if gi < len(names) else 'unknown'
            gpts = pts[member[:, gi]].copy()
            gpts[:, :3] -= boxes[gi, :3]  # store relative to box center
            fn = f'{idx}_{name}_{gi}.bin'
            gpts.astype(np.float32).tofile(os.path.join(db_dir, fn))
            db_infos.setdefault(name, []).append(dict(
                name=name, path=os.path.join(f'{db_name}_gt_database', fn),
                image_idx=idx, gt_idx=gi,
                box3d_lidar=boxes[gi].astype(np.float32),
                num_points_in_gt=int(member[:, gi].sum()),
                difficulty=0, group_id=idx * 1000 + gi))
    out_pkl = os.path.join(out_dir, f'{db_name}_dbinfos_train.pkl')
    with open(out_pkl, 'wb') as f:
        pickle.dump(db_infos, f)
    counts = {k: len(v) for k, v in db_infos.items()}
    print(f'gt database: {counts} -> {out_pkl}')
    return out_pkl


# ---------------------------------------------------------------------------
# KITTI -> Waymo submission (kitti2waymo.py)
# ---------------------------------------------------------------------------

KITTI2WAYMO_CLASS = {'Car': 1, 'Pedestrian': 2, 'Sign': 3, 'Cyclist': 4}


def kitti2waymo(kitti_results: Sequence[dict], out_file: str,
                prefix: str = '') -> str:
    """Convert KITTI-format results to Waymo ``Object`` records.

    Each entry of ``kitti_results``: dict(name [N], dimensions [N, 3]
    (l, h, w), location [N, 3] camera frame, rotation_y [N], score [N],
    sample_idx or context/timestamp fields). Records carry the exact Waymo
    proto field names; serialized with ``waymo_open_dataset`` when
    importable, pickled otherwise.
    """
    objects = []
    # KITTI camera frame -> Waymo vehicle frame (kitti2waymo.py T matrices):
    # x_w = z_c, y_w = -x_c, z_w = -y_c + height/2 shift handled per box
    for res in kitti_results:
        n = len(res.get('name', []))
        ctx = str(res.get('context_name', prefix))
        ts = int(res.get('timestamp_micros', res.get('sample_idx', 0)))
        for i in range(n):
            loc = np.asarray(res['location'][i], np.float64)
            dim = np.asarray(res['dimensions'][i], np.float64)  # l, h, w
            heading = -float(res['rotation_y'][i]) - np.pi / 2.0
            # normalize to [-pi, pi]
            heading = (heading + np.pi) % (2 * np.pi) - np.pi
            objects.append(dict(
                context_name=ctx,
                frame_timestamp_micros=ts,
                center_x=float(loc[2]),
                center_y=float(-loc[0]),
                center_z=float(-loc[1]) + float(dim[1]) / 2.0,
                length=float(dim[0]), width=float(dim[2]),
                height=float(dim[1]), heading=heading,
                score=float(res['score'][i]),
                type=KITTI2WAYMO_CLASS.get(str(res['name'][i]), 0)))
    try:  # the waymo protos, where installed
        from waymo_open_dataset.protos import metrics_pb2
        out = metrics_pb2.Objects()
        for o in objects:
            obj = out.objects.add()
            obj.context_name = o['context_name']
            obj.frame_timestamp_micros = o['frame_timestamp_micros']
            obj.score = o['score']
            box = obj.object.box
            box.center_x, box.center_y, box.center_z = (
                o['center_x'], o['center_y'], o['center_z'])
            box.length, box.width, box.height = (
                o['length'], o['width'], o['height'])
            box.heading = o['heading']
            obj.object.type = o['type']
        with open(out_file, 'wb') as f:
            f.write(out.SerializeToString())
    except ImportError:
        with open(out_file, 'wb') as f:
            pickle.dump(objects, f)
    print(f'kitti2waymo: {len(objects)} objects -> {out_file}')
    return out_file


# ---------------------------------------------------------------------------
# nuImages -> COCO (nuimage_converter.py)
# ---------------------------------------------------------------------------

NUIM_CLASSES = ('car', 'truck', 'trailer', 'bus', 'construction_vehicle',
                'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone',
                'barrier')

_NUIM_NAME_MAP = {
    'vehicle.car': 'car', 'vehicle.truck': 'truck',
    'vehicle.trailer': 'trailer', 'vehicle.bus.bendy': 'bus',
    'vehicle.bus.rigid': 'bus', 'vehicle.construction':
    'construction_vehicle', 'vehicle.bicycle': 'bicycle',
    'vehicle.motorcycle': 'motorcycle',
    'human.pedestrian.adult': 'pedestrian',
    'human.pedestrian.child': 'pedestrian',
    'human.pedestrian.construction_worker': 'pedestrian',
    'human.pedestrian.police_officer': 'pedestrian',
    'movable_object.trafficcone': 'traffic_cone',
    'movable_object.barrier': 'barrier'}


def nuimage_to_coco(nuimages_root: str, version: str, out_json: str) -> str:
    """Devkit-free nuImages -> COCO json (bbox annotations)."""
    tdir = os.path.join(nuimages_root, version)

    def table(name):
        with open(os.path.join(tdir, f'{name}.json')) as f:
            return json.load(f)

    sample_data = table('sample_data')
    object_ann = table('object_ann')
    category = {c['token']: c['name'] for c in table('category')}

    cat2id = {name: i for i, name in enumerate(NUIM_CLASSES)}
    images, annotations = [], []
    key_frames = {sd['token']: sd for sd in sample_data
                  if sd.get('is_key_frame', True)}
    img_id_of = {}
    for i, (tok, sd) in enumerate(sorted(key_frames.items())):
        img_id_of[tok] = i
        images.append(dict(id=i, token=tok, file_name=sd['filename'],
                           width=sd.get('width', 1600),
                           height=sd.get('height', 900)))
    aid = 0
    for ann in object_ann:
        tok = ann['sample_data_token']
        if tok not in img_id_of:
            continue
        raw = category.get(ann['category_token'], '')
        name = _NUIM_NAME_MAP.get(raw)
        if name is None:
            continue
        x1, y1, x2, y2 = ann['bbox']
        annotations.append(dict(
            id=aid, image_id=img_id_of[tok], category_id=cat2id[name],
            bbox=[x1, y1, x2 - x1, y2 - y1],
            area=float((x2 - x1) * (y2 - y1)), iscrowd=0))
        aid += 1
    coco = dict(
        images=images, annotations=annotations,
        categories=[dict(id=i, name=n) for n, i in cat2id.items()])
    os.makedirs(os.path.dirname(out_json) or '.', exist_ok=True)
    with open(out_json, 'w') as f:
        json.dump(coco, f)
    print(f'nuimage_to_coco: {len(images)} images, {len(annotations)} '
          f'annotations -> {out_json}')
    return out_json


def main(argv=None):
    """Subcommands ``create-gt-database`` and ``nuimage-to-coco``; -> the
    path written."""
    import argparse
    p = argparse.ArgumentParser('extra data converters')
    sub = p.add_subparsers(dest='cmd', required=True)
    g = sub.add_parser('create-gt-database')
    g.add_argument('ann_file')
    g.add_argument('out_dir')
    g.add_argument('--data-root', default='')
    n = sub.add_parser('nuimage-to-coco')
    n.add_argument('nuimages_root')
    n.add_argument('version')
    n.add_argument('out_json')
    args = p.parse_args(argv)
    if args.cmd == 'create-gt-database':
        return create_groundtruth_database(args.ann_file, args.out_dir,
                                           args.data_root)
    return nuimage_to_coco(args.nuimages_root, args.version, args.out_json)


if __name__ == '__main__':
    main()
