"""nuScenes raw tables -> ViDAR info pkls, without the nuscenes-devkit
(port of vidar_tpu/data/nuscenes_converter.py, numpy and json only).

Capability match for reference tools/create_data.py:52-90 +
tools/data_converter/nuscenes_converter.py:155-226: writes
``nuscenes_infos_temporal_{train,val,test}.pkl`` with the per-sample schema
the datasets read (token, scene/frame bookkeeping, lidar + 6-camera
calibration chains, sweeps, the lidar-frame GT boxes, and the 18-dim
can_bus vector [pos(3) quat(4) accel(3) rotation_rate(3) vel(3) pad(2)]
from the nuScenes CAN-bus expansion), read from the JSON tables sample,
sample_data, calibrated_sensor, ego_pose, sensor, scene (and, outside a
test version, sample_annotation, instance, category, attribute).

Usage:
    python -m vidar_tpu_torch.data.nuscenes_converter DATA_ROOT \
        [--out-dir DIR] [--version v1.0-trainval] [--canbus-root DIR] \
        [--max-sweeps 10]
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from .geometry import quat_to_rot

CAMERAS = ('CAM_FRONT', 'CAM_FRONT_RIGHT', 'CAM_FRONT_LEFT', 'CAM_BACK',
           'CAM_BACK_LEFT', 'CAM_BACK_RIGHT')

TRAINVAL_SPLIT_SCENES = None  # filled from splits file if provided

# nuScenes raw category -> 10-class detection name (the mmdet3d
# NuScenesDataset.NameMapping the reference converter applies at
# data_converter/nuscenes_converter.py:316-320).
NAME_MAPPING = {
    'movable_object.barrier': 'barrier',
    'vehicle.bicycle': 'bicycle',
    'vehicle.bus.bendy': 'bus',
    'vehicle.bus.rigid': 'bus',
    'vehicle.car': 'car',
    'vehicle.construction': 'construction_vehicle',
    'vehicle.motorcycle': 'motorcycle',
    'human.pedestrian.adult': 'pedestrian',
    'human.pedestrian.child': 'pedestrian',
    'human.pedestrian.construction_worker': 'pedestrian',
    'human.pedestrian.police_officer': 'pedestrian',
    'vehicle.trailer': 'trailer',
    'vehicle.truck': 'truck',
    'movable_object.trafficcone': 'traffic_cone',
}


def _quat_yaw(q: np.ndarray) -> float:
    """Yaw (z rotation) of quaternion [w, x, y, z]."""
    w, x, y, z = q
    return float(np.arctan2(2.0 * (w * z + x * y),
                            1.0 - 2.0 * (y * y + z * z)))


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _quat_inv(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


def _load_table(root: str, version: str, name: str) -> List[Dict]:
    with open(os.path.join(root, version, f'{name}.json')) as f:
        return json.load(f)


def _index(table: List[Dict], key: str = 'token') -> Dict[str, Dict]:
    return {row[key]: row for row in table}


class _CanBus:
    """Pose-record lookup from the CAN bus expansion (pose.json per scene)."""

    def __init__(self, canbus_root: Optional[str]):
        self.root = canbus_root
        self.cache: Dict[str, List[Dict]] = {}

    def get(self, scene_name: str, timestamp_us: int) -> np.ndarray:
        out = np.zeros(18, np.float64)
        if self.root is None:
            return out
        if scene_name not in self.cache:
            path = os.path.join(self.root, 'can_bus',
                                f'{scene_name}_pose.json')
            try:
                with open(path) as f:
                    self.cache[scene_name] = json.load(f)
            except FileNotFoundError:
                self.cache[scene_name] = []
        msgs = self.cache[scene_name]
        if not msgs:
            return out
        best = min(msgs, key=lambda m: abs(m['utime'] - timestamp_us))
        out[:3] = best.get('pos', [0, 0, 0])
        out[3:7] = best.get('orientation', [0, 0, 0, 0])
        out[7:10] = best.get('accel', [0, 0, 0])
        out[10:13] = best.get('rotation_rate', [0, 0, 0])
        out[13:16] = best.get('vel', [0, 0, 0])
        return out


def create_nuscenes_infos(data_root: str, out_dir: str,
                          version: str = 'v1.0-trainval',
                          canbus_root: Optional[str] = None,
                          max_sweeps: int = 10,
                          val_scene_names: Optional[List[str]] = None):
    """Build the temporal info pkls.

    ``val_scene_names``: scene names for the val split (defaults to the
    official split file if present at data_root/splits/val.txt, else a
    15% tail split by scene).
    """
    samples = _load_table(data_root, version, 'sample')
    sample_data = _load_table(data_root, version, 'sample_data')
    calib = _index(_load_table(data_root, version, 'calibrated_sensor'))
    ego_pose = _index(_load_table(data_root, version, 'ego_pose'))
    sensors = _index(_load_table(data_root, version, 'sensor'))
    scenes = _index(_load_table(data_root, version, 'scene'))

    canbus = _CanBus(canbus_root or data_root)

    # annotation tables (absent in test versions)
    is_test = 'test' in version
    anns_by_sample: Dict[str, List[Dict]] = {}
    ann_index: Dict[str, Dict] = {}
    inst_category: Dict[str, str] = {}
    sample_ts: Dict[str, int] = {s['token']: s['timestamp'] for s in samples}
    if not is_test:
        try:
            annotations = _load_table(data_root, version, 'sample_annotation')
            instances = _index(_load_table(data_root, version, 'instance'))
            categories = _index(_load_table(data_root, version, 'category'))
            try:
                attr_name = {a['token']: a['name'] for a in _load_table(
                    data_root, version, 'attribute')}
            except FileNotFoundError:
                attr_name = {}
            ann_index = _index(annotations)
            for inst_tok, inst in instances.items():
                inst_category[inst_tok] = categories[
                    inst['category_token']]['name']
            for a in annotations:
                anns_by_sample.setdefault(a['sample_token'], []).append(a)
        except FileNotFoundError:
            is_test = True

    def box_velocity(ann: Dict, max_time_diff: float = 1.5) -> np.ndarray:
        """Global-frame box velocity from neighbouring annotations (the
        devkit ``box_velocity`` contract the reference converter calls at
        nuscenes_converter.py:303-304)."""
        has_prev = bool(ann['prev'])
        has_next = bool(ann['next'])
        if not has_prev and not has_next:
            return np.full(3, np.nan)
        first = ann_index[ann['prev']] if has_prev else ann
        last = ann_index[ann['next']] if has_next else ann
        pos_diff = (np.asarray(last['translation']) -
                    np.asarray(first['translation']))
        time_diff = (sample_ts[last['sample_token']] -
                     sample_ts[first['sample_token']]) / 1e6
        if time_diff > max_time_diff or time_diff <= 0:
            return np.full(3, np.nan)
        return pos_diff / time_diff

    # sample_data grouped per sample for keyframes; per-channel chains for
    # sweeps
    sd_by_sample: Dict[str, Dict[str, Dict]] = {}
    sd_index = _index(sample_data)
    for sd in sample_data:
        if not sd['is_key_frame']:
            continue
        ch = sensors[calib[sd['calibrated_sensor_token']]
                     ['sensor_token']]['channel']
        sd_by_sample.setdefault(sd['sample_token'], {})[ch] = sd

    def pose_of(sd):
        return ego_pose[sd['ego_pose_token']]

    def calib_of(sd):
        return calib[sd['calibrated_sensor_token']]

    infos = []
    for sample in sorted(samples, key=lambda s: s['timestamp']):
        chans = sd_by_sample.get(sample['token'], {})
        if 'LIDAR_TOP' not in chans:
            continue
        lidar_sd = chans['LIDAR_TOP']
        lcal = calib_of(lidar_sd)
        lpose = pose_of(lidar_sd)
        scene = scenes[sample['scene_token']]

        cb = canbus.get(scene['name'], sample['timestamp'])

        info = dict(
            token=sample['token'],
            scene_token=sample['scene_token'],
            frame_idx=0,
            prev=sample['prev'],
            next=sample['next'],
            timestamp=sample['timestamp'],
            lidar_path=os.path.join(data_root, lidar_sd['filename']),
            lidar2ego_translation=lcal['translation'],
            lidar2ego_rotation=lcal['rotation'],
            ego2global_translation=lpose['translation'],
            ego2global_rotation=lpose['rotation'],
            can_bus=cb,
            cams={},
            sweeps=[],
        )

        # frame index within the scene
        # (filled in a second pass below)

        l2e_r = quat_to_rot(lcal['rotation'])
        l2e_t = np.asarray(lcal['translation'])
        e2g_r = quat_to_rot(lpose['rotation'])
        e2g_t = np.asarray(lpose['translation'])

        def to_lidar_frame(cs, ps):
            """sensor->lidar rotation/translation like the devkit converter."""
            s2e_r = quat_to_rot(cs['rotation'])
            s2e_t = np.asarray(cs['translation'])
            se2g_r = quat_to_rot(ps['rotation'])
            se2g_t = np.asarray(ps['translation'])
            r = (l2e_r.T @ e2g_r.T @ se2g_r @ s2e_r).T
            t = (s2e_t @ se2g_r.T + se2g_t) @ (e2g_r @ l2e_r)
            t -= (e2g_t @ (e2g_r @ l2e_r) + l2e_t @ l2e_r)
            return r.T, t

        for cam in CAMERAS:
            if cam not in chans:
                continue
            sd = chans[cam]
            cs = calib_of(sd)
            ps = pose_of(sd)
            r, t = to_lidar_frame(cs, ps)
            info['cams'][cam] = dict(
                data_path=os.path.join(data_root, sd['filename']),
                type=cam,
                sample_data_token=sd['token'],
                sensor2lidar_rotation=r,
                sensor2lidar_translation=t,
                cam_intrinsic=np.asarray(cs['camera_intrinsic']),
                timestamp=sd['timestamp'],
            )

        # sweeps: walk the lidar sample_data chain backwards
        sweeps = []
        sd_cur = lidar_sd
        while len(sweeps) < max_sweeps and sd_cur['prev']:
            sd_cur = sd_index[sd_cur['prev']]
            cs = calib_of(sd_cur)
            ps = pose_of(sd_cur)
            r, t = to_lidar_frame(cs, ps)
            sweeps.append(dict(
                data_path=os.path.join(data_root, sd_cur['filename']),
                sample_data_token=sd_cur['token'],
                sensor2lidar_rotation=r,
                sensor2lidar_translation=t,
                timestamp=sd_cur['timestamp'],
            ))
        info['sweeps'] = sweeps

        # gt annotations in the lidar frame (reference
        # data_converter/nuscenes_converter.py:294-332, devkit-free)
        if not is_test:
            anns = anns_by_sample.get(sample['token'], [])
            locs, dims, rots, names, vels = [], [], [], [], []
            nlp, nrp = [], []
            lq = np.asarray(lcal['rotation'], np.float64)
            eq = np.asarray(lpose['rotation'], np.float64)
            for a in anns:
                # global -> ego -> lidar (what nusc.get_sample_data does)
                c = np.asarray(a['translation'], np.float64)
                c = e2g_r.T @ (c - e2g_t)
                c = l2e_r.T @ (c - l2e_t)
                q = _quat_mul(_quat_inv(lq),
                              _quat_mul(_quat_inv(eq),
                                        np.asarray(a['rotation'],
                                                   np.float64)))
                locs.append(c)
                dims.append(a['size'])  # w, l, h
                rots.append(_quat_yaw(q))
                raw = inst_category.get(a['instance_token'], 'unknown')
                names.append(NAME_MAPPING.get(raw, raw))
                v = box_velocity(a)[:3]
                # global velocity -> lidar frame (converter :309-314)
                v = v @ np.linalg.inv(e2g_r).T @ np.linalg.inv(l2e_r).T
                vels.append(v[:2])
                nlp.append(a['num_lidar_pts'])
                nrp.append(a['num_radar_pts'])
            n = len(anns)
            locs = np.asarray(locs, np.float64).reshape(n, 3)
            dims = np.asarray(dims, np.float64).reshape(n, 3)
            rots = np.asarray(rots, np.float64).reshape(n, 1)
            # SECOND yaw convention (converter :322)
            info['gt_boxes'] = np.concatenate(
                [locs, dims, -rots - np.pi / 2], axis=1)
            info['gt_names'] = np.asarray(names)
            # attribute names for devkit-protocol mAAE ('' when the
            # annotation carries none — cones/barriers)
            info['gt_attrs'] = np.asarray([
                attr_name.get(a['attribute_tokens'][0], '')
                if a.get('attribute_tokens') else ''
                for a in anns])
            # instance identity for tracking/motion gt (UniAD training)
            info['gt_instance_tokens'] = np.asarray(
                [a['instance_token'] for a in anns])
            info['gt_velocity'] = np.asarray(vels, np.float64).reshape(n, 2)
            info['num_lidar_pts'] = np.asarray(nlp, np.int64)
            info['num_radar_pts'] = np.asarray(nrp, np.int64)
            info['valid_flag'] = (np.asarray(nlp) + np.asarray(nrp)) > 0

        infos.append(info)

    # frame_idx within scene
    counts: Dict[str, int] = {}
    for info in infos:
        st = info['scene_token']
        info['frame_idx'] = counts.get(st, 0)
        counts[st] = info['frame_idx'] + 1

    # split by scene
    if val_scene_names is None:
        split_file = os.path.join(data_root, 'splits', 'val.txt')
        if os.path.exists(split_file):
            with open(split_file) as f:
                val_scene_names = [l.strip() for l in f if l.strip()]
        else:
            names = sorted({scenes[i['scene_token']]['name'] for i in infos})
            val_scene_names = names[int(len(names) * 0.85):]
    val_set = set(val_scene_names)

    os.makedirs(out_dir, exist_ok=True)
    if 'test' in version:
        with open(os.path.join(out_dir,
                               'nuscenes_infos_temporal_test.pkl'),
                  'wb') as f:
            pickle.dump(dict(infos=infos,
                             metadata=dict(version=version)), f)
        print(f'test: {len(infos)} infos')
        return

    train = [i for i in infos
             if scenes[i['scene_token']]['name'] not in val_set]
    val = [i for i in infos if scenes[i['scene_token']]['name'] in val_set]
    for name, part in (('train', train), ('val', val)):
        path = os.path.join(out_dir, f'nuscenes_infos_temporal_{name}.pkl')
        with open(path, 'wb') as f:
            pickle.dump(dict(infos=part, metadata=dict(version=version)), f)
        print(f'{name}: {len(part)} infos -> {path}')


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description='create nuScenes ViDAR info pkls')
    p.add_argument('data_root')
    p.add_argument('--out-dir', default=None)
    p.add_argument('--version', default='v1.0-trainval')
    p.add_argument('--canbus-root', default=None)
    p.add_argument('--max-sweeps', type=int, default=10)
    args = p.parse_args(argv)
    create_nuscenes_infos(args.data_root, args.out_dir or args.data_root,
                          version=args.version, canbus_root=args.canbus_root,
                          max_sweeps=args.max_sweeps)


if __name__ == '__main__':
    main()
