"""Devkit-free nuScenes map-expansion converter for UniAD map supervision
(port of vidar_tpu/tools/map_converter.py, numpy and json only).

The reference derives its panoptic-seg map ground truth from the nuScenes
map expansion through the devkit (UniAD uniad_create_data pipeline). This
tool parses ``maps/expansion/<location>.json`` directly and emits a
``map_ann_file`` pkl that ``vidar_tpu_torch.data.uniad_data.UniADDataset``
reads:

    {sample_token: {'boxes': [N, 4] cxcywh in [0, 1] (pc_range frame),
                    'labels': [N] int32,
                    'polylines': list of [P, 2] float32 (normalised to the
                        pc_range box; closed elements keep the full ring and
                        may exceed [0, 1] — the fill clips),
                    'closed': [N] bool — ring elements (crossings/boundaries)
                        vs open dividers; drives filled-polygon vs stroke
                        rasterization in data.uniad_data}}

Classes (the reference's three "thing" classes for PansegformerHead):
    0 divider       road_divider + lane_divider lines
    1 ped_crossing  ped_crossing polygons
    2 boundary      road_segment polygon exteriors

Usage:
    python -m vidar_tpu_torch.tools.map_converter \
        --data-root data/nuscenes --version v1.0-trainval \
        --infos data/nuscenes/nuscenes_infos_temporal_train.pkl \
        --out data/nuscenes/nuscenes_map_anns_train.pkl
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Dict, List, Sequence

import numpy as np

from ..data.geometry import transform_matrix

CLASSES = ('divider', 'ped_crossing', 'boundary')


def load_map_elements(map_json_path: str) -> Dict[str, List[np.ndarray]]:
    """Parse one expansion json into per-class lists of [N, 2] polylines."""
    with open(map_json_path) as f:
        m = json.load(f)
    nodes = {n['token']: (n['x'], n['y']) for n in m.get('node', [])}
    lines = {l['token']: [nodes[t] for t in l['node_tokens']]
             for l in m.get('line', [])}
    polys = {p['token']: [nodes[t] for t in p['exterior_node_tokens']]
             for p in m.get('polygon', [])}

    out: Dict[str, List[np.ndarray]] = {c: [] for c in CLASSES}
    for rec in (m.get('road_divider', []) + m.get('lane_divider', [])):
        lt = rec.get('line_token')
        if lt and lt in lines and len(lines[lt]) >= 2:
            out['divider'].append(np.asarray(lines[lt], np.float64))
    for rec in m.get('ped_crossing', []):
        pt = rec.get('polygon_token')
        if pt and pt in polys and len(polys[pt]) >= 3:
            out['ped_crossing'].append(np.asarray(polys[pt], np.float64))
    for rec in m.get('road_segment', []):
        pt = rec.get('polygon_token')
        if pt and pt in polys and len(polys[pt]) >= 3:
            out['boundary'].append(np.asarray(polys[pt], np.float64))
    return out


def _scene_locations(data_root: str, version: str) -> Dict[str, str]:
    """scene_token -> map location, from the scene/log tables."""
    base = os.path.join(data_root, version)
    with open(os.path.join(base, 'scene.json')) as f:
        scenes = json.load(f)
    with open(os.path.join(base, 'log.json')) as f:
        logs = {l['token']: l['location'] for l in json.load(f)}
    return {s['token']: logs[s['log_token']] for s in scenes}


def sample_map_boxes(elements: Dict[str, List[np.ndarray]],
                     g2l: np.ndarray, pc_range: Sequence[float],
                     min_extent: float = 0.5):
    """Project map elements into one sample's lidar frame; return
    (boxes [N, 4] cxcywh normalized to pc_range, labels [N])."""
    x0, y0 = pc_range[0], pc_range[1]
    sx = pc_range[3] - pc_range[0]
    sy = pc_range[4] - pc_range[1]

    def densify(pts, step=1.0, closed=False):
        """Interpolate ~1 m points along the polyline so clipping to the
        range box cannot drop an element whose vertices are sparse."""
        segs = [pts]
        ring = np.concatenate([pts, pts[:1]], 0) if closed else pts
        for a, b in zip(ring[:-1], ring[1:]):
            n = int(np.linalg.norm(b - a) // step)
            if n > 1:
                t = np.linspace(0, 1, n, endpoint=False)[1:, None]
                segs.append(a[None] * (1 - t) + b[None] * t)
        return np.concatenate(segs, 0)

    boxes, labels, polylines, closed_flags = [], [], [], []
    for ci, cname in enumerate(CLASSES):
        is_ring = cname != 'divider'
        for raw in elements[cname]:
            pts = densify(raw, closed=is_ring)
            p = np.concatenate([pts, np.zeros((len(pts), 1)),
                                np.ones((len(pts), 1))], axis=1) @ g2l.T
            inside = ((p[:, 0] >= pc_range[0]) & (p[:, 0] <= pc_range[3]) &
                      (p[:, 1] >= pc_range[1]) & (p[:, 1] <= pc_range[4]))
            if not inside.any():
                continue
            q = p[inside]
            xmin, ymin = q[:, 0].min(), q[:, 1].min()
            xmax, ymax = q[:, 0].max(), q[:, 1].max()
            if max(xmax - xmin, ymax - ymin) < min_extent:
                continue
            cx = ((xmin + xmax) / 2 - x0) / sx
            cy = ((ymin + ymax) / 2 - y0) / sy
            boxes.append([cx, cy, max((xmax - xmin) / sx, 1e-3),
                          max((ymax - ymin) / sy, 1e-3)])
            labels.append(ci)
            if is_ring:
                # closed elements keep the FULL ring (raw vertices, not the
                # clipped/densified trace) so the downstream filled-polygon
                # rasterization sees an intact boundary — values outside
                # [0, 1] are fine, the scanline fill clips naturally
                # (reference rasterizes crossings as filled polygons,
                # UniAD nuscenes_e2e_dataset.py map gt pipeline).
                r = np.concatenate([raw, np.zeros((len(raw), 1)),
                                    np.ones((len(raw), 1))], axis=1) @ g2l.T
                qn = np.stack([(r[:, 0] - x0) / sx, (r[:, 1] - y0) / sy], -1)
            else:
                qn = np.stack([(q[:, 0] - x0) / sx, (q[:, 1] - y0) / sy], -1)
            if len(qn) > 64:
                qn = qn[np.linspace(0, len(qn) - 1, 64).astype(int)]
            polylines.append(qn.astype(np.float32))
            closed_flags.append(is_ring)
    if not boxes:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32), [],
                np.zeros((0,), bool))
    return (np.asarray(boxes, np.float32),
            np.asarray(labels, np.int32), polylines,
            np.asarray(closed_flags, bool))


def create_map_anns(data_root: str, version: str, infos_pkl: str,
                    out_pkl: str,
                    pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)):
    with open(infos_pkl, 'rb') as f:
        data = pickle.load(f)
    infos = data['infos'] if isinstance(data, dict) else data
    locations = _scene_locations(data_root, version)
    maps = {}
    anns = {}
    for info in infos:
        loc = locations.get(info['scene_token'])
        if loc is None:
            continue
        if loc not in maps:
            maps[loc] = load_map_elements(
                os.path.join(data_root, 'maps', 'expansion', f'{loc}.json'))
        g2l = (transform_matrix(info['lidar2ego_translation'],
                                info['lidar2ego_rotation'], inverse=True) @
               transform_matrix(info['ego2global_translation'],
                                info['ego2global_rotation'], inverse=True))
        boxes, labels, polylines, closed = sample_map_boxes(maps[loc], g2l,
                                                            pc_range)
        anns[info['token']] = dict(boxes=boxes, labels=labels,
                                   polylines=polylines, closed=closed)
    with open(out_pkl, 'wb') as f:
        pickle.dump(anns, f)
    return len(anns)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--data-root', required=True)
    p.add_argument('--version', default='v1.0-trainval')
    p.add_argument('--infos', required=True)
    p.add_argument('--out', required=True)
    a = p.parse_args(argv)
    n = create_map_anns(a.data_root, a.version, a.infos, a.out)
    print(f'wrote map anns for {n} samples -> {a.out}')
    return n


if __name__ == '__main__':
    main()
