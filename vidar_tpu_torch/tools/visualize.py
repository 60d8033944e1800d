"""Visualisation: BEV point-cloud plots, detection renders and dataset
browsing (port of vidar_tpu/tools/visualize.py; reference tools/nusc_viz.py,
tools/analysis_tools/visual.py and the detector's ``_viz_pcd``).

The JAX package draws with matplotlib; the port draws with a small numpy
rasteriser of its own (points, crosses, clipped lines, box outlines, a
camera grid) and writes PNG with ``zlib``, so it needs neither matplotlib
nor Pillow. The colours are the JAX package's; the pixels are not
matplotlib's, and panels carry no text. The geometry (``box_corners_3d``,
``_project``) and what is drawn (``render_detection_sample``'s counts) are
the JAX package's.

Usage:
  python -m vidar_tpu_torch.tools.visualize browse CONFIG [--out-dir D]
      [--num-samples N] [--cfg-options k=v ...]
  python -m vidar_tpu_torch.tools.visualize detections RESULTS_PKL
      [--out-dir D] [--num-samples N] [--score-thr T]

``RESULTS_PKL`` is what ``tools.test --dump-viz`` writes.
"""

from __future__ import annotations

import argparse
import os
import pickle
import struct
import zlib
from typing import Optional, Sequence

import numpy as np
import torch

PRED_COLOR = '#0000e6'
GT_PCD_COLOR = '#db7093'
GT_BOX_COLOR = '#2ca02c'
EGO_COLOR = '#ff0000'
BEV_PIXELS = 900
# a camera panel's width at most, in pixels: a camera is subsampled by the
# least integer step that fits
PANEL_WIDTH = 400

CAM_ORDER = ('CAM_FRONT_LEFT', 'CAM_FRONT', 'CAM_FRONT_RIGHT',
             'CAM_BACK_LEFT', 'CAM_BACK', 'CAM_BACK_RIGHT')

# per-class colours, nuScenes detection classes (reference
# visual.py:320-350)
CLASS_COLORS = {
    'car': '#ff9e4a', 'truck': '#ff9e4a', 'construction_vehicle': '#ff9e4a',
    'bus': '#ff9e4a', 'trailer': '#ff9e4a',
    'barrier': '#9467bd',
    'motorcycle': '#e377c2', 'bicycle': '#e377c2',
    'pedestrian': '#1f77b4', 'traffic_cone': '#d62728',
}
DEFAULT_CLASSES = ('car', 'truck', 'construction_vehicle', 'bus', 'trailer',
                   'barrier', 'motorcycle', 'bicycle', 'pedestrian',
                   'traffic_cone')

# the 12 box edges over the corner order of box_corners_3d, and the X on
# the +x face
_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
          (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]
_FRONT_CROSS = [(0, 5), (1, 4)]


def rgb(color: str) -> np.ndarray:
    """'#rrggbb' -> uint8 [3]."""
    return np.array([int(color[i:i + 2], 16) for i in (1, 3, 5)], np.uint8)


# ------------------------------------------------------------ raster + PNG

class Canvas:
    """An RGB uint8 image [h, w, 3] to draw on in pixel coordinates (x
    right, y down, pixel centres at integers); what falls off it is
    clipped."""

    def __init__(self, h: int, w: int, background: int = 255):
        self.img = np.full((h, w, 3), background, np.uint8)

    @classmethod
    def of(cls, img: np.ndarray) -> 'Canvas':
        """A canvas drawing into ``img`` (e.g. a panel's view of a
        larger image)."""
        canvas = cls.__new__(cls)
        canvas.img = img
        return canvas

    @property
    def shape(self):
        return self.img.shape[:2]

    def points(self, x, y, color: str, radius: int = 0) -> None:
        """A square of side 2 * radius + 1 at each (x, y)."""
        h, w = self.shape
        xi = np.round(np.asarray(x, np.float64)).astype(np.int64).ravel()
        yi = np.round(np.asarray(y, np.float64)).astype(np.int64).ravel()
        c = rgb(color)
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                px, py = xi + dx, yi + dy
                ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
                self.img[py[ok], px[ok]] = c

    def line(self, x0, y0, x1, y1, color: str, width: int = 1) -> None:
        """A segment, clipped to the canvas (Liang-Barsky), sampled at
        every pixel step."""
        h, w = self.shape
        t0, t1 = 0.0, 1.0
        dx, dy = x1 - x0, y1 - y0
        for p, q in ((-dx, x0), (dx, w - 1 - x0), (-dy, y0),
                     (dy, h - 1 - y0)):
            if p == 0:
                if q < 0:
                    return
                continue
            t = q / p
            if p < 0:
                t0 = max(t0, t)
            else:
                t1 = min(t1, t)
        if t0 > t1:
            return
        ax, ay = x0 + t0 * dx, y0 + t0 * dy
        bx, by = x0 + t1 * dx, y0 + t1 * dy
        n = int(max(abs(bx - ax), abs(by - ay))) + 2
        s = np.linspace(0.0, 1.0, n)
        self.points(ax + s * (bx - ax), ay + s * (by - ay), color,
                    radius=(width - 1) // 2)

    def cross(self, x, y, color: str, size: int = 6) -> None:
        self.line(x - size, y - size, x + size, y + size, color, 2)
        self.line(x - size, y + size, x + size, y - size, color, 2)


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of img [h, w, 3] uint8 (filter type 0 rows)."""
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, -1)], axis=1)

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body +
                struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))

    return (b'\x89PNG\r\n\x1a\n' +
            chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0)) +
            chunk(b'IDAT', zlib.compress(rows.tobytes(), 6)) +
            chunk(b'IEND', b''))


def write_png(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'wb') as f:
        f.write(png_bytes(img))


class _BEV:
    """A square canvas over [-lim, lim]^2 metres, x right and y up."""

    def __init__(self, axes_limit: float, pixels: int = BEV_PIXELS):
        self.lim, self.n = float(axes_limit), pixels
        self.canvas = Canvas(pixels, pixels)

    def to_px(self, x, y):
        s = (self.n - 1) / (2 * self.lim)
        return ((np.asarray(x, np.float64) + self.lim) * s,
                (self.lim - np.asarray(y, np.float64)) * s)

    def points(self, xy, color):
        self.canvas.points(*self.to_px(xy[:, 0], xy[:, 1]), color)

    def line(self, xa, ya, xb, yb, color, width=1):
        (pa, qa), (pb, qb) = self.to_px(xa, ya), self.to_px(xb, yb)
        self.canvas.line(float(pa), float(qa), float(pb), float(qb), color,
                         width)

    def cross(self, x, y, color):
        self.canvas.cross(*(float(v) for v in self.to_px(x, y)), color)


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ------------------------------------------------------ point-cloud plots

def draw_pcd_bev(pred_pcd: np.ndarray, output_path: str,
                 gt_pcd: Optional[np.ndarray] = None,
                 origin: Optional[np.ndarray] = None,
                 axes_limit: float = 40.0) -> None:
    """BEV plot: predictions blue, GT pink, the frame origin a red cross,
    the ego (0, 0) a red cross; written as a PNG."""
    bev = _BEV(axes_limit)
    bev.points(np.asarray(pred_pcd), PRED_COLOR)
    if gt_pcd is not None:
        bev.points(np.asarray(gt_pcd), GT_PCD_COLOR)
    if origin is not None:
        bev.cross(origin[0], origin[1], EGO_COLOR)
    bev.cross(0.0, 0.0, EGO_COLOR)
    write_png(output_path, bev.canvas.img)


def viz_forecast(decode: dict, pc_range, out_prefix: str,
                 sample_name: str = 'sample') -> None:
    """Per future frame, predicted vs GT BEV plots of a forecast decode
    (``ForecastRunner``'s dict) -> ``{out_prefix}_{sample_name}_{f}.png``."""
    from ..evals.metrics import inside_mask, render_pcds

    pred_dist = _numpy(decode['pred_dist'])[0]
    gt_dist = _numpy(decode['gt_dist'])[0]
    frame_idx = _numpy(decode['frame_idx'])[0]
    gt_points = _numpy(decode['gt_points_ref'])[0]
    origins = _numpy(decode['origins'])[0]
    for f in sorted(set(frame_idx[frame_idx >= 0].tolist())):
        sel = (frame_idx == f) & (gt_dist > 0)
        if not sel.any():
            continue
        origin = origins[f]
        gt = render_pcds(origin, gt_points[sel], gt_dist[sel])
        pred = render_pcds(origin, gt_points[sel], pred_dist[sel])
        inner = inside_mask(gt, pc_range)
        draw_pcd_bev(pred[inner], f'{out_prefix}_{sample_name}_{f}.png',
                     gt_pcd=gt[inner], origin=origin)


# ------------------------------------------------------ detection results
#
# A devkit-free detection render (reference tools/analysis_tools/
# visual.py:275-477): a 4 x 3 camera grid (6 cameras with predicted boxes,
# the same 6 with GT boxes) and a BEV figure of pred vs GT footprints.
# Boxes are [cx cy cz w l h yaw vx vy] in the lidar frame, projected by
# the batch's lidar2img.

def box_corners_3d(boxes: np.ndarray) -> np.ndarray:
    """[N, >=7] (cx cy cz w l h yaw) -> [N, 8, 3] corners, lidar frame:
    l along the heading, w lateral, z up, cz the centre; bottom corners
    0-3 (x+y+, x+y-, x-y-, x-y+), top 4-7 in the same order."""
    boxes = np.asarray(boxes, np.float64)
    n = boxes.shape[0]
    l, w, h = boxes[:, 4], boxes[:, 3], boxes[:, 5]
    sx = np.array([1, 1, -1, -1], np.float64)
    sy = np.array([1, -1, -1, 1], np.float64)
    cx = sx[None, :] * (l / 2)[:, None]
    cy = sy[None, :] * (w / 2)[:, None]
    yaw = boxes[:, 6]
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    gx = c * cx - s * cy + boxes[:, 0:1]
    gy = s * cx + c * cy + boxes[:, 1:2]
    corners = np.zeros((n, 8, 3), np.float64)
    for half, zsign in ((slice(0, 4), -1.0), (slice(4, 8), 1.0)):
        corners[:, half, 0] = gx
        corners[:, half, 1] = gy
        corners[:, half, 2] = (boxes[:, 2] + zsign * h / 2)[:, None]
    return corners


def _project(corners: np.ndarray, lidar2img: np.ndarray):
    """[N, 8, 3] -> ([N, 8, 2] pixels, [N, 8] depth)."""
    hom = np.concatenate([corners, np.ones_like(corners[..., :1])], axis=-1)
    cam = hom @ np.asarray(lidar2img, np.float64).T
    depth = cam[..., 2]
    pix = cam[..., :2] / np.maximum(depth[..., None], 1e-5)
    return pix, depth


def draw_boxes_camera(canvas: Canvas, boxes, labels, lidar2img, img_w: int,
                      img_h: int, class_names=DEFAULT_CLASSES,
                      linewidth: int = 2, scale: float = 1.0) -> int:
    """Projected 3D wireframes on a camera's canvas (its pixels times
    ``scale``) -> the boxes drawn."""
    if len(boxes) == 0:
        return 0
    pix, depth = _project(box_corners_3d(boxes), lidar2img)
    drawn = 0
    for i in range(len(boxes)):
        if depth[i].max() < 0.1:        # wholly behind the camera
            continue
        vis = ((pix[i, :, 0] > -img_w) & (pix[i, :, 0] < 2 * img_w) &
               (pix[i, :, 1] > -img_h) & (pix[i, :, 1] < 2 * img_h))
        if not vis.any():
            continue
        name = (class_names[int(labels[i])]
                if labels is not None and int(labels[i]) < len(class_names)
                else 'car')
        color = CLASS_COLORS.get(name, GT_BOX_COLOR)
        any_edge = False
        for (a, b) in _EDGES + _FRONT_CROSS:
            if depth[i, a] < 0.1 or depth[i, b] < 0.1:
                continue
            canvas.line(pix[i, a, 0] * scale, pix[i, a, 1] * scale,
                       pix[i, b, 0] * scale, pix[i, b, 1] * scale, color,
                       linewidth)
            any_edge = True
        drawn += int(any_edge)
    return drawn


def draw_boxes_bev(bev: _BEV, boxes, color: str, linewidth: int = 1) -> None:
    """BEV footprints (outline + heading tick) of [N, >=7] boxes."""
    if len(boxes) == 0:
        return
    corners = box_corners_3d(boxes)[:, :4, :2]      # bottom face
    for i in range(len(boxes)):
        for a in range(4):
            b = (a + 1) % 4
            bev.line(corners[i, a, 0], corners[i, a, 1], corners[i, b, 0],
                     corners[i, b, 1], color, linewidth)
        # heading tick: centre -> the middle of the +x edge (corners 0-1)
        mid = corners[i, :2].mean(axis=0)
        bev.line(boxes[i][0], boxes[i][1], mid[0], mid[1], color, linewidth)


def _uint8_image(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    return np.round(np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def render_detection_sample(images, lidar2img, pred: dict, gt: dict,
                            out_path: str, class_names=DEFAULT_CLASSES,
                            score_thr: float = 0.2, axes_limit: float = 54.0,
                            cam_names=CAM_ORDER) -> dict:
    """The detection render: ``out_path`` a 4 x 3 camera grid (rows 1-2
    the cameras with the predictions above ``score_thr``, rows 3-4 with
    the GT; each camera subsampled to at most ``PANEL_WIDTH`` pixels
    wide) and ``<out_path>_bev.png`` the BEV overlay (GT green,
    predictions blue).
    images [cams, H, W, 3] uint8 or float in [0, 1]; lidar2img [cams, 4,
    4]; pred {'boxes', 'scores', 'labels'}; gt {'boxes', 'labels'} ->
    {'pred': boxes drawn, 'gt': boxes drawn} over the cameras, the JAX
    package's counts. ``cam_names`` is kept for the JAX signature: the
    panels carry no titles."""
    images = np.asarray(images)
    cams = images.shape[0]
    pb = np.asarray(pred['boxes']).reshape(-1, np.asarray(
        pred['boxes']).shape[-1] if len(pred['boxes']) else 9)
    keep = (np.asarray(pred['scores']).reshape(-1) > score_thr
            if len(pb) else np.zeros(0, bool))
    pb = pb[keep]
    pl_ = (np.asarray(pred['labels']).reshape(-1)[keep]
           if len(keep) else np.zeros(0, np.int32))
    gb = (np.asarray(gt['boxes']).reshape(-1, 9) if len(gt['boxes'])
          else np.zeros((0, 9)))
    gl = (np.asarray(gt['labels']).reshape(-1) if len(gb)
          else np.zeros(0, np.int32))

    img_h, img_w = images.shape[1:3]
    step = max(1, -(-img_w // PANEL_WIDTH))
    ph, pw = -(-img_h // step), -(-img_w // step)
    grid = Canvas(4 * ph, 3 * pw)
    counts = {'pred': 0, 'gt': 0}
    for ind in range(min(cams, 6)):
        row, col = divmod(ind, 3)
        small = _uint8_image(images[ind])[::step, ::step]
        for rr, boxes, labels, key in ((row, pb, pl_, 'pred'),
                                       (row + 2, gb, gl, 'gt')):
            panel = grid.img[rr * ph:(rr + 1) * ph, col * pw:(col + 1) * pw]
            panel[:small.shape[0], :small.shape[1]] = small
            counts[key] += draw_boxes_camera(
                Canvas.of(panel), boxes, labels, lidar2img[ind], img_w,
                img_h, class_names, scale=1.0 / step)
    write_png(out_path, grid.img)

    bev = _BEV(axes_limit)
    draw_boxes_bev(bev, gb, GT_BOX_COLOR)
    draw_boxes_bev(bev, pb, PRED_COLOR)
    bev.cross(0.0, 0.0, EGO_COLOR)
    base, ext = os.path.splitext(out_path)
    write_png(f'{base}_bev{ext or ".png"}', bev.canvas.img)
    return counts


def viz_detections(results_pkl: str, out_dir: str, num_samples: int = 5,
                   score_thr: float = 0.2) -> int:
    """Render the detection results ``tools.test --dump-viz`` wrote (a
    pickle {token: {images, lidar2img, pred, gt}}) -> the samples
    rendered."""
    with open(results_pkl, 'rb') as f:
        dump = pickle.load(f)
    n = 0
    for token, rec in list(dump.items())[:num_samples]:
        render_detection_sample(
            rec['images'], rec['lidar2img'], rec['pred'], rec['gt'],
            os.path.join(out_dir, f'{token}.png'), score_thr=score_thr)
        n += 1
    print(f'wrote {n} detection plots to {out_dir}')
    return n


def browse_dataset(config: str, out_dir: str, num_samples: int = 5,
                   cfg_options=None) -> int:
    """BEV plots of the current frame's lidar points of the first samples
    of the config's train split -> the samples plotted."""
    from ..core.builder import build_dataset
    from ..core.config import apply_overrides, load_config

    cfg = apply_overrides(load_config(config), cfg_options)
    ds = build_dataset(cfg['data']['train'])
    queue = cfg['data']['train'].get('queue_length', 4)
    n = min(num_samples, len(ds))
    for i in range(n):
        batch = ds[i]
        pts = _numpy(batch.gt_points)[0]
        tix = _numpy(batch.gt_tindex)[0]
        draw_pcd_bev(pts[tix == queue], os.path.join(out_dir,
                                                     f'sample{i}.png'))
    print(f'wrote {n} plots to {out_dir}')
    return n


def main(argv: Optional[Sequence[str]] = None):
    """-> what the subcommand's function returns (the plots written)."""
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest='cmd', required=True)
    b = sub.add_parser('browse')
    b.add_argument('config')
    b.add_argument('--out-dir', default='viz')
    b.add_argument('--num-samples', type=int, default=5)
    b.add_argument('--cfg-options', nargs='+', default=None)
    d = sub.add_parser('detections',
                       help='render a tools.test --dump-viz pickle')
    d.add_argument('results_pkl')
    d.add_argument('--out-dir', default='viz_det')
    d.add_argument('--num-samples', type=int, default=5)
    d.add_argument('--score-thr', type=float, default=0.2)
    args = p.parse_args(argv)
    if args.cmd == 'browse':
        return browse_dataset(args.config, args.out_dir, args.num_samples,
                              args.cfg_options)
    return viz_detections(args.results_pkl, args.out_dir, args.num_samples,
                          args.score_thr)


if __name__ == '__main__':
    main()
