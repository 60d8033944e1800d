"""BEV mask rasterization helpers (pure numpy, host-side).

The reference's UniAD map ground truth rasterizes nuScenes map elements
through the devkit: closed elements (ped crossings, drivable surfaces) as
FILLED polygons, line elements (dividers, boundaries) as strokes
(reference UniAD/projects/mmdet3d_plugin/datasets/nuscenes_e2e_dataset.py
map gt pipeline). These are the devkit-free equivalents consumed by
``data.uniad_data.UniADDataset``.

The port's own copy of ``vidar_tpu/data/rasterize.py``
(numpy only), which the port may not import.
"""

from __future__ import annotations

import numpy as np


def fill_polygon(ring: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """Even-odd scanline fill of one closed polygon.

    Args:
      ring: [P, 2] (x, y) vertices in normalized [0, 1] map coordinates
        (values outside [0, 1] are fine — the fill clips naturally).
    Returns: [bh, bw] float32 mask, 1 inside the polygon (cell-center rule).
    """
    ring = np.asarray(ring, np.float64)
    if len(ring) < 3:
        return np.zeros((bh, bw), np.float32)
    x0 = ring[:, 0]
    y0 = ring[:, 1]
    x1 = np.roll(x0, -1)
    y1 = np.roll(y0, -1)
    # scanlines at cell centers
    ys = (np.arange(bh, dtype=np.float64) + 0.5) / bh  # [H]
    # edge e crosses scanline y iff min(y0,y1) <= y < max(y0,y1)
    # (half-open so shared vertices count once)
    lo = np.minimum(y0, y1)[:, None]
    hi = np.maximum(y0, y1)[:, None]
    crosses = (lo <= ys[None, :]) & (ys[None, :] < hi)  # [E, H]
    with np.errstate(divide='ignore', invalid='ignore'):
        t = (ys[None, :] - y0[:, None]) / (y1 - y0)[:, None]
    xc = x0[:, None] + t * (x1 - x0)[:, None]            # [E, H]
    xc = np.where(crosses, xc, np.inf)

    # per scanline: sort crossings, fill between consecutive pairs
    xs_cells = (np.arange(bw, dtype=np.float64) + 0.5) / bw  # [W]
    mask = np.zeros((bh, bw), np.float32)
    order = np.sort(xc, axis=0)  # [E, H]
    for h in range(bh):
        col = order[:, h]
        n = int(np.isfinite(col).sum())
        for k in range(0, n - 1, 2):
            a, b = col[k], col[k + 1]
            mask[h, (xs_cells >= a) & (xs_cells < b)] = 1.0
    return mask


def draw_polyline(pts: np.ndarray, bh: int, bw: int,
                  closed: bool = False, dilate: int = 1) -> np.ndarray:
    """Stroke a polyline: walk each segment at half-cell steps, mark the
    covered cells, then square-dilate by ``dilate`` cells (the reference
    draws map lines with a finite stroke width). Points outside [0, 1] are
    clipped per cell."""
    pts = np.asarray(pts, np.float64)
    m = np.zeros((bh, bw), np.float32)
    if len(pts) == 0:
        return m
    if closed and len(pts) >= 2:
        pts = np.concatenate([pts, pts[:1]], 0)
    # densify segments so strokes have no gaps regardless of vertex spacing
    dense = [pts[:1]]
    step = 0.5 / max(bh, bw)
    for a, b in zip(pts[:-1], pts[1:]):
        n = int(np.linalg.norm(b - a) / step) + 1
        t = np.linspace(0.0, 1.0, n + 1)[1:, None]
        dense.append(a[None] * (1 - t) + b[None] * t)
    pts = np.concatenate(dense, 0)
    inside = ((pts[:, 0] >= 0) & (pts[:, 0] <= 1) &
              (pts[:, 1] >= 0) & (pts[:, 1] <= 1))
    pts = pts[inside]
    if len(pts) == 0:
        return m
    cx = np.clip((pts[:, 0] * bw).astype(int), 0, bw - 1)
    cy = np.clip((pts[:, 1] * bh).astype(int), 0, bh - 1)
    for dy in range(-dilate, dilate + 1):
        for dx in range(-dilate, dilate + 1):
            m[np.clip(cy + dy, 0, bh - 1), np.clip(cx + dx, 0, bw - 1)] = 1.0
    return m
