"""The counts ``vidar_tpu_torch.tools.kernel_ab`` prints beside K8's times:
the valid waypoints a cell and the float4 reductions of the vector
kernel's scatter before and after its merge, held against a waypoint by
waypoint walk of the kernel's lists, runs and merge rule (CPU, small)."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from vidar_tpu_torch.models.latent_rendering import ray_geometry
from vidar_tpu_torch.tools.kernel_ab import _aggregate_rows


def _walk(valid, way, live, h, w, groups):
    """(rows before, rows after) of the vector K8's walk 2, one cell at a
    time: batches of 32 waypoints, each batch's valid ones listed in order,
    ``groups`` lane groups each taking a run of them, a pending row merged
    into the next waypoint's row of the same pixel."""
    before = after = 0
    for n in np.flatnonzero(live):
        for g0 in range(0, valid.shape[1], 32):
            listed = []
            for k in np.flatnonzero(valid[n, g0:g0 + 32]) + g0:
                gx, gy = way[n, k]
                x0 = math.floor(((gx + 1.0) * w - 1.0) * 0.5)
                y0 = math.floor(((gy + 1.0) * h - 1.0) * 0.5)
                rows = []
                for c in range(4):
                    x, y = x0 + (c & 1), y0 + (c >> 1)
                    rows.append(y * w + x if 0 <= x < w and 0 <= y < h
                                else -1)
                listed.append(rows)
            if not listed:
                continue
            run = -(-len(listed) // groups)
            for k0 in range(0, len(listed), run):
                pending = [-1] * 4
                for rows in listed[k0:k0 + run]:
                    before += sum(r >= 0 for r in rows)
                    for c in range(4):
                        for j in range(4):
                            if rows[c] >= 0 and rows[c] == pending[j]:
                                pending[j] = -1
                    after += sum(r >= 0 for r in pending)
                    pending = rows
                after += sum(r >= 0 for r in pending)
    return before, after


@pytest.mark.parametrize('shuffle', [False, True])
def test_aggregate_rows_counts_the_merge(shuffle):
    h, w, g, c_r = 24, 20, 40, 16
    grids, rn, steps = ray_geometry(h, w, g, 0.5, 'cpu')
    rng = np.random.default_rng(0)
    if shuffle:
        steps = steps[torch.from_numpy(rng.permutation(g))]
    gout = torch.from_numpy(rng.standard_normal((2, h * w, c_r))).float()
    gout[0, ::3] = 0.0
    gout[1, 1::5] = 0.0
    a = dict(fused_map=torch.zeros(2, h, w, 2 * c_r), g=gout,
             radial_norm=rn, steps=steps)
    pairs, before, after = _aggregate_rows(a)

    way = ((0.5 + rn[:, None, :] * steps[None, :, None]) * 2.0 - 1.0)
    boundary = torch.minimum(1.0 / rn[:, 0].abs(), 1.0 / rn[:, 1].abs())
    valid = (torch.sqrt((way ** 2).sum(-1)) < boundary[:, None]).numpy()
    # S = c_r / 4 lanes a waypoint, 32 / S lane groups; a row is 2 c_r / 4
    # float4s
    groups, row = 32 // (c_r // 4), 2 * c_r // 4
    want = np.zeros(2)
    for b in range(2):
        live = (gout[b] != 0).any(-1).numpy()
        want += _walk(valid, way.double().numpy(), live, h, w, groups)
    assert pairs == valid.sum() / (h * w)
    assert (before, after) == (want[0] * row, want[1] * row)
    assert after < before
