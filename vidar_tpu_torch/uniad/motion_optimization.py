"""Nonlinear trajectory smoothing for motion-head gt perturbation.

Host-side (data-prep) counterpart of the reference's casadi/IPOPT smoother
(UniAD/projects/mmdet3d_plugin/uniad/dense_heads/motion_head_plugin/
motion_optimization.py:16-218) and its gating wrapper
(motion_head_plugin/motion_utils.py:13-103).

The reference solves a direct multiple-shooting problem over kinematic
states (x, y, yaw, speed) and controls (curvature, accel) with RK4
dynamics. casadi is unavailable here; the same objective is solved by
single-shooting: controls parameterize an RK4 rollout and
``scipy.optimize.least_squares`` minimizes tracking + smoothness residuals
with the reference's control bounds (curvature <= 0.2 1/m, |accel| <= 4).
This runs on the data-prep host, never inside jit.

The port's own copy of ``vidar_tpu/uniad/motion_optimization.py``
(numpy only), which the port may not import.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

try:
    from scipy.optimize import least_squares
    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False

CURVATURE_LIMIT = 1.0 / 5.0   # motion_optimization.py:143
ACCEL_LIMIT = 4.0             # motion_optimization.py:146


def _rollout(x0: np.ndarray, controls: np.ndarray, dt: float) -> np.ndarray:
    """RK4 rollout of (x, y, yaw, v) under (curvature, accel) controls
    (motion_optimization.py:114-139)."""
    n = controls.shape[0]
    states = np.zeros((n + 1, 4))
    states[0] = x0

    def f(s, u):
        x, y, yaw, v = s
        k, a = u
        return np.array([v * np.cos(yaw), v * np.sin(yaw), v * k, a])

    for i in range(n):
        s, u = states[i], controls[i]
        k1 = f(s, u)
        k2 = f(s + dt / 2 * k1, u)
        k3 = f(s + dt / 2 * k2, u)
        k4 = f(s + dt * k3, u)
        states[i + 1] = s + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return states


class MotionNonlinearSmoother:
    """Kinematically-feasible smoothing of a reference trajectory.

    API mirror of the reference class (set_reference_trajectory / solve /
    position_x / position_y). Cost terms follow
    motion_optimization.py:157-176: xy tracking (alpha_xy=1), yaw tracking
    (alpha_yaw=0.075), rate smoothness (alpha_rate=0.08 on curvature rate /
    jerk), absolute controls (alpha_abs=0.08), lateral accel
    (alpha_lat_accel=0.06).
    """

    def __init__(self, trajectory_len: int, dt: float = 0.5):
        self.trajectory_len = trajectory_len
        self.dt = dt
        self._x_curr = None
        self._ref = None
        self._sol_states = None

    def set_reference_trajectory(self, x_curr, reference_trajectory):
        """x_curr: (x, y, yaw, speed); reference: [N+1, 3] (x, y, yaw)."""
        self._x_curr = np.asarray(x_curr, np.float64)
        self._ref = np.asarray(reference_trajectory, np.float64)

    def solve(self):
        assert self._ref is not None, 'call set_reference_trajectory first'
        n = self.trajectory_len
        dt = self.dt
        x0 = self._x_curr
        ref = self._ref

        # warm start: curvature from yaw diffs, accel 0
        dyaw = np.diff(ref[:, 2])
        v0 = max(x0[3], 0.1)
        k0 = np.clip(dyaw / (v0 * dt), -CURVATURE_LIMIT, CURVATURE_LIMIT)
        u0 = np.zeros((n, 2))
        u0[:len(k0), 0] = k0[:n]

        def residuals(u_flat):
            u = u_flat.reshape(n, 2)
            st = _rollout(x0, u, dt)
            r_xy = (st[:, :2] - ref[:, :2]).ravel()
            r_yaw = 0.075 ** 0.5 * (np.unwrap(st[:, 2]) -
                                    np.unwrap(ref[:, 2]))
            r_rate = 0.08 ** 0.5 * np.diff(u, axis=0).ravel() / dt
            r_abs = 0.08 ** 0.5 * u.ravel()
            r_lat = 0.06 ** 0.5 * (st[:n, 3] ** 2 * u[:, 0])
            return np.concatenate([r_xy, r_yaw, r_rate, r_abs, r_lat])

        if _HAVE_SCIPY:
            lb = np.tile([-CURVATURE_LIMIT, -ACCEL_LIMIT], n)
            ub = np.tile([CURVATURE_LIMIT, ACCEL_LIMIT], n)
            res = least_squares(residuals, u0.ravel(), bounds=(lb, ub),
                                max_nfev=100)
            u = res.x.reshape(n, 2)
        else:  # pragma: no cover — plain projected gradient fallback
            u = u0.copy()
            for _ in range(100):
                eps = 1e-5
                r0 = residuals(u.ravel())
                g = np.zeros(u.size)
                for j in range(u.size):
                    up = u.ravel().copy()
                    up[j] += eps
                    g[j] = ((residuals(up) ** 2).sum() -
                            (r0 ** 2).sum()) / eps
                u = (u.ravel() - 1e-3 * g).reshape(n, 2)
                u[:, 0] = np.clip(u[:, 0], -CURVATURE_LIMIT, CURVATURE_LIMIT)
                u[:, 1] = np.clip(u[:, 1], -ACCEL_LIMIT, ACCEL_LIMIT)
        self._sol_states = _rollout(x0, u, dt)
        return self

    # casadi-API compatibility: sol.value(smoother.position_x)
    def value(self, arr):
        return arr

    @property
    def position_x(self):
        return self._sol_states[:, 0]

    @property
    def position_y(self):
        return self._sol_states[:, 1]


def nonlinear_smoother(gt_bboxes_3d: np.ndarray, gt_fut_traj: np.ndarray,
                       gt_fut_traj_mask: np.ndarray,
                       bbox_tensor: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Perturb gt future trajectories toward kinematic feasibility.

    Mirror of motion_utils.py:13-103: only dynamic agents (moved > 2 m)
    whose predicted pose is close to gt (< 2 m, < 30 deg) are smoothed; the
    result is kept only if its ADE to the reference stays < 1.5 m.

    Args:
      gt_bboxes_3d: [N, >=7] gt boxes (x, y, z, w, l, h, yaw, ...).
      gt_fut_traj: [N, 12, 2] future offsets from the box center.
      gt_fut_traj_mask: [N, 12] (or [N, 12, 2]) validity.
      bbox_tensor: [N, >=9] predicted boxes (..., yaw at 6, vel at -2:).

    Returns (perturbed [N, 12, 2], mask (bool)).
    """
    n = gt_fut_traj.shape[0]
    mask2d = gt_fut_traj_mask
    if mask2d.ndim == 3:
        ts_limit = mask2d.sum(1)[:, 0]
    else:
        ts_limit = mask2d.sum(1)
    diff = np.zeros((n, 13, 2))
    diff[:, 1:, :] = gt_fut_traj
    diff = np.diff(diff, axis=1)
    yaw_traj = np.arctan2(diff[:, :, 1], diff[:, :, 0])
    yaw_full = np.concatenate(
        [-np.pi / 2 - gt_bboxes_3d[:, None, 6:7][:, :, 0], yaw_traj], axis=1)
    traj_full = np.concatenate(
        [gt_bboxes_3d[:, None, :2], gt_fut_traj], axis=1)

    yaw_preds = bbox_tensor[:, 6]
    vel = bbox_tensor[:, -2:]
    speed = np.sqrt((vel ** 2).sum(-1))

    out = []
    for i in range(n):
        ts = int(ts_limit[i])
        x_curr = np.array([bbox_tensor[i, 0], bbox_tensor[i, 1],
                           -np.pi / 2 - yaw_preds[i], speed[i]])
        ref = np.concatenate([traj_full[i], yaw_full[i][:, None]], -1)
        moved = np.linalg.norm(traj_full[i, min(ts, 12), :2] -
                               traj_full[i, 0, :2]) > 2.0 if ts > 1 else False
        close = (np.linalg.norm(x_curr[:2] - ref[0, :2]) <= 2.0 and
                 _ang_diff(x_curr[2], ref[0, 2]) <= np.pi / 6)
        if ts > 1 and moved and close:
            sm = MotionNonlinearSmoother(trajectory_len=ts, dt=0.5)
            sm.set_reference_trajectory(x_curr, ref[:ts + 1])
            sol = sm.solve()
            pert = np.stack([sol.value(sm.position_x),
                             sol.value(sm.position_y)], -1)
            ade = np.linalg.norm(pert[:, :2] - ref[:ts + 1, :2],
                                 axis=-1).mean()
            if ade < 1.5:
                rel = pert[1:, :2] - pert[0:1, :2]
                full = np.zeros((12, 2))
                full[:rel.shape[0]] = rel
                out.append(full)
                continue
        out.append(traj_full[i, 1:, :2] - traj_full[i, 0:1, :2])
    return np.stack(out) if out else np.zeros((0, 12, 2)), \
        np.asarray(gt_fut_traj_mask) > 0


def _ang_diff(a: float, b: float) -> float:
    va = np.array([np.cos(a), np.sin(a)])
    vb = np.array([np.cos(b), np.sin(b)])
    return float(np.arccos(np.clip(np.dot(va, vb), -1.0, 1.0)))
