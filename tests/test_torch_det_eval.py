"""The port's detection helpers against the JAX package's on seeded inputs:
the box codec, focal loss and matching costs, the Hungarian assignment and
the NMS-free decode (``core/bbox.py``), the streaming rebase
(``evals/streaming.py``), the nuScenes metrics (``evals/detection.py``),
and the fine-tune preset against the config file."""

import runpy
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidar_tpu.core import bbox as jax_bbox
from vidar_tpu.evals import detection as jax_detection
from vidar_tpu.evals.streaming import StreamingRebase as JaxStreamingRebase

from vidar_tpu_torch import configs
from vidar_tpu_torch.core import bbox
from vidar_tpu_torch.evals import detection
from vidar_tpu_torch.evals.det_runner import CLASS_NAMES
from vidar_tpu_torch.evals.streaming import StreamingRebase

ROOT = pathlib.Path(__file__).resolve().parents[1]
# f32 elementwise functions on both sides: 1e-5 of the largest magnitude
REL_TOL = 1e-5


def _close(got, want, what, tol=REL_TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def _boxes(rng, n):
    b = np.zeros((n, 9), np.float32)
    b[:, :2] = rng.uniform(-60, 60, (n, 2))
    b[:, 2] = rng.uniform(-3, 3, n)
    b[:, 3:6] = rng.uniform(0.5, 5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[:, 7:9] = rng.normal(0, 2, (n, 2))
    return b


def test_box_codec_losses_and_costs_match_jax():
    rng = np.random.default_rng(0)
    q, g, classes = 40, 7, 10
    gt = _boxes(rng, g)
    logits = rng.normal(0, 2, (q, classes)).astype(np.float32)
    preds = rng.normal(0, 1, (q, 10)).astype(np.float32)
    labels = rng.integers(0, classes + 1, q)       # classes = background
    gt_labels = rng.integers(0, classes, g)

    @jax.jit
    def reference(gt, preds, logits, labels, gt_labels):
        gt_n = jax_bbox.normalize_bbox(gt)
        return (gt_n, jax_bbox.denormalize_bbox(preds),
                jax_bbox.sigmoid_focal_loss(logits, labels, classes),
                jax_bbox.focal_loss_cost(logits, gt_labels),
                jax_bbox.bbox3d_l1_cost(preds, gt_n))

    norm, denorm, focal, focal_cost, l1_cost = reference(
        gt, preds, logits, labels, gt_labels)
    t = torch.from_numpy
    _close(bbox.normalize_bbox(t(gt)), norm, 'norm')
    _close(bbox.denormalize_bbox(t(preds)), denorm, 'denorm')
    _close(bbox.denormalize_bbox(bbox.normalize_bbox(t(gt)))[:, :6],
           gt[:, :6], 'round trip')
    _close(bbox.sigmoid_focal_loss(t(logits), t(labels), classes), focal,
           'focal loss')
    _close(bbox.focal_loss_cost(t(logits), t(gt_labels)), focal_cost,
           'focal cost')
    _close(bbox.bbox3d_l1_cost(t(preds), t(np.array(norm))), l1_cost,
           'l1 cost')


@pytest.mark.parametrize('n_valid', [0, 3, 7])
def test_hungarian_assign_matches_jax(n_valid):
    rng = np.random.default_rng(1)
    cost = rng.uniform(0, 10, (30, 7)).astype(np.float32)
    want = np.asarray(jax_bbox.hungarian_assign(jnp.asarray(cost),
                                                jnp.int32(n_valid),
                                                impl='scipy'))
    got = bbox.hungarian_assign(torch.from_numpy(cost).requires_grad_(),
                                torch.tensor(n_valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).sum() == n_valid


def test_nms_free_decode_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (50, 10)).astype(np.float32)
    preds = rng.normal(0, 1, (50, 10)).astype(np.float32)
    preds[:, :2] *= 50.0                  # some centres past the range
    want = jax.jit(lambda lg, pr: jax_bbox.nms_free_decode(lg, pr,
                                                           max_num=300))(
        jnp.asarray(logits), jnp.asarray(preds))
    got = bbox.nms_free_decode(torch.from_numpy(logits),
                               torch.from_numpy(preds), max_num=300)
    for key in ('labels', 'valid'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert 0 < int(got['valid'].sum()) < 300
    _close(got['scores'], want['scores'], 'scores')
    _close(got['bboxes'], want['bboxes'], 'bboxes')


def test_streaming_rebase_matches_jax():
    rng = np.random.default_rng(3)
    jr = JaxStreamingRebase(bev_size=(50, 40))
    pr = StreamingRebase(bev_size=(50, 40))
    for i, scene in enumerate('aaabbab'):
        yaw = rng.uniform(-np.pi, np.pi)
        meta = dict(can_bus=rng.normal(0, 20, 18), scene_token=scene,
                    l2g_rot=np.array([[np.cos(yaw), -np.sin(yaw), 0],
                                      [np.sin(yaw), np.cos(yaw), 0],
                                      [0, 0, 1.0]]))
        want, got = jr.step(meta), pr.step(meta)
        assert got['has_prev'] == want['has_prev'], i
        for key in ('can_bus', 'shift', 'rotate_angle'):
            assert np.asarray(got[key]).dtype == np.float32
            np.testing.assert_allclose(got[key], want[key], rtol=REL_TOL,
                                       atol=0, err_msg=f'{key}, frame {i}')
    pr.reset()
    assert not pr.step(meta)['has_prev']


def test_evaluate_detection_matches_jax():
    rng = np.random.default_rng(4)
    names = CLASS_NAMES
    preds, gts = {}, {}
    for s in range(4):
        gt = _boxes(rng, 12)
        gl = rng.integers(0, 10, 12)
        # detections: noisy copies of most GT boxes, plus false positives
        keep = rng.uniform(size=12) < 0.8
        noisy = gt[keep] + rng.normal(0, 0.6, (int(keep.sum()), 9)).astype(
            np.float32) * np.array([1, 1, .2, .1, .1, .1, .3, .5, .5],
                                   np.float32)
        boxes = np.concatenate([noisy, _boxes(rng, 5)])
        labels = np.concatenate([gl[keep], rng.integers(0, 10, 5)])
        preds[f's{s}'] = dict(
            boxes=boxes, scores=rng.uniform(size=len(boxes)), labels=labels,
            attrs=detection.infer_attributes(boxes, labels, names))
        gts[f's{s}'] = dict(boxes=gt, labels=gl,
                            attrs=jax_detection.infer_attributes(gt, gl,
                                                                 names))
        np.testing.assert_array_equal(preds[f's{s}']['attrs'],
                                      jax_detection.infer_attributes(
                                          boxes, labels, names))
    got = detection.evaluate_detection(preds, gts, names)
    want = jax_detection.evaluate_detection(preds, gts, names)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=REL_TOL, abs=0), key
    assert 0 < got['mAP'] < 1 and 0 < got['NDS'] < 1


def test_finetune_preset_equals_the_config_file():
    path = (ROOT / 'configs' / 'vidar_finetune' / 'nusc_1_4_subset' /
            'vidar_1_8_nusc_3future.py')
    model = dict(runpy.run_path(str(path))['model'])
    assert model.pop('type') == 'BEVFormer'
    assert configs.vidar_finetune_1_8_nusc_3future() == model
