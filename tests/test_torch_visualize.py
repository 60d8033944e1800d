"""The port's visualisation tool against the JAX package's, on the CPU:
``box_corners_3d`` and ``_project`` exactly equal, ``render_detection_
sample``'s counts equal (the JAX side draws with matplotlib), the PNG
writer read back by the port's reader, both subcommands, and the test
CLI's ``--viz-pcd`` in this process on the fake dataset of
``tests/data/fake_nuscenes.py``."""

import glob
import os
import pathlib
import pickle

import numpy as np
import pytest

from tests.data.fake_nuscenes import make_fake_nuscenes
from vidar_tpu.tools import visualize as jviz

from vidar_tpu_torch.data.pipeline import read_png
from vidar_tpu_torch.tools import test as test_cli
from vidar_tpu_torch.tools import visualize as viz

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = str(ROOT / 'configs' / 'tiny' / 'vidar_tiny.py')


def _lidar2img(cams=6, img_w=320, img_h=192):
    """Pinhole cameras in a ring, camera c looking along a yaw of c x 60
    degrees (tests/tools/test_visualize_detections.py's)."""
    k = np.array([[160.0, 0, img_w / 2, 0], [0, 160.0, img_h / 2, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]])
    mats = []
    for c in range(cams):
        yaw = np.deg2rad(60.0 * c)
        ext = np.eye(4)
        ext[:3, :3] = np.stack([[np.sin(yaw), -np.cos(yaw), 0.0],
                                [0.0, 0.0, -1.0],
                                [np.cos(yaw), np.sin(yaw), 0.0]])
        mats.append(k @ ext)
    return np.stack(mats)


def _boxes(rng, n):
    return np.concatenate([
        rng.uniform(-25, 25, (n, 2)), rng.uniform(-1, 1, (n, 1)),
        rng.uniform(0.5, 5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1)),
        np.zeros((n, 2))], -1)


def test_geometry_equals_jax():
    rng = np.random.default_rng(0)
    boxes = _boxes(rng, 20)
    corners = viz.box_corners_3d(boxes)
    np.testing.assert_array_equal(corners, jviz.box_corners_3d(boxes))
    for l2i in _lidar2img():
        for got, want in zip(viz._project(corners, l2i),
                             jviz._project(corners, l2i)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('seed', [1, 2])
def test_render_detection_sample_counts_equal_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (6, 96, 160, 3)).astype(np.float32)
    l2i = _lidar2img(6, 160, 96)
    pred = dict(boxes=_boxes(rng, 30), scores=rng.uniform(0, 1, 30),
                labels=rng.integers(0, 12, 30))
    gt = dict(boxes=_boxes(rng, 12), labels=rng.integers(0, 10, 12))
    want = jviz.render_detection_sample(images, l2i, pred, gt,
                                        str(tmp_path / 'jax.png'))
    out = str(tmp_path / 'port.png')
    got = viz.render_detection_sample(images, l2i, pred, gt, out)
    assert got == want and got['pred'] > 0 and got['gt'] > 0
    grid, bev = read_png(out), read_png(str(tmp_path / 'port_bev.png'))
    assert grid.shape == (4 * 96, 3 * 160, 3)
    assert bev.shape == (viz.BEV_PIXELS, viz.BEV_PIXELS, 3)
    for color in (viz.PRED_COLOR, viz.GT_BOX_COLOR):
        assert (bev == viz.rgb(color)).all(-1).any(), color


def test_png_round_trip(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (37, 53, 3), np.uint8)
    path = str(tmp_path / 'sub' / 'img.png')
    viz.write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)


def test_canvas_clips_lines_and_points():
    canvas = viz.Canvas(20, 30)
    canvas.line(-100.0, 10.0, 200.0, 10.0, '#ff0000')      # clipped
    canvas.line(-5.0, -5.0, -1.0, -9.0, '#00ff00')         # all off
    canvas.points(np.array([0.0, 29.0, 40.0]), np.array([0.0, 19.0, 5.0]),
                  '#0000ff')
    red = (canvas.img == viz.rgb('#ff0000')).all(-1)
    assert red[10].all() and red.sum() == 30
    assert not (canvas.img == viz.rgb('#00ff00')).all(-1).any()
    assert (canvas.img == viz.rgb('#0000ff')).all(-1).sum() == 2


@pytest.fixture(scope='module')
def fake(tmp_path_factory):
    root = tmp_path_factory.mktemp('viz')
    pkl = make_fake_nuscenes(str(root / 'data'), num_samples=4, num_cams=3,
                             img_hw=(64, 96))
    return root, pkl


def test_test_cli_viz_pcd_writes_plots(fake):
    root, pkl = fake
    prefix = str(root / 'dbg' / 'pred_pcd')
    assert test_cli.parse_args([TINY]).viz_path == 'dbg/pred_pcd'
    metrics = test_cli.main([
        TINY, '--device', 'cpu', '--max-samples', '1', '--viz-pcd',
        '--viz-path', prefix, '--cfg-options', f'data.test.ann_file={pkl}'])
    assert metrics
    plots = sorted(glob.glob(prefix + '_sample0_*.png'))
    assert plots, os.listdir(root / 'dbg')
    for path in plots:
        img = read_png(path)
        assert img.shape == (viz.BEV_PIXELS, viz.BEV_PIXELS, 3)
        for color in (viz.PRED_COLOR, viz.GT_PCD_COLOR):
            assert (img == viz.rgb(color)).all(-1).any(), (path, color)


def test_browse_and_detections_subcommands(fake):
    root, pkl = fake
    out = str(root / 'browse')
    assert viz.main(['browse', TINY, '--out-dir', out, '--num-samples', '2',
                     '--cfg-options', f'data.train.ann_file={pkl}']) == 2
    img = read_png(os.path.join(out, 'sample1.png'))
    assert (img == viz.rgb(viz.PRED_COLOR)).all(-1).any()

    rng = np.random.default_rng(4)
    rec = dict(images=rng.uniform(0, 1, (6, 48, 80, 3)),
               lidar2img=_lidar2img(6, 80, 48),
               pred=dict(boxes=_boxes(rng, 5), scores=np.full(5, 0.9),
                         labels=np.zeros(5, int)),
               gt=dict(boxes=_boxes(rng, 3), labels=np.zeros(3, int)))
    dump = str(root / 'dump.pkl')
    with open(dump, 'wb') as f:
        pickle.dump({'tok0': rec, 'tok1': rec, 'tok2': rec}, f)
    det_dir = str(root / 'det')
    assert viz.main(['detections', dump, '--out-dir', det_dir,
                     '--num-samples', '2']) == 2
    assert sorted(os.listdir(det_dir)) == [
        'tok0.png', 'tok0_bev.png', 'tok1.png', 'tok1_bev.png']
