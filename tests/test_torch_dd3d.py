"""The port's DD3D and its mono dataset against the JAX package's, on the
CPU in f32: the quaternion and allocentric geometry, ``prepare_targets``,
a small ``NuScenesDD3D`` (forward, ``loss`` and its parameter gradients,
``inference`` with the class-wise NMS: the same detections, scores to
1e-5), ``_classwise_nms`` on overlapping boxes, and ``NuScenesMonoDataset``
exactly equal on tables of ``tests/data/fake_nuscenes.py`` (cameras turned
to look along the ground, at nuScenes intrinsics)."""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.data.fake_nuscenes import make_fake_nuscenes
from vidar_tpu.data.nuscenes_mono import \
    NuScenesMonoDataset as JaxMonoDataset
from vidar_tpu.models import dd3d as jdd3d

from vidar_tpu_torch.convert import state_dict_from_jax
from vidar_tpu_torch.data.nuscenes_mono import NuScenesMonoDataset
from vidar_tpu_torch.models import dd3d

TOL = 1e-4
# the parameter gradients: back through the towers' 4 conv + GroupNorm
# layers and the 3D geometry, sums in other orders
GRAD_TOL = 1e-3
IMG = 128
STRIDES = (8, 16, 32, 64, 128)


def _close(got, want, what, tol=TOL):
    if torch.is_tensor(got):
        got = got.detach().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-12), (
        what, err, np.abs(want).max())


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _inv_k(n):
    k = np.array([[300.0, 0, IMG / 2], [0, 300.0, IMG / 2], [0, 0, 1]])
    return np.broadcast_to(np.linalg.inv(k).astype(np.float32),
                           (n, 3, 3)).copy()


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    n = 16
    q = _quats(rng, n)
    ctr = rng.uniform(0, IMG, (n, 2)).astype(np.float32)
    depth = rng.uniform(2, 60, (n, 1)).astype(np.float32)
    size = rng.uniform(0.5, 5, (n, 3)).astype(np.float32)
    inv_k = _inv_k(n)
    m = jdd3d.quaternion_to_matrix(q)
    _close(dd3d.quaternion_to_matrix(*_t(q)), m, 'quaternion_to_matrix')
    _close(dd3d.matrix_to_quaternion(*_t(m)),
           jdd3d.matrix_to_quaternion(m), 'matrix_to_quaternion')
    _close(dd3d.allocentric_to_egocentric(*_t(q, ctr, inv_k)),
           jdd3d.allocentric_to_egocentric(q, ctr, inv_k), 'allocentric')
    _close(dd3d.boxes3d_corners(*_t(q, ctr, depth, size, inv_k)),
           jdd3d.boxes3d_corners(q, ctr, depth, size, inv_k), 'corners')
    raw = [rng.standard_normal(s).astype(np.float32)
           for s in ((n, 4), (n, 2), (n,), (n, 3))]
    loc = rng.uniform(0, IMG, (n, 2)).astype(np.float32)
    canon = np.asarray(jdd3d.NUSCENES_CANON_SIZES, np.float32)[
        rng.integers(0, 10, n)]
    got = dd3d.predictions_to_boxes3d(*_t(*raw, loc, inv_k, canon))
    want = jdd3d.predictions_to_boxes3d(*raw, loc, inv_k, canon)
    for name, g, w in zip(('quat', 'proj_ctr', 'depth', 'size'), got, want):
        _close(g, w, name)


def test_matrix_to_quaternion_gradient():
    """Where JAX's gradient is finite the port's equals it; at a rotation
    with a zero quaternion component (the identity) JAX's sqrt(clip(x, 0))
    gives NaN (ROADMAP.md §3) and the port's finite gradient."""
    rng = np.random.default_rng(5)
    q = np.concatenate([_quats(rng, 8), [[1.0, 0, 0, 0]]]).astype(np.float32)
    w = rng.standard_normal((9, 4)).astype(np.float32)

    def jax_loss(q):
        return (jdd3d.matrix_to_quaternion(jdd3d.quaternion_to_matrix(q)) *
                w).sum()

    want = np.asarray(jax.jit(jax.grad(jax_loss))(q))
    qt = torch.from_numpy(q).requires_grad_()
    (dd3d.matrix_to_quaternion(dd3d.quaternion_to_matrix(qt)) *
     torch.from_numpy(w)).sum().backward()
    got = qt.grad.numpy()
    assert np.isnan(want[8]).all() and np.isfinite(got).all()
    _close(got[:8], want[:8], 'd quat')


def _gt(rng, g=6, valid=4):
    """Padded GT of one 128x128 image: 2D boxes 20-60 px wide, labels, and
    the 3D components in the vision frame."""
    c = rng.uniform(24, IMG - 24, (g, 2))
    half = rng.uniform(10, 30, (g, 2))
    return dict(
        boxes2d=np.concatenate([c - half, c + half], -1).astype(np.float32),
        labels=rng.integers(0, 10, g).astype(np.int32),
        num_valid=np.int32(valid), quat=_quats(rng, g),
        proj_ctr=(c + rng.normal(0, 2, (g, 2))).astype(np.float32),
        depth=rng.uniform(5, 50, (g, 1)).astype(np.float32),
        size=rng.uniform(0.5, 5, (g, 3)).astype(np.float32))


def test_prepare_targets_matches_jax():
    rng = np.random.default_rng(1)
    gt = _gt(rng)
    shapes = [(IMG // s, IMG // s) for s in STRIDES]
    jlocs = jdd3d.compute_locations(shapes, STRIDES)
    locs = dd3d.compute_locations(shapes, STRIDES)
    for a, b in zip(locs, jlocs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jdd3d.prepare_targets(jlocs, STRIDES, gt['boxes2d'], gt['labels'],
                                 gt['num_valid'], 10)
    got = dd3d.prepare_targets(locs, STRIDES, *_t(gt['boxes2d'],
                                                  gt['labels']),
                               int(gt['num_valid']), 10)
    assert bool(got['pos'].any())
    for k in ('labels', 'matched_idx', 'pos'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    np.testing.assert_array_equal(got['box2d_reg'].numpy(),
                                  np.asarray(want['box2d_reg']))
    _close(dd3d.compute_ctrness_targets(got['box2d_reg']),
           jdd3d.compute_ctrness_targets(want['box2d_reg']), 'ctrness')


def _random_params(shapes, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == 'kernel':
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ('scale', 'offset'):
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope='module')
def detector():
    rng = np.random.default_rng(2)
    feats = [rng.standard_normal((1, IMG // s, IMG // s, 32)).astype(
        np.float32) for s in STRIDES]
    gt = _gt(rng)
    inv_k = _inv_k(1)[0]
    jmod = jdd3d.NuScenesDD3D()
    params = _random_params(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), feats)), seed=3)

    @jax.jit
    def run(p):
        def loss(p):
            ls = jmod.apply(p, jmod.apply(p, feats),
                            jax.tree.map(jnp.asarray, gt), inv_k,
                            method=jmod.loss)
            return sum(jax.tree.leaves(ls)), ls
        (_, ls), g = jax.value_and_grad(loss, has_aux=True)(p)
        preds = jmod.apply(p, feats)
        return preds, ls, g, jmod.apply(p, preds, inv_k,
                                        method=jmod.inference)

    jpreds, jlosses, jgrads, jdet = run(params)
    model = dd3d.NuScenesDD3D(channels=32, device='cpu')
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    preds = model(_t(*feats))
    tgt = {k: torch.from_numpy(np.array(v)) for k, v in gt.items()}
    losses = model.loss(preds, tgt, torch.from_numpy(inv_k))
    sum(losses.values()).backward()
    with torch.no_grad():
        det = model.inference(model(_t(*feats)), torch.from_numpy(inv_k))
    return dict(jpreds=jpreds, jlosses=jlosses, jgrads=jgrads, jdet=jdet,
                model=model, preds=preds, losses=losses, det=det)


def test_forward_matches_jax(detector):
    for key, maps in detector['jpreds'].items():
        for lvl, (g, w) in enumerate(zip(detector['preds'][key], maps)):
            _close(g, w, f'{key}[{lvl}]')


def test_losses_and_grads_match_jax(detector):
    got, want = detector['losses'], detector['jlosses']
    assert set(got) == set(want) and len(want) == 8
    for k in sorted(want):
        _close(got[k], want[k], k)
    want_g = state_dict_from_jax(detector['jgrads'])
    for name, p in detector['model'].named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        if name.startswith(('attr_logits', 'speed')):
            # no loss reads them, in JAX either
            assert p.grad is None and not np.abs(want_g[name].numpy()).any()
            continue
        _close(got, want_g[name], f'd {name}', GRAD_TOL)


def test_inference_with_nms_matches_jax(detector):
    got, want = detector['det'], detector['jdet']
    _close(got['scores'], want['scores'], 'scores', 1e-5)
    kept = np.asarray(want['scores']) > 0
    assert kept.sum() > 0
    for k in ('labels', 'attrs'):
        np.testing.assert_array_equal(got[k].numpy()[kept],
                                      np.asarray(want[k])[kept], k)
    for k in ('boxes2d', 'corners3d', 'depth', 'speeds'):
        _close(got[k].numpy()[kept], np.asarray(want[k])[kept], k)


def test_classwise_nms_matches_jax():
    rng = np.random.default_rng(4)
    n = 200
    c = rng.uniform(0, 100, (n, 2))
    half = rng.uniform(5, 15, (n, 2))
    boxes = np.concatenate([c - half, c + half], -1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[1] = scores[0]                      # a tie
    labels = rng.integers(0, 3, n).astype(np.int32)
    for thresh in (0.1, 0.3, 0.75):
        want = np.asarray(jdd3d._classwise_nms(boxes, scores, labels,
                                               thresh))
        got = dd3d._classwise_nms(*_t(boxes, scores, labels), thresh)
        np.testing.assert_array_equal(got.numpy(), want)
        assert not want.all()


@pytest.fixture(scope='module')
def mono_pkl(tmp_path_factory):
    """Fake tables with 6 cameras turned to look along the ground (cam z
    forward, x right, y down) at 1600x900 intrinsics."""
    root = tmp_path_factory.mktemp('mono')
    pkl = make_fake_nuscenes(str(root), num_samples=4, num_cams=6,
                             img_hw=(32, 48))
    with open(pkl, 'rb') as f:
        data = pickle.load(f)
    cam_to_lidar = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    for info in data['infos']:
        for cam in info['cams'].values():
            cam['sensor2lidar_rotation'] = (cam['sensor2lidar_rotation'] @
                                            cam_to_lidar)
            cam['cam_intrinsic'] = np.array([[800.0, 0, 800], [0, 800, 450],
                                             [0, 0, 1]])
    # out of timestamp order, which the dataset sorts
    data['infos'] = data['infos'][::-1]
    out = str(root / 'mono.pkl')
    with open(out, 'wb') as f:
        pickle.dump(data, f)
    return out


def test_mono_dataset_equals_jax(mono_pkl):
    cams = tuple(f'CAM{c}' for c in range(6))
    kw = dict(cam_names=cams, max_gt=8)
    ds = NuScenesMonoDataset(mono_pkl, **kw)
    jds = JaxMonoDataset(mono_pkl, **kw)
    assert len(ds) == len(jds) == 24
    valid = 0
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert set(got) == set(want)
        for k in want:
            if k == 'image_path':
                assert got[k] == want[k]
            else:
                np.testing.assert_array_equal(got[k], want[k], k)
        valid += int(got['num_valid'])
    assert valid > 0
    got = ds.getitem_by_sample_cam(1, 'CAM3')
    np.testing.assert_array_equal(got['boxes2d'], ds[1 * 6 + 3]['boxes2d'])
    assert got['image_path'].endswith('img_1_3.jpg')   # timestamp order
    img = ds.load_image(got)
    assert img.shape == (32, 48, 3) and img.dtype == np.float32
