"""The port's data layer against the JAX package's and Pillow: the nuScenes
and OpenScene datasets on the fake on-disk dataset of
``tests/data/fake_nuscenes.py`` (same seed, every array exactly equal, but
the test split's lidar subsample, held to its (seed, frame index) draw from
JAX's window), the Pillow-equal resize, crop, flip and PNG reader (C++ and
numpy, exactly equal to PIL), and the plumbing under the CLIs (sampler,
eval hook, EMA, forecast metrics). The config loading is
``tests/test_torch_config_matrix.py``'s."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from vidar_tpu import native as jax_native
from vidar_tpu.data import samplers as jax_samplers
from vidar_tpu.data.nuplan import NuPlanViDARDataset as JaxNuPlan
from vidar_tpu.data.nuscenes import NuScenesDetDataset as JaxDet
from vidar_tpu.data.nuscenes import NuScenesViDARDataset as JaxViDAR
from vidar_tpu.evals import metrics as jax_metrics
from vidar_tpu.train import ema as jax_ema
from vidar_tpu.train.eval_hook import EvalHook as JaxEvalHook

from tests.data.fake_nuscenes import make_fake_nuscenes
from vidar_tpu_torch import native
from vidar_tpu_torch.data import collate_samples, pipeline, samplers
from vidar_tpu_torch.data.nuplan import NuPlanViDARDataset
from vidar_tpu_torch.data.nuscenes import (NuScenesDetDataset,
                                           NuScenesViDARDataset)
from vidar_tpu_torch.data.prefetch import PrefetchLoader
from vidar_tpu_torch.data.structures import DetBatch, ViDARBatch
from vidar_tpu_torch.evals import metrics
from vidar_tpu_torch.train.ema import EMA
from vidar_tpu_torch.train.eval_hook import EvalHook

H, W = 64, 96
# the flagship's resize targets (720..1080 of 900 rows) at the fixture's
# 64 rows: factors 0.797..1.203
AUG = dict(reisze=[51, 58, 64, 70, 77], crop=(0, 0, W, H), H=H, W=W,
           rand_flip=True)
COMMON = dict(queue_length=2, future_length=2, bev_size=(12, 12),
              max_points=512, seed=3)
# above the points of any window of the fake samples (about 768 a frame)
WINDOW_ALL = 8192
# the test split's subsample above max_points is drawn from
# default_rng([seed, frame index]), not from JAX's one stream (ROADMAP.md
# §3, departures): these fields are held to that draw from JAX's window
SEEDED_DRAW = ('gt_points', 'gt_tindex')


@pytest.fixture(scope='module')
def fake(tmp_path_factory):
    root = tmp_path_factory.mktemp('fake_nuscenes')
    bin_pkl = make_fake_nuscenes(str(root / 'bin'), num_samples=8,
                                 num_cams=3, img_hw=(H, W))
    pcd_pkl = make_fake_nuscenes(str(root / 'pcd'), num_samples=8,
                                 num_cams=3, img_hw=(H, W),
                                 lidar_format='pcd')
    return bin_pkl, pcd_pkl


def _fields(batch):
    """{name: numpy array} of a ViDARBatch or DetBatch, JAX's or the
    port's."""
    out = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f'{f.name}.{k}': a for k, a in _fields(v).items()})
        else:
            out[f.name] = v.numpy() if torch.is_tensor(v) else np.asarray(v)
    return out


def test_both_packages_decode_with_libjpeg():
    # the JAX package decodes JPEG with Pillow where its native library is
    # missing: the datasets are compared where it uses libjpeg, against the
    # port's own decoder (equal to libjpeg bit for bit,
    # tests/test_torch_jpeg.py)
    assert jax_native.available()
    assert native.available(), native.build_error


CASES = {
    'train_ida_aug': (JaxViDAR, NuScenesViDARDataset,
                      dict(COMMON, ida_aug_conf=AUG,
                           rand_frame_interval=(-1, 1, 2))),
    'train_random_aug': (JaxViDAR, NuScenesViDARDataset,
                         dict(COMMON, random_aug_conf=AUG,
                              rand_frame_interval=(-1, 1))),
    'test': (JaxViDAR, NuScenesViDARDataset, dict(COMMON, test_mode=True)),
    # every point of the 5-frame window kept: no subsample on either side
    'test_all_points': (JaxViDAR, NuScenesViDARDataset,
                        dict(COMMON, test_mode=True, max_points=WINDOW_ALL)),
    'det': (JaxDet, NuScenesDetDataset,
            dict(COMMON, future_length=0, test_mode=True, max_gt=16)),
    'det_pretrain_data': (JaxDet, NuScenesDetDataset,
                          dict(COMMON, future_length=0, max_gt=16,
                               use_pretrain_data=True, ida_aug_conf=AUG)),
    'nuplan': (JaxNuPlan, NuPlanViDARDataset,
               dict(COMMON, ego_mask=None, image_scale=2.0 / 3)),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_dataset_matches_jax(fake, case):
    jax_cls, cls, kwargs = CASES[case]
    pkl = fake[1] if case == 'nuplan' else fake[0]
    ref, ds = jax_cls(pkl, **kwargs), cls(pkl, **kwargs)
    assert ds.usable_index == ref.usable_index and len(ds) > 0
    # JAX's whole window, where the test split subsamples it
    whole = (jax_cls(pkl, **dict(kwargs, max_points=WINDOW_ALL))
             if kwargs.get('test_mode') else None)
    drawn = 0
    for i in range(min(len(ds), 3)):
        want, got = _fields(ref[i]), _fields(ds[i])
        assert sorted(got) == sorted(want)
        if whole is not None:
            window = _fields(whole[i])
            pts_key = next(k for k in window if k.endswith('gt_points'))
            n = int((window[pts_key.replace('gt_points', 'gt_tindex')]
                     >= 0).sum())
            assert n < WINDOW_ALL
            if n > kwargs['max_points']:
                drawn += 1
                sel = np.random.default_rng(
                    [kwargs['seed'], ds.usable_index[i]]).choice(
                        n, kwargs['max_points'], replace=False)
                for k in want:
                    if k.endswith(SEEDED_DRAW):
                        want[k] = window[k][:, sel]
        for k in want:
            assert got[k].dtype == want[k].dtype, (case, i, k)
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f'{case} {i} {k}')
        if cls is NuScenesDetDataset:
            np.testing.assert_array_equal(ds.det_gt_attrs(i),
                                          ref.det_gt_attrs(i))
            got_m, want_m = ds.streaming_meta(i), ref.streaming_meta(i)
            assert got_m['scene_token'] == want_m['scene_token']
            for k in ('can_bus', 'l2g_rot'):
                np.testing.assert_array_equal(got_m[k], want_m[k])
    # the subsample ran where the window exceeds max_points, and only there
    assert drawn == (0 if case == 'test_all_points' or whole is None
                     else min(len(ds), 3)), drawn


@pytest.mark.parametrize('cls', [NuScenesViDARDataset, NuScenesDetDataset])
def test_test_split_points_do_not_depend_on_load_order(fake, cls):
    # the subsample above max_points is a function of (seed, frame index):
    # two fresh datasets loaded in the orders 0, 1, 2 and 2, 0, 1, and a
    # third through 4 loader threads, give equal samples
    kwargs = dict(COMMON, test_mode=True)
    if cls is NuScenesDetDataset:
        kwargs.update(future_length=0, max_gt=16)
    a, b, c = (cls(fake[0], **kwargs) for _ in range(3))
    first = {i: _fields(a[i]) for i in (0, 1, 2)}
    second = {i: _fields(b[i]) for i in (2, 0, 1)}
    threaded = dict(enumerate(
        _fields(s) for s in PrefetchLoader(c.__getitem__, [0, 1, 2],
                                           num_threads=4, depth=3)))
    whole = cls(fake[0], **dict(kwargs, max_points=WINDOW_ALL))
    for i in (0, 1, 2):
        for k in first[i]:
            np.testing.assert_array_equal(second[i][k], first[i][k],
                                          err_msg=f'{i} {k}')
            np.testing.assert_array_equal(threaded[i][k], first[i][k],
                                          err_msg=f'{i} {k}')
        window = _fields(whole[i])
        pts = next(k for k in window if k.endswith('gt_points'))
        tix = pts.replace('gt_points', 'gt_tindex')
        n = int((window[tix] >= 0).sum())
        assert n > COMMON['max_points']
        sel = np.random.default_rng([COMMON['seed'],
                                     a.usable_index[i]]).choice(
            n, COMMON['max_points'], replace=False)
        np.testing.assert_array_equal(first[i][pts], window[pts][:, sel])
        np.testing.assert_array_equal(first[i][tix], window[tix][:, sel])
        # a subset of the window's points (the draw takes no index twice)
        assert len(set(sel.tolist())) == COMMON['max_points']
        assert ({tuple(p) for p in first[i][pts][0]} <=
                {tuple(p) for p in window[pts][0, :n]})


def test_collate_samples(fake):
    ds = NuScenesDetDataset(fake[0], **dict(COMMON, future_length=0,
                                            test_mode=True, max_gt=16))
    a, b = ds[0], ds[1]
    both = collate_samples([a, b])
    assert isinstance(both, DetBatch) and isinstance(both.frames, ViDARBatch)
    for k, v in _fields(both).items():
        np.testing.assert_array_equal(
            v, np.concatenate([_fields(a)[k], _fields(b)[k]]), err_msg=k)
    assert collate_samples([a]) is a


# ------------------------------------------------- Pillow-equal image ops

FACTORS = [720 / 900, 765 / 900, 810 / 900, 855 / 900, 1.0, 945 / 900,
           990 / 900, 1035 / 900, 1080 / 900, 2 / 3]


@pytest.mark.parametrize('factor', FACTORS,
                         ids=[f'{f:.3f}' for f in FACTORS])
def test_resize_crop_flip_match_pillow(factor):
    rng = np.random.default_rng(int(factor * 1000))
    h, w = 90, 160
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    size = (int(w * factor), int(h * factor))
    want = np.asarray(Image.fromarray(img).resize(size))
    np.testing.assert_array_equal(pipeline.resize_bicubic(img, size), want)
    np.testing.assert_array_equal(native.resize_bicubic(img, size), want)
    # the pipeline's centre crop, a box past the image (zero fill), empty
    nw, nh = size
    x0, y0 = max(0, nw - w) // 2, max(0, nh - h) // 2
    for box in ((x0, y0, min(nw, x0 + w), min(nh, y0 + h)),
                (-5, -3, nw + 7, nh + 2), (4, 4, 4, 9)):
        for flip in (False, True):
            im = Image.fromarray(want).crop(box)
            if flip:
                im = im.transpose(Image.FLIP_LEFT_RIGHT)
            ref = np.asarray(im)
            np.testing.assert_array_equal(
                pipeline.crop_flip(want, box, flip), ref, err_msg=str(box))
            np.testing.assert_array_equal(
                native.crop_flip(want, box, flip), ref, err_msg=str(box))


def test_native_resize_matches_pillow_at_flagship_size():
    img = np.random.default_rng(0).integers(0, 256, (900, 1600, 3),
                                            np.uint8)
    for factor in FACTORS:
        size = (int(1600 * factor), int(900 * factor))
        np.testing.assert_array_equal(
            native.resize_bicubic(img, size),
            np.asarray(Image.fromarray(img).resize(size)), err_msg=factor)


def test_crop_box_rejects_inverted_box():
    with pytest.raises(ValueError):
        pipeline.crop_flip(np.zeros((4, 4, 3), np.uint8), (3, 0, 1, 2))


@pytest.mark.parametrize('mode', ['RGB', 'RGBA'])
def test_png_reader_matches_pillow(tmp_path, mode):
    rng = np.random.default_rng(len(mode))
    c = len(mode)
    h, w = 64, 96
    img = rng.integers(0, 256, (h, w, c), np.uint8)
    # smooth rows, so Pillow's adaptive filtering picks every filter type
    img[:h // 2] = (np.arange(w)[None, :, None] * 3 +
                    np.arange(h // 2)[:, None, None] * 5 +
                    np.arange(c)[None, None]).astype(np.uint8)
    path = str(tmp_path / 'x.png')
    Image.fromarray(img, mode).save(path)
    want = np.asarray(Image.open(path))
    np.testing.assert_array_equal(pipeline.read_png(path), want)
    import zlib
    data = open(path, 'rb').read()
    raw, pos = [], 8
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], 'big')
        if data[pos + 4:pos + 8] == b'IDAT':
            raw.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b''.join(raw)), np.uint8)
    assert len(set(raw.reshape(h, -1)[:, 0].tolist())) > 2
    np.testing.assert_array_equal(
        pipeline.png_unfilter(raw, h, w * c, c).reshape(h, w, c), want)
    np.testing.assert_array_equal(
        native.png_unfilter(raw, h, w * c, c).reshape(h, w, c), want)
    # the loader reads PNG as RGB, an alpha channel dropped
    np.testing.assert_array_equal(pipeline.load_multiview_images([path])[0],
                                  want[..., :3].astype(np.float32))


def test_png_reader_refuses_other_formats(tmp_path):
    path = str(tmp_path / 'g.png')
    Image.fromarray(np.zeros((4, 4), np.uint8), 'L').save(path)
    with pytest.raises(ValueError, match='colour type 0'):
        pipeline.read_png(path)
    with pytest.raises(ValueError, match='not supported'):
        pipeline.load_multiview_images([str(tmp_path / 'x.bmp')])


# ---------------------------------------------------------------- plumbing

@pytest.mark.parametrize('world_size', [1, 3])
def test_samplers_match_jax(world_size):
    groups = np.random.default_rng(0).integers(0, 3, 23)
    for rank in range(world_size):
        for epoch in range(3):
            got = samplers.GroupShuffleSampler(
                groups, rank, world_size, seed=5).epoch_indices(epoch)
            want = jax_samplers.GroupShuffleSampler(
                groups, rank, world_size, seed=5).epoch_indices(epoch)
            assert got == want
        assert (samplers.contiguous_shard(23, rank, world_size) ==
                jax_samplers.contiguous_shard(23, rank, world_size))


def test_eval_hook_decisions_match_jax():
    kw = dict(interval=2, dynamic_intervals=[(4, 1), (8, 3)], start=2,
              save_best='NDS', rule='greater')
    got, want = EvalHook(**kw), JaxEvalHook(**kw)
    scores = np.random.default_rng(0).uniform(0, 1, 12)
    for epoch, score in enumerate(scores, 1):
        assert got.should_evaluate(epoch) == want.should_evaluate(epoch)
        assert got.record(epoch, score) == want.record(epoch, score)
    assert got.best_score == want.best_score


@pytest.mark.parametrize('mode', ['exp', 'linear'])
def test_ema_matches_jax(mode):
    rng = np.random.default_rng(0)
    model = torch.nn.Linear(5, 3)
    kw = dict(momentum=0.01, gamma=4.0, mode=mode)
    ema = EMA(model, **kw)
    jstate = jax_ema.init_ema({k: v.detach().numpy().copy()
                               for k, v in model.named_parameters()})
    update = jax.jit(lambda s, p: jax_ema.update_ema(s, p, **kw))
    for _ in range(5):
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.from_numpy(
                    rng.standard_normal(p.shape).astype(np.float32)))
        ema.update(model)
        jstate = update(jstate, {k: jnp.asarray(v.detach().numpy())
                                 for k, v in model.named_parameters()})
    assert ema.step == int(jstate.step)
    for k, v in ema.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate.params[k]),
                                   rtol=0, atol=1e-6)
    sd = ema.state_dict(model)
    assert sorted(sd) == sorted(model.state_dict())


def test_forecast_metrics_match_jax():
    rng = np.random.default_rng(0)
    bs, p, frames = 2, 600, 4
    frame_idx = rng.integers(0, frames, (bs, p)).astype(np.int32)
    gt_dist = rng.uniform(1, 60, (bs, p)).astype(np.float32)
    gt_dist[:, :20] = 0                              # invalid rays
    decode = dict(
        pred_dist=(gt_dist + rng.normal(0, 3, (bs, p))).astype(np.float32),
        gt_dist=gt_dist, frame_idx=frame_idx,
        gt_points_ref=rng.uniform(-80, 80, (bs, p, 3)).astype(np.float32),
        origins=rng.normal(0, 1, (bs, frames, 3)).astype(np.float32))
    pc_range = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    got = metrics.forecast_metrics(decode, pc_range, frames, device='cpu')
    want = jax_metrics.forecast_metrics(decode, pc_range, frames)
    assert sorted(got) == sorted(want)
    for fk in want:
        for k, v in want[fk].items():
            np.testing.assert_allclose(got[fk][k], v, rtol=1e-5,
                                       err_msg=f'{fk}.{k}')
    results = [got, metrics.forecast_metrics(
        {k: v[:1] for k, v in decode.items()}, pc_range, frames,
        device='cpu')]
    agg = metrics.aggregate_frame_metrics([dict(
        (fk, dict(fv)) for fk, fv in r.items()) for r in results])
    ref = jax_metrics.aggregate_frame_metrics([dict(
        (fk, dict(fv)) for fk, fv in r.items()) for r in results])
    for fk in ref:
        for k, v in ref[fk].items():
            np.testing.assert_allclose(agg[fk][k], v, rtol=1e-5)


def test_chamfer_distance_matches_jax():
    from vidar_tpu.ops import chamfer as jax_chamfer
    from vidar_tpu_torch.ops import chamfer
    rng = np.random.default_rng(1)
    a = rng.normal(0, 10, (2, 300, 3)).astype(np.float32)
    b = rng.normal(0, 10, (2, 200, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(chamfer.chamfer_distance(torch.from_numpy(a[0]),
                                       torch.from_numpy(b[0]))),
        float(jax_chamfer.chamfer_distance(jnp.asarray(a[0]),
                                           jnp.asarray(b[0]))), rtol=1e-5)
    for kw in (dict(), dict(bidirectional=True), dict(reverse=True),
               dict(reduction='sum')):
        got = chamfer.ChamferDistance()(torch.from_numpy(a),
                                        torch.from_numpy(b), **kw)
        want = jax_chamfer.ChamferDistance()(jnp.asarray(a), jnp.asarray(b),
                                             **kw)
        for g, w in zip(jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(np.asarray, got,
                                       is_leaf=torch.is_tensor)),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), rtol=1e-5,
                                       err_msg=str(kw))


def test_native_host_ops_match_jax_and_numpy():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-60, 60, (4000, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-6, 4, 4000)
    pc_range = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    got = native.voxel_downsample_points(pts, pc_range, max_voxels=1500)
    np.testing.assert_array_equal(
        got, jax_native.voxel_downsample_points(pts, pc_range,
                                                max_voxels=1500))
    np.testing.assert_array_equal(got, pipeline.voxel_downsample_points(
        pts, pc_range, max_voxels=1500))
    box = (-0.8, -1.5, 0.8, 2.5)
    pts[:50, :2] = rng.uniform(-1, 1, (50, 2))
    np.testing.assert_array_equal(native.point_filter(pts, box, 1.0),
                                  jax_native.point_filter(pts, box, 1.0))
    d, i = native.knn_1nn(pts[:300], pts[300:900])
    want_d, want_i = jax_native.knn_1nn(pts[:300], pts[300:900])
    # the port's library is built without fused multiply-adds, the JAX
    # package's with them: the squared distances differ in the last bit
    np.testing.assert_allclose(d, want_d, rtol=1e-6)
    np.testing.assert_array_equal(i, want_i)
    img = rng.uniform(0, 255, (37, 50, 3)).astype(np.float32)
    got = native.normalize_pad(img, 64, 64)
    np.testing.assert_array_equal(got, jax_native.normalize_pad(img, 64, 64))
    np.testing.assert_allclose(
        got, pipeline.pad_images(pipeline.normalize_images(img[None]),
                                 32)[0], rtol=0, atol=1e-4)
