"""UniAD's host side in the port against the JAX package's: the
``UniADDataset`` samples on the fake on-disk dataset of
``tests/data/fake_nuscenes.py`` (with the instance tokens, without them,
with a map annotation file; every array exactly equal), the map
rasterisers, the tracking eval, the UniAD metrics and the trajectory
smoother on the same numpy inputs, and every UniAD config file built
through the port's builder at tiny overrides."""

import dataclasses
import pathlib
import pickle

import numpy as np
import pytest
import torch

from vidar_tpu.core.builder import build_dataset as jax_build_dataset
from vidar_tpu.core.config import apply_overrides as jax_apply_overrides
from vidar_tpu.core.config import load_config as jax_load_config
from vidar_tpu.data import rasterize as jax_rasterize
from vidar_tpu.evals import tracking as jax_tracking
from vidar_tpu.uniad import metrics as jax_metrics
from vidar_tpu.uniad import motion_optimization as jax_motion_opt

from tests.data.fake_nuscenes import make_fake_nuscenes
from vidar_tpu_torch.core.builder import NOT_PORTED, build_dataset, \
    build_model
from vidar_tpu_torch.core.config import apply_overrides, load_config
from vidar_tpu_torch.data import collate_samples, rasterize
from vidar_tpu_torch.data.uniad_data import UniADDataset
from vidar_tpu_torch.evals import tracking
from vidar_tpu_torch.uniad import UniAD, metrics, motion_optimization

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = str(ROOT / 'configs' / 'tiny' / 'uniad_tiny.py')
CONFIGS = [str(p.relative_to(ROOT)) for p in
           sorted((ROOT / 'configs' / 'uniad').rglob('*.py'))] + [
    'configs/tiny/uniad_tiny.py']
# the released widths cut to test size, the data on the fixture
TINY_MODEL = [
    'model.embed_dims=32', 'model.bev_h=8', 'model.bev_w=8',
    'model.num_cams=3', 'model.num_query=16', 'model.num_seg_query=12',
    'model.backbone_depth=50', 'model.predict_steps=4',
    'model.predict_modes=2', 'model.occ_n_future=1']
LATENT_RENDER = ("model.latent_render_cfg={'embed_dims': 32, 'pred_height': "
                 "4, 'num_pred_fcs': 0, 'grid_step': 0.5, 'grid_num': 8, "
                 "'reduction': 8, 'act': 'sigmoid'}")


@pytest.fixture(scope='module')
def fake(tmp_path_factory):
    root = tmp_path_factory.mktemp('fake_uniad')
    pkl = make_fake_nuscenes(str(root / 'data'), num_samples=8, num_cams=3,
                             img_hw=(32, 64), num_scenes=2)
    # the same infos without instance tokens: nearest-centre matching
    with open(pkl, 'rb') as f:
        data = pickle.load(f)
    for info in data['infos']:
        info.pop('gt_instance_tokens')
    no_tok = str(root / 'no_tokens.pkl')
    with open(no_tok, 'wb') as f:
        pickle.dump(data, f)
    # map annotations of three samples: a closed crossing, a divider, a
    # closed boundary
    rng = np.random.default_rng(5)
    anns = {}
    for i in (1, 2, 5):
        polys = [rng.uniform(0.1, 0.9, (4, 2)), rng.uniform(-0.2, 1.2, (3, 2)),
                 rng.uniform(0.2, 0.8, (5, 2))]
        anns[f'tok{i}'] = dict(
            boxes=rng.uniform(0.2, 0.8, (3, 4)).astype(np.float32),
            labels=np.array([1, 0, 2], np.int32), polylines=polys,
            closed=np.array([True, False, True]))
    map_pkl = str(root / 'map_anns.pkl')
    with open(map_pkl, 'wb') as f:
        pickle.dump(anns, f)
    return pkl, no_tok, map_pkl


def _arrays(sample):
    """{name: numpy array} of a UniAD sample, JAX's or the port's."""
    frames, targets, command = sample
    out = {'command': np.asarray(command)}
    for obj, prefix in ((frames, 'frames.'), (targets, '')):
        for f in dataclasses.fields(obj) if dataclasses.is_dataclass(
                obj) else []:
            v = getattr(obj, f.name)
            if v is not None:
                out[prefix + f.name] = (v.numpy() if torch.is_tensor(v)
                                        else np.asarray(v))
    if not dataclasses.is_dataclass(targets):          # JAX's NamedTuple
        for k, v in targets._asdict().items():
            if v is not None:
                out[k] = np.asarray(v)
    return out


def _dataset_kwargs(pkl, test_mode, **extra):
    cfg = jax_load_config(TINY)['data']['test' if test_mode else 'train']
    kw = {k: v for k, v in cfg.items() if k != 'type'}
    kw.update(ann_file=pkl, **extra)
    return kw


@pytest.mark.parametrize('case', ['train', 'test', 'no_tokens', 'map',
                                  'queue_2'])
def test_dataset_samples_equal_jax(fake, case):
    from vidar_tpu.data.uniad_data import UniADDataset as JaxUniADDataset
    pkl, no_tok, map_pkl = fake
    extra = {}
    if case == 'no_tokens':
        pkl = no_tok
    elif case == 'map':
        extra = dict(map_ann_file=map_pkl)
    elif case == 'queue_2':
        extra = dict(queue_length=2, predict_steps=3, occ_n_future=2)
    kw = _dataset_kwargs(pkl, case == 'test', **extra)
    jds, tds = JaxUniADDataset(**kw), UniADDataset(**kw)
    assert len(jds) == len(tds) > 0
    seen_map = 0
    for i in range(len(tds)):
        want, got = _arrays(jds[i]), _arrays(tds[i])
        assert set(got) == set(want), i
        for k in want:
            assert got[k].dtype == want[k].dtype, (i, k)
            np.testing.assert_array_equal(got[k], want[k], f'{i}: {k}')
        seen_map += int(want['num_valid_map'][0])
        assert want['track_boxes'].shape[1] >= 2        # a clip
    if case == 'map':
        assert seen_map > 0
    else:
        assert seen_map == 0


def test_collate_stacks_uniad_samples(fake):
    ds = UniADDataset(**_dataset_kwargs(fake[0], False))
    a, b = ds[0], ds[1]
    frames, targets, command = collate_samples([a, b])
    assert frames.images.shape[0] == 2 and command.shape == (2,)
    assert targets.gt_occ.shape[0] == 2 and targets.track_ids.shape[0] == 2
    np.testing.assert_array_equal(targets.gt_boxes[1].numpy(),
                                  b[1].gt_boxes[0].numpy())


@pytest.mark.parametrize('closed', [False, True])
def test_rasterizers_equal_jax(closed):
    rng = np.random.default_rng(7)
    for _ in range(5):
        pts = rng.uniform(-0.3, 1.3, (rng.integers(2, 7), 2))
        np.testing.assert_array_equal(
            rasterize.draw_polyline(pts, 16, 12, closed=closed),
            jax_rasterize.draw_polyline(pts, 16, 12, closed=closed))
        np.testing.assert_array_equal(rasterize.fill_polygon(pts, 16, 12),
                                      jax_rasterize.fill_polygon(pts, 16, 12))


def _tracking_inputs(seed):
    rng = np.random.default_rng(seed)
    preds, gts = {}, {}
    for i in range(12):
        n, m = int(rng.integers(0, 6)), int(rng.integers(1, 5))
        gt_xy = rng.uniform(-20, 20, (m, 2))
        pred_xy = np.concatenate([gt_xy[:min(n, m)] +
                                  rng.normal(0, 0.8, (min(n, m), 2)),
                                  rng.uniform(-20, 20, (max(n - m, 0), 2))])
        preds[f's{i}'] = dict(
            boxes=np.concatenate([pred_xy, np.ones((len(pred_xy), 7))], 1),
            scores=rng.uniform(0, 1, len(pred_xy)),
            labels=rng.integers(0, 2, len(pred_xy)),
            track_ids=rng.integers(0, 4, len(pred_xy)))
        gts[f's{i}'] = dict(
            boxes=np.concatenate([gt_xy, np.ones((m, 7))], 1),
            labels=rng.integers(0, 2, m), track_ids=np.arange(m),
            scene=f'scene{i // 6}')
    return preds, gts


@pytest.mark.parametrize('matcher', ['motmetrics', 'greedy', 'hungarian'])
def test_tracking_eval_equals_jax(matcher):
    preds, gts = _tracking_inputs(3)
    classes = ('car', 'truck')
    got = tracking.evaluate_tracking(preds, gts, classes, matcher=matcher)
    want = jax_tracking.evaluate_tracking(preds, gts, classes,
                                          matcher=matcher)
    assert got == want
    assert 0.0 < got['amota'] <= 1.0 and got['tp'] > 0


def test_motion_and_planning_metrics_equal_jax():
    rng = np.random.default_rng(4)
    got_m, want_m = metrics.MotionMetric(), jax_metrics.MotionMetric()
    got_p, want_p = metrics.PlanningMetric(6), jax_metrics.PlanningMetric(6)
    for _ in range(3):
        trajs = rng.normal(0, 3, (5, 2, 6, 2)).cumsum(2)
        args = (trajs, rng.normal(size=(5, 2)), trajs[:, 0] +
                rng.normal(0, 1, (5, 6, 2)),
                (rng.uniform(size=(5, 6)) > 0.2).astype(np.float32),
                (rng.uniform(size=5) > 0.3).astype(np.float32))
        got_m.update(*args)
        want_m.update(*args)
        plan = rng.normal(0, 2, (1, 6, 2)).cumsum(1)
        seg = (rng.uniform(size=(1, 6, 200, 200)) > 0.97).astype(np.float32)
        pargs = (plan, plan + rng.normal(0, 0.5, plan.shape),
                 np.ones((1, 6)), seg)
        got_p.update(*pargs)
        want_p.update(*pargs)
    assert got_m.compute() == want_m.compute()
    for k, v in want_p.compute().items():
        np.testing.assert_array_equal(got_p.compute()[k], v, k)


def test_occupancy_metrics_equal_jax():
    rng = np.random.default_rng(6)
    got_i, want_i = (metrics.IntersectionOverUnion(3),
                     jax_metrics.IntersectionOverUnion(3))
    got_p, want_p = metrics.PanopticMetric(), jax_metrics.PanopticMetric()
    for _ in range(3):
        pred = rng.integers(0, 3, (4, 16, 16))
        target = rng.integers(0, 3, (4, 16, 16))
        target[0, :2] = 255
        got_i.update(pred, target)
        want_i.update(pred, target)
        inst = rng.integers(0, 4, (3, 16, 16))
        noisy = np.where(rng.uniform(size=inst.shape) > 0.1, inst,
                         rng.integers(0, 4, inst.shape))
        got_p.update(noisy, inst)
        want_p.update(noisy, inst)
    np.testing.assert_array_equal(got_i.compute(), want_i.compute())
    for k, v in want_p.compute().items():
        np.testing.assert_array_equal(got_p.compute()[k], v, k)


def test_trajectory_smoother_equals_jax():
    """Moving agents whose predicted pose is the gt's, so the smoother
    solves (scipy least squares) for some of them."""
    rng = np.random.default_rng(8)
    n = 4
    boxes = np.zeros((n, 9))
    boxes[:, :2] = rng.uniform(-10, 10, (n, 2))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    boxes[:, 7:9] = rng.normal(0, 3, (n, 2))
    step = rng.normal(0, 1, (n, 1, 2)) + np.array([0.0, 1.5])
    fut = boxes[:, None, :2] + np.cumsum(np.repeat(step, 12, 1), 1)
    mask = np.ones((n, 12))
    mask[1, 8:] = 0
    got = motion_optimization.nonlinear_smoother(boxes, fut, mask, boxes)
    want = jax_motion_opt.nonlinear_smoother(boxes, fut, mask, boxes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # at least one agent was smoothed (its offsets differ from the gt's)
    plain = fut - boxes[:, None, :2]
    assert not np.allclose(got[0], plain)


@pytest.mark.parametrize('path', CONFIGS)
def test_uniad_configs_build_through_the_port(fake, path):
    assert NOT_PORTED == ()
    opts = TINY_MODEL + [f'data.train.ann_file={fake[0]}',
                         f'data.test.ann_file={fake[0]}',
                         'data.train.bev_size=(8,8)',
                         'data.test.bev_size=(8,8)']
    cfg = apply_overrides(load_config(str(ROOT / path)), opts)
    if cfg['model'].get('latent_render_lids'):
        cfg = apply_overrides(cfg, [LATENT_RENDER])
    model = build_model(cfg['model'], device='cpu')
    assert isinstance(model, UniAD)
    model.init_weights_(torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    jcfg = jax_apply_overrides(jax_load_config(str(ROOT / path)), opts)
    for split in ('train', 'test'):
        ds = build_dataset(cfg['data'][split])
        assert isinstance(ds, UniADDataset)
        assert len(ds) == len(jax_build_dataset(jcfg['data'][split]))


def test_motion_horizon_longer_than_the_plan():
    """The released configs predict 12 motion steps and plan 6, and have 5
    occupancy blocks against 4 gt frames, two shapes where the JAX
    package's loss fails: the ego's motion gt is its plan padded with
    invalid steps, the occupancy loss holds block k + 1 to gt frame k,
    and a clip step trains."""
    from vidar_tpu_torch.data import make_synthetic_batch
    from vidar_tpu_torch.train import UniADTrainStep, make_optimizer
    from vidar_tpu_torch.uniad.loss import UniADTargets
    cfg = apply_overrides(load_config(TINY), ['model.predict_steps=8',
                                              'model.occ_n_future=2'])['model']
    model = build_model(cfg, device='cpu')
    model.init_weights_(torch.Generator().manual_seed(0))
    frames = make_synthetic_batch(np.random.default_rng(0), bs=1,
                                  queue_length=1, future_length=1,
                                  num_cams=3, img_h=64, img_w=64,
                                  max_points=32, device='cpu')
    rng = np.random.default_rng(1)
    g, tc = 4, 2
    boxes = np.zeros((1, g, 9), np.float32)
    boxes[0, :, :2] = rng.uniform(-20, 20, (g, 2))
    boxes[0, :, 3:6] = 2.0
    t10 = np.zeros((1, tc, g, 10), np.float32)
    t10[..., :2] = boxes[:, None, :, :2]
    t10[..., 2:4] = np.log(2.0)
    t10[..., 7] = 1.0
    arrays = dict(
        gt_boxes=boxes, gt_labels=np.zeros((1, g), np.int32),
        num_valid_gt=np.array([g], np.int32),
        map_boxes=np.full((1, 2, 4), 0.5, np.float32),
        map_labels=np.zeros((1, 2), np.int32),
        num_valid_map=np.array([1], np.int32),
        gt_traj=rng.normal(size=(1, g, 8, 2)).astype(np.float32),
        gt_traj_valid=np.ones((1, g, 8), np.float32),
        sdc_traj=rng.normal(size=(1, 6, 3)).astype(np.float32),
        sdc_mask=np.ones((1, 6), np.float32),
        gt_occ=(rng.uniform(size=(1, g, 2, 8, 8)) > 0.5).astype(np.float32),
        map_masks=np.zeros((1, 2, 8, 8), np.float32), track_boxes=t10,
        track_labels=np.zeros((1, tc, g), np.int32),
        track_ids=np.tile(np.arange(g, dtype=np.int32), (1, tc, 1)),
        track_num=np.full((1, tc), g, np.int32),
        l2g_r=np.tile(np.eye(3, dtype=np.float32), (1, tc, 1, 1)),
        l2g_t=np.zeros((1, tc, 3), np.float32),
        timestamp=np.array([[0.0, 0.5]], np.float32))
    targets = UniADTargets(**{k: torch.from_numpy(v)
                              for k, v in arrays.items()})
    step = UniADTrainStep(model, make_optimizer(model, device='cpu'),
                          device='cpu')
    metrics = step((frames, targets, torch.ones(1, dtype=torch.int32)))
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert metrics['motion.loss'] > 0 and metrics['occ.loss'] > 0


@pytest.mark.parametrize('t_gt,first_block', [(2, 1), (3, 0), (1, 0)])
def test_occupancy_blocks_pair_with_their_gt_frames(t_gt, first_block):
    """The occupancy head gives n_future + 1 blocks, block 0 the present;
    the dataset's gt holds the future frames only. With fewer gt frames
    than blocks (the released configs: 5 blocks, 4 frames) block k + 1
    is held to gt[k] and block 0 is free; with as many frames as blocks,
    or one (broadcast over every block), the blocks pair as in the JAX
    package. Logits of +-30 where the pairing puts each slot's gt give a
    loss near 0, a free block changes nothing, and the same logits one
    block off do not fit."""
    from vidar_tpu_torch.uniad.loss import occ_loss
    rng = np.random.default_rng(0)
    g, blocks = 3, 3
    gt = torch.from_numpy(
        (rng.uniform(size=(1, g, t_gt, 8, 8)) > 0.5).astype(np.float32))
    a_safe = torch.tensor([[2, 0, 1]])          # slot i holds gt row a[i]
    pos = torch.ones(1, g, dtype=torch.bool)
    slot_gt = gt[:, a_safe[0]]
    logits = torch.from_numpy(
        rng.normal(size=(1, g, blocks, 8, 8)).astype(np.float32))
    paired = {b: (b - first_block if t_gt > 1 else 0)
              for b in range(blocks)
              if t_gt == 1 or first_block <= b < first_block + t_gt}
    for b, k in paired.items():
        logits[:, :, b] = 30.0 * (2.0 * slot_gt[:, :, k] - 1.0)
    loss = float(occ_loss(logits, gt, a_safe, pos))
    assert loss < 1e-4, loss
    for b in set(range(blocks)) - set(paired):
        moved = logits.clone()
        moved[:, :, b] = 5.0 - moved[:, :, b]
        assert float(occ_loss(moved, gt, a_safe, pos)) == loss
    if t_gt > 1:
        shifted = torch.roll(logits, 1, dims=2)
        assert float(occ_loss(shifted, gt, a_safe, pos)) > 0.1


def test_motion_anchors_load_once_at_build(tmp_path):
    """``anchor_info_path``'s k-means anchors become the model's anchors
    buffer when it is built (not in its state dict), equal to the JAX
    package's loader's; a file of another shape is refused at build; no
    file gives the radial fan."""
    from vidar_tpu.uniad.motion_head import \
        load_motion_anchors as jax_load_anchors
    from vidar_tpu_torch.uniad.motion_head import default_anchors
    rng = np.random.default_rng(0)
    groups = [rng.normal(size=(2, 4, 2)).astype(np.float32)
              for _ in range(4)]
    good, bad = tmp_path / 'anchors.pkl', tmp_path / 'bad.pkl'
    good.write_bytes(pickle.dumps({'anchors_all': groups}))
    bad.write_bytes(pickle.dumps({'anchors_all': [g[:, :3] for g in
                                                  groups]}))
    cfg = apply_overrides(load_config(TINY), TINY_MODEL)['model']
    model = build_model(dict(cfg, anchor_info_path=str(good)), device='cpu')
    np.testing.assert_array_equal(model.anchors.numpy(),
                                  np.asarray(jax_load_anchors(str(good))))
    assert 'anchors' not in model.state_dict()
    with pytest.raises(ValueError, match='anchors of shape'):
        build_model(dict(cfg, anchor_info_path=str(bad)), device='cpu')
    np.testing.assert_array_equal(
        build_model(cfg, device='cpu').anchors.numpy(),
        default_anchors(4, 2, 4))
