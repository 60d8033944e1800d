"""The PyTorch port's forecast slice against the JAX ``ViDAR`` eval.

Both models get the same weights (a numpy-seeded tree, carried over with
``state_dict_from_jax``) and the same synthetic batch, at ``vidar_dryrun``
and the ``BENCH_SMOKE`` shapes of bench.py:55. Everything runs in f32 on the
CPU, where the JAX package takes its XLA forms and the port its plain
PyTorch kernel versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vidar_tpu.configs import vidar_dryrun
from vidar_tpu.data import make_synthetic_batch as jax_synthetic_batch
from vidar_tpu.evals.forecast_runner import ForecastRunner as JaxRunner
from vidar_tpu.models import ViDAR as JaxViDAR

from vidar_tpu_torch.convert import state_dict_from_jax
from vidar_tpu_torch.data import ViDARBatch, make_synthetic_batch
from vidar_tpu_torch.evals.forecast_runner import ForecastRunner
from vidar_tpu_torch.models import ViDAR

SHAPES = dict(bs=1, queue_length=2, future_length=2, num_cams=3, img_h=64,
              img_w=64, max_points=128)
# backbone features, encoded BEV and rollout predictions: the two sides run
# the same f32 arithmetic in different orders (convolution algorithms,
# reductions) through up to 50 conv layers and the BEV recurrence; 1e-3 of
# the reference's largest magnitude bounds that drift with room to spare
REL_TOL = 1e-3


def _random_params(shapes, seed=0):
    """Numpy-seeded weights with unit-scale activations: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1), biases N(0, 0.1),
    embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == 'kernel':
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            v = rng.standard_normal(s.shape) * std
        elif name == 'scale':
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == 'bias':
            v = 0.1 * rng.standard_normal(s.shape)
        else:
            v = rng.standard_normal(s.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope='module')
def models():
    cfg = vidar_dryrun()
    jax_model = JaxViDAR(**cfg)
    jbatch = jax_synthetic_batch(np.random.default_rng(0), **SHAPES)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jax_model.init(
        {'params': key, 'dropout': key}, jbatch, train=False))
    params = _random_params(shapes)
    torch_model = ViDAR(**cfg, device='cpu').eval()     # dropout off
    torch_model.load_state_dict(state_dict_from_jax(params), strict=True)
    tbatch = make_synthetic_batch(np.random.default_rng(0), **SHAPES,
                                  device='cpu')
    return cfg, jax_model, params, jbatch, torch_model, tbatch


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= REL_TOL * scale, f'{what}: max err {err} vs max|ref| {scale}'


def test_synthetic_batches_identical(models):
    _, _, _, jbatch, _, tbatch = models
    import dataclasses
    for f in dataclasses.fields(ViDARBatch):
        want = np.asarray(getattr(jbatch, f.name))
        got = getattr(tbatch, f.name).numpy()
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


def test_state_dict_consumes_every_leaf(models):
    cfg, _, params, jbatch, torch_model, _ = models
    # the preset, then a deformable conv in every ResNet stage: the offset
    # conv and kernel of a stage-1 or stage-2 block are carried too
    all_dcn = dict(cfg, backbone_dcn=(True, True, True, True))
    key = jax.random.PRNGKey(0)
    dcn_params = jax.eval_shape(lambda: JaxViDAR(**all_dcn).init(
        {'params': key, 'dropout': key}, jbatch, train=False))
    dcn_params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), dcn_params)
    for params, torch_model in (
            (params, torch_model),
            (dcn_params, ViDAR(**all_dcn, device='cpu'))):
        sd = state_dict_from_jax(params)
        assert len(sd) == len(jax.tree_util.tree_leaves(params))
        assert set(sd) == set(torch_model.state_dict())
        missing, unexpected = torch_model.load_state_dict(sd, strict=True)
        assert not missing and not unexpected
    assert any(k.startswith('img_backbone.layer1_0.conv2.conv_offset.')
               for k in sd)


def test_forecast_phases_match_jax(models):
    cfg, jax_model, params, jbatch, torch_model, tbatch = models
    img_hw = (SHAPES['img_h'], SHAPES['img_w'])
    num_future = cfg['test_future_frame_num']
    jr = JaxRunner(jax_model, params, img_hw, num_future=num_future)
    bs, t, cams, h, w, _ = jbatch.images.shape

    # phase 1: backbone + FPN
    j_feats = jr._backbone(params, jbatch.images.reshape(bs * t * cams, h, w,
                                                         3))
    with torch.inference_mode():
        t_feats = torch_model.backbone_forward(
            tbatch.images.reshape(bs * t * cams, h, w, 3))
    assert len(t_feats) == len(j_feats) == 4
    for i, (a, b) in enumerate(zip(t_feats, j_feats)):
        _close(a, b, f'fpn level {i}')

    # phase 2: the encoder over every history frame, each side on its own
    j_feats = [x.reshape((bs, t, cams) + x.shape[1:]) for x in j_feats]
    t_feats = [x.reshape((bs, t, cams) + tuple(x.shape[1:]))
               for x in t_feats]
    n, c = cfg['bev_h'] * cfg['bev_w'], cfg['embed_dims']
    j_bev = jnp.zeros((bs, n, c), jnp.float32)
    t_bev = torch.zeros(bs, n, c)
    for f in range(t):
        j_bev = jr._encode(params, [x[:, f] for x in j_feats],
                           jbatch.can_bus[:, f], jbatch.shift[:, f],
                           jbatch.rotate_angle[:, f], jbatch.lidar2img[:, f],
                           j_bev, jbatch.prev_bev_exists[:, f])
        with torch.inference_mode():
            t_bev = torch_model.encode_single(
                [x[:, f] for x in t_feats], tbatch.can_bus[:, f],
                tbatch.shift[:, f], tbatch.rotate_angle[:, f],
                tbatch.lidar2img[:, f], t_bev, tbatch.prev_bev_exists[:, f],
                img_hw)
        _close(t_bev, j_bev, f'encoded BEV, frame {f}')

    # phase 3: the rollout
    hq = cfg['history_queue_length']
    dims = [0, 1, 2, 17]
    j_prev, j_r2h = j_bev[:, None], jbatch.ref2cur[:, hq][:, None]
    t_prev, t_r2h = t_bev[:, None], tbatch.ref2cur[:, hq][:, None]
    for fi in range(1, num_future + 1):
        j_pred, j_r2h = jr._rollout(params, j_prev, j_r2h,
                                    jbatch.future2ref[:, fi],
                                    jbatch.ref2future[:, fi],
                                    jbatch.future_can_bus[:, fi][:, dims])
        with torch.inference_mode():
            t_pred, t_r2h = torch_model.rollout_single(
                t_prev, t_r2h, tbatch.future2ref[:, fi],
                tbatch.ref2future[:, fi],
                tbatch.future_can_bus[:, fi][:, dims])
        _close(t_pred, j_pred, f'rollout prediction, future {fi}')
        j_prev, t_prev = j_pred[-1][:, None], t_pred[-1][:, None]

    # phase 4: the whole runner, down to the depth decode
    want = jr(jbatch)
    got = ForecastRunner(torch_model, img_hw, num_future=num_future,
                         device='cpu')(tbatch)
    valid = np.asarray(want['frame_idx']) >= 0
    assert valid.sum() > 0
    np.testing.assert_array_equal(got['frame_idx'].numpy(),
                                  np.asarray(want['frame_idx']))
    # gt distances are pure f32 geometry: a few ulps of 50 m
    np.testing.assert_allclose(got['gt_dist'].numpy()[valid],
                               np.asarray(want['gt_dist'])[valid],
                               rtol=0, atol=1e-5)
    # a predicted distance is the length of the argmax waypoint: equal up to
    # the f32 rounding of that length (waypoints lie 6.4 m apart here), and
    # the argmax flips only on near ties
    same = np.abs(got['pred_dist'].numpy()[valid] -
                  np.asarray(want['pred_dist'])[valid]) <= 1e-4
    assert same.mean() >= 0.99, same.mean()
    assert np.isfinite(got['pred_dist'].numpy()).all()
