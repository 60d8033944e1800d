"""The port's train and test CLIs, run in this process on the CPU
(``--device cpu``) on the fake on-disk dataset of
``tests/data/fake_nuscenes.py``.

* The slice as a whole: the forecast metrics of ``tools.test`` on fake
  sample 0, at ``configs/tiny/vidar_tiny.py``'s model with weights carried
  from a JAX parameter tree (``state_dict_from_jax``) into a checkpoint of
  the port, against the JAX package's ``ForecastRunner`` +
  ``forecast_metrics`` on the same sample.
* Pre-training: 2 steps, a resume to a 3rd, ``ema_latest`` with ``ema``
  set, then the test CLI on the checkpoint.
* The fine-tune config shrunk by ``--cfg-options`` to the sizes of
  tests/e2e/test_finetune_smoke.py: 1 step from the pre-training
  checkpoint, then the detection eval, full window and streaming.
"""

import json
import os
import pathlib
import pickle

import numpy as np
import pytest
import torch

import jax

from vidar_tpu.core.builder import build_dataset as jax_build_dataset
from vidar_tpu.core.builder import build_model as jax_build_model
from vidar_tpu.core.config import apply_overrides as jax_apply_overrides
from vidar_tpu.core.config import load_config as jax_load_config
from vidar_tpu.evals.forecast_runner import ForecastRunner as JaxRunner
from vidar_tpu.evals.metrics import forecast_metrics as jax_forecast_metrics

from tests.data.fake_nuscenes import make_fake_nuscenes
from vidar_tpu_torch.convert import state_dict_from_jax
from vidar_tpu_torch.core.builder import build_dataset, build_model
from vidar_tpu_torch.core.checkpoint import (load_params_partial,
                                             save_checkpoint)
from vidar_tpu_torch.core.config import apply_overrides, load_config
from vidar_tpu_torch.device import use_f32_convolutions
from vidar_tpu_torch.evals.forecast_runner import ForecastRunner
from vidar_tpu_torch.evals.metrics import forecast_metrics
from vidar_tpu_torch.tools import test as test_cli
from vidar_tpu_torch.tools import train as train_cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = str(ROOT / 'configs' / 'tiny' / 'vidar_tiny.py')
FINETUNE = str(ROOT / 'configs' / 'vidar_finetune' / 'nusc_1_4_subset' /
               'vidar_1_8_nusc_3future.py')
# the sizes of tests/e2e/test_finetune_smoke.py:16-31, and a 2-frame queue
FINETUNE_TINY = [
    'model.embed_dims=32', 'model.bev_h=12', 'model.bev_w=12',
    'model.num_cams=3', 'model.num_query=24', 'model.backbone_depth=50',
    'model.encoder_num_layers=2', 'model.latent_render_lids=(1,)',
    "model.latent_render_cfg={'pred_height': 4, 'grid_num': 8, "
    "'grid_step': 0.5, 'reduction': 8, 'act': 'sigmoid', 'embed_dims': 32}",
    'data.train.bev_size=(12,12)', 'data.test.bev_size=(12,12)',
    'data.train.queue_length=2', 'data.test.queue_length=2',
    'log_interval=1']
# the metrics of one sample: sums over the same rays of the same f32
# geometry, the predicted depths equal but for f32 rounding
METRIC_RTOL = 1e-3


@pytest.fixture(scope='module')
def fake(tmp_path_factory):
    root = tmp_path_factory.mktemp('cli')
    pkl = make_fake_nuscenes(str(root / 'data'), num_samples=6, num_cams=3,
                             img_hw=(64, 96))
    data = [f'data.train.ann_file={pkl}', f'data.test.ann_file={pkl}']
    return root, data


@pytest.fixture(scope='module')
def pretrained(fake):
    """A 2-step pre-training run with EMA on: its work dir and what the CLI
    returned."""
    root, data = fake
    work = str(root / 'pretrain')
    out = train_cli.main([TINY, '--work-dir', work, '--max-steps', '2',
                          '--device', 'cpu', '--deterministic',
                          '--cfg-options', *data, 'log_interval=1',
                          'ema.mode=linear', 'ema.momentum=0.5'])
    return work, out


def _finite(values):
    return all(np.isfinite(float(v)) for v in values)


def test_forecast_metrics_match_jax(fake, tmp_path):
    root, data = fake
    cfg = jax_apply_overrides(jax_load_config(TINY), data)
    jmodel = jax_build_model(cfg['model'])
    # the port's sample 0 and JAX's, on the port's lidar points: above
    # max_points the port's test split draws the window's subsample from
    # (seed, frame index), JAX's from its dataset's stream (ROADMAP.md §3,
    # departures)
    tcfg = apply_overrides(load_config(TINY), data)
    tbatch = build_dataset(tcfg['data']['test'])[0]
    jbatch = jax_build_dataset(cfg['data']['test'])[0].replace(
        gt_points=jax.numpy.asarray(tbatch.gt_points.numpy()),
        gt_tindex=jax.numpy.asarray(tbatch.gt_tindex.numpy()))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': key, 'dropout': key}, jbatch, train=False))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        # unit-scale activations: kernels N(0, 1/fan_in), norm scales
        # 1 + N(0, 0.1), biases N(0, 0.1), embeddings N(0, 1)
        name, x = path[-1].key, rng.standard_normal(s.shape)
        if name == 'kernel':
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        elif name == 'scale':
            x = 1.0 + 0.1 * x
        elif name == 'bias':
            x = 0.1 * x
        return np.asarray(x, np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    num_future = cfg['model']['test_future_frame_num']
    want = JaxRunner(jmodel, params, jbatch.images.shape[3:5],
                     num_future=num_future)(jbatch)
    ckpt = str(tmp_path / 'from_jax')
    save_checkpoint(ckpt, {'model': state_dict_from_jax(params), 'step': 0})

    # the decode of the port's runner on the port's sample 0, the model
    # loaded from that checkpoint: test_torch_vidar.py's tolerances
    model = build_model(tcfg['model'], device='cpu').eval()
    assert load_params_partial(ckpt, model) == (len(model.state_dict()), 0)
    got = ForecastRunner(model, tbatch.images.shape[3:5],
                         num_future=num_future, device='cpu')(tbatch)
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    np.testing.assert_array_equal(got['frame_idx'], want['frame_idx'])
    valid = want['frame_idx'] >= 0
    np.testing.assert_allclose(got['gt_dist'][valid], want['gt_dist'][valid],
                               rtol=0, atol=1e-5)
    same = np.abs(got['pred_dist'] - want['pred_dist']) <= 1e-4
    assert same[valid].mean() >= 0.99, same[valid].mean()

    # the CLI's metrics against JAX's; where an argmax near tie flipped a
    # ray, both sides' metrics on the rays that agree (the flipped ones
    # set invalid: gt distance 0)
    out = str(tmp_path / 'metrics.json')
    cli = test_cli.main([TINY, ckpt, '--max-samples', '1', '--out', out,
                         '--device', 'cpu', '--cfg-options', *data])
    assert json.load(open(out)) == cli
    pc_range = cfg['model']['pc_range']
    mine = forecast_metrics(got, pc_range, num_future + 1, device='cpu')
    assert mine == cli
    if not same.all():
        print(f'{int((~same & valid).sum())} of {int(valid.sum())} rays '
              f'flipped on an argmax near tie; metrics on the rest')
        for d in (got, want):
            d['gt_dist'] = np.where(same, d['gt_dist'], 0.0)
        mine = forecast_metrics(got, pc_range, num_future + 1, device='cpu')
    ref = jax_forecast_metrics(want, pc_range, num_future + 1)
    assert sorted(mine) == sorted(ref) == [f'frame.{f}' for f in
                                           range(num_future + 1)]
    for fk, fv in ref.items():
        for k, v in fv.items():
            np.testing.assert_allclose(mine[fk][k], v, rtol=METRIC_RTOL,
                                       err_msg=f'{fk}.{k}')


def test_train_resume_ema_and_test(fake, pretrained):
    root, data = fake
    work, out = pretrained
    assert out['step'] == 2 and len(out['log']) == 2
    for m in out['log']:
        assert _finite(m.values()) and m['lr'] > 0 and m['it/s'] > 0
    for d in ('latest', 'ema_latest'):
        assert os.path.isfile(os.path.join(work, d, 'model.pt')), d
    assert os.path.isfile(os.path.join(work, 'config_dump.txt'))
    ema = torch.load(os.path.join(work, 'ema_latest', 'model.pt'))
    last = torch.load(os.path.join(work, 'latest', 'model.pt'))
    assert sorted(ema) == sorted(last)
    assert any(not torch.equal(ema[k], last[k]) for k in last)

    # resume to a 3rd step: the step, the moments and the schedule go on
    resumed = train_cli.main([TINY, '--work-dir', work, '--max-steps', '3',
                              '--device', 'cpu', '--deterministic',
                              '--resume-from', os.path.join(work, 'latest'),
                              '--cfg-options', *data, 'log_interval=1'])
    assert resumed['step'] == 3 and len(resumed['log']) == 1
    assert _finite(resumed['log'][0].values())
    opt = torch.load(os.path.join(work, 'latest', 'optimizer.pt'))
    assert opt['count'] == 3

    sub = str(root / 'submission')
    metrics = test_cli.main([TINY, os.path.join(work, 'latest'),
                             '--max-samples', '1', '--device', 'cpu',
                             '--submission', '--submission-path', sub,
                             '--cfg-options', *data])
    assert sorted(metrics) == ['frame.0', 'frame.1']
    assert _finite(v for fv in metrics.values() for v in fv.values())
    # one depth file for each future frame of the sample
    assert os.listdir(sub) == ['sample0_1.txt']


def test_forecast_eval_does_not_depend_on_load_order(fake):
    # the test CLI twice in one process on 4 loader threads: each window
    # holds more lidar points than max_points (3 frames of about 768
    # against 256), and each sample's subsample is drawn from (seed, frame
    # index), whatever was loaded before it, so the metrics are equal
    _, data = fake
    argv = [TINY, '--max-samples', '3', '--device', 'cpu', '--cfg-options',
            *data]
    first = test_cli.main(argv)
    assert _finite(v for fv in first.values() for v in fv.values())
    assert test_cli.main(argv) == first


def test_clis_compute_an_f32_models_convolutions_in_f32(fake, tmp_path,
                                                         monkeypatch):
    # cuDNN's TF32 switch as each CLI's model runs: off for an f32 model,
    # whatever the caller set (PyTorch's default is on); the caller's
    # setting back after each CLI
    _, data = fake
    seen = []
    step, runner = train_cli.TrainStep.__call__, ForecastRunner.__call__
    monkeypatch.setattr(train_cli.TrainStep, '__call__', lambda self, b: (
        seen.append(torch.backends.cudnn.allow_tf32) or step(self, b)))
    monkeypatch.setattr(ForecastRunner, '__call__', lambda self, b: (
        seen.append(torch.backends.cudnn.allow_tf32) or runner(self, b)))
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    work = str(tmp_path / 'work')
    train_cli.main([TINY, '--work-dir', work, '--max-steps', '1', '--device',
                    'cpu', '--cfg-options', *data])
    assert torch.backends.cudnn.allow_tf32
    test_cli.main([TINY, os.path.join(work, 'latest'), '--max-samples', '1',
                   '--device', 'cpu', '--cfg-options', *data])
    assert seen == [False, False] and torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize('dtype', [None, torch.bfloat16],
                         ids=['float32', 'bfloat16'])
def test_only_an_f32_model_turns_tf32_off(monkeypatch, dtype):
    cfg = load_config(TINY)['model']
    model = build_model(cfg, device='cpu', dtype=dtype)
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    use_f32_convolutions(model)
    assert torch.backends.cudnn.allow_tf32 == (dtype is not None)


@pytest.fixture(scope='module')
def finetuned(fake, pretrained):
    root, data = fake
    work = str(root / 'finetune')
    out = train_cli.main([FINETUNE, '--work-dir', work, '--max-steps', '1',
                          '--device', 'cpu', '--load-from',
                          os.path.join(pretrained[0], 'latest'),
                          '--cfg-options', *data, *FINETUNE_TINY])
    return work, out


def test_finetune_from_pretrain_checkpoint(finetuned):
    work, out = finetuned
    assert out['loaded'] > 0 and out['step'] == 1
    assert _finite(out['log'][0].values())
    assert any(k.startswith('d0.loss_cls') for k in out['log'][0])
    assert os.path.isfile(os.path.join(work, 'latest', 'model.pt'))


@pytest.mark.parametrize('streaming', [False, True],
                         ids=['window', 'streaming'])
def test_detection_eval(fake, finetuned, streaming, tmp_path):
    _, data = fake
    viz = str(tmp_path / 'viz.pkl')
    metrics = test_cli.main(
        [FINETUNE, os.path.join(finetuned[0], 'latest'), '--max-samples',
         '3', '--device', 'cpu', '--dump-viz', viz,
         *(['--streaming'] if streaming else []),
         '--cfg-options', *data, *FINETUNE_TINY])
    assert {'NDS', 'mAP', 'mATE'} <= set(metrics)
    assert _finite(metrics.values())
    with open(viz, 'rb') as f:
        dump = pickle.load(f)
    assert sorted(dump) == ['s0', 's1', 's2']
    assert dump['s0']['images'].shape == (3, 64, 96, 3)


def test_builder_contract():
    cfg = load_config(TINY)['model']
    with pytest.raises(KeyError, match='unknown model type'):
        build_model(dict(cfg, type='NoSuchModel'), device='cpu')
    # every model type of the JAX package's builder is ported
    assert type(build_model(dict(type='BEVFormerV2', embed_dims=32, bev_h=4,
                                 bev_w=4, num_query=8, backbone_depth=50),
                            device='cpu')).__name__ == 'BEVFormerV2'
    # the JAX CLI's remat switch is taken and dropped; a dtype string from
    # --cfg-options names a torch dtype
    model = build_model(dict(cfg, remat=True, dtype='bfloat16'),
                        device='cpu')
    assert model.img_backbone.conv1.dtype == torch.bfloat16
    assert model.img_backbone.conv1.weight.dtype == torch.float32
    # a reference .pth goes through import_torch_checkpoint
    # (tests/test_torch_pth_import.py), not the directory loader
    with pytest.raises(ValueError, match='.pth'):
        load_params_partial('weights.pth', model)
    # UniAD builds (its CLIs: tests/test_torch_uniad_cli.py)
    uniad = load_config(str(ROOT / 'configs' / 'tiny' / 'uniad_tiny.py'))
    assert type(build_model(uniad['model'], device='cpu')).__name__ == 'UniAD'


@pytest.mark.parametrize('flag', [['--viz-pcd'], ['--viz-path', 'dbg']],
                         ids=['viz-pcd', 'viz-path'])
def test_unported_viz_flags_raise(flag):
    # the JAX CLI's point-cloud plot flags, with its default path; the
    # plots themselves: tests/test_torch_visualize.py
    args = test_cli.parse_args([str(TINY), *flag, '--device', 'cpu'])
    assert args.viz_pcd == (flag[0] == '--viz-pcd')
    assert args.viz_path == (flag[1] if len(flag) > 1 else 'dbg/pred_pcd')
    assert test_cli.parse_args([str(TINY)]).viz_path == 'dbg/pred_pcd'


def test_init_weights_follow_jax_conventions():
    from vidar_tpu.models.attention import _offset_grid_bias
    from vidar_tpu_torch.models.attention import offset_grid_bias
    np.testing.assert_array_equal(offset_grid_bias(8, 2, 4),
                                  _offset_grid_bias(8, 2, 4))
    model = build_model(load_config(TINY)['model'], device='cpu')
    model.init_weights_(torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    for name, p in params.items():
        assert torch.isfinite(p).all(), name
        if '.conv_offset.' in name or name.endswith(
                'attention_weights.weight'):
            assert not p.any(), name
        elif p.dim() == 4:
            assert p.abs().max() <= 1 / np.prod(p.shape[1:]) ** 0.5, name
    tsa = [n for n in params if n.endswith('sampling_offsets.bias')][0]
    assert params[tsa].abs().max() > 0
