"""The released config matrix in the port: every config under ``configs/``
loads as the JAX package loads it; each released config that
``chip_smoke.py`` does not run builds the model of one it runs and differs
from it only in the data and schedule leaves listed here; and every
released config is one of the two, so the matrix stays closed. Cheap: no
model is built, nothing is traced."""

import pathlib

import pytest

from vidar_tpu.core import config as jax_config

import chip_smoke
from vidar_tpu_torch.core import config

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT))
                 for p in ROOT.glob('configs/**/*.py')
                 if '_base_' not in p.parts)
# the repository's own small configs, for tests and smoke runs
RELEASED = [p for p in CONFIGS if not p.startswith('configs/tiny/')]

# a released config chip_smoke.py does not run -> (the config it runs whose
# model dict it shares, the leaves that differ: data leaves, and the
# schedule keys of RUN_KEYS)
EQUIVALENT = {
    'configs/bevformer/bevformer_base.py': (
        'configs/vidar_finetune/nusc_1_4_subset/bevformer_1_4_baseline.py',
        {'data.train.use_pretrain_data', 'evaluation.interval'}),
    'configs/vidar_pretrain/OpenScene/vidar_OpenScene_mini_full_3future.py': (
        'configs/vidar_pretrain/OpenScene/vidar_OpenScene_mini_1_8_3future.py',
        {'data.train.load_frame_interval'}),
    'configs/vidar_pretrain/OpenScene/vidar_OpenScene_train_1_8_3future.py': (
        'configs/vidar_pretrain/OpenScene/vidar_OpenScene_mini_1_8_3future.py',
        {'data.train.ann_file', 'data.test.ann_file'}),
    'configs/vidar_pretrain/OpenScene/vidar_OpenScene_train_full_3future.py': (
        'configs/vidar_pretrain/OpenScene/vidar_OpenScene_mini_1_8_3future.py',
        {'data.train.ann_file', 'data.test.ann_file',
         'data.train.load_frame_interval'}),
    'configs/vidar_pretrain/nusc_1_8_subset/vidar_1_8_nusc_1future.py': (
        'configs/vidar_pretrain/nusc_fullset/vidar_full_nusc_1future.py',
        {'data.train.ann_file', 'data.train.load_frame_interval',
         'total_epochs'}),
    'configs/vidar_finetune/nusc_fullset/vidar_full_nusc_1future.py': (
        'configs/vidar_finetune/nusc_1_4_subset/vidar_1_8_nusc_3future.py',
        {'data.train.use_pretrain_data'}),
}
# the top-level keys that change what the train CLI does beside the model
# and the data
RUN_KEYS = ('optimizer', 'grad_clip_norm', 'total_epochs', 'evaluation',
            'ema', 'samples_per_gpu', 'log_interval',
            'checkpoint_interval_steps')


def _leaves(d, prefix=''):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f'{prefix}{k}.'))
        else:
            out[f'{prefix}{k}'] = v
    return out


def _run_leaves(cfg):
    return _leaves({k: cfg[k] for k in ('data',) + RUN_KEYS if k in cfg})


def _chip_smoke_configs():
    """The configs ``chip_smoke.py`` names in a module constant that its
    code reads -> {config path: constant name}."""
    src = (ROOT / 'chip_smoke.py').read_text()
    out = {}
    for name, v in vars(chip_smoke).items():
        if (isinstance(v, pathlib.Path) and v.suffix == '.py'
                and 'configs' in v.parts and src.count(name) >= 2):
            out[str(v.relative_to(ROOT))] = name
    return out


@pytest.mark.parametrize('path', CONFIGS)
def test_config_loading_matches_jax(path):
    full = str(ROOT / path)
    opts = ['model.embed_dims=64', 'data.train.queue_length=2',
            'new.key=(1, 2)', 'optimizer.name=adamw']
    want = jax_config.apply_overrides(jax_config.load_config(full), opts)
    got = config.apply_overrides(config.load_config(full), opts)
    assert got == want
    assert config.dump_config(got) == jax_config.dump_config(want)


@pytest.mark.parametrize('path', sorted(EQUIVALENT))
def test_config_is_held_to_one_that_runs(path):
    sibling, differ = EQUIVALENT[path]
    cfg, run = (config.load_config(str(ROOT / p)) for p in (path, sibling))
    assert sibling in _chip_smoke_configs()
    assert cfg['model'] == run['model']
    a, b = _run_leaves(cfg), _run_leaves(run)
    missing = object()
    got = {k for k in set(a) | set(b)
           if a.get(k, missing) != b.get(k, missing)}
    assert got == differ


def test_every_released_config_runs_or_is_held_to_one():
    run = _chip_smoke_configs()
    assert set(RELEASED) == set(run) - {
        p for p in run if p.startswith('configs/tiny/')} | set(EQUIVALENT)
    assert not set(run) & set(EQUIVALENT)
    assert len(RELEASED) == 20
