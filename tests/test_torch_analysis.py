"""The port's analysis tools (``tools/analysis.py``) and phase timers
(``core/timing.py``) against the JAX package's, on the CPU.

``count_params`` equals JAX's on the tiny ViDAR configs, in total and by
top-level module (JAX's count sums every leaf of the init tree, the frozen
BatchNorms' folded scale and bias included, which the port keeps as
buffers; JAX's builds ``ViDAR(**model)`` alone, so it is given the config's
model without its ``type``, and cannot count the tiny UniAD); ``analyze_logs`` reads what the port's train CLI
printed, run in-process, as JAX's does; ``visibility_scan`` reports what
JAX's reports on ``tests/data/fake_nuscenes.py``. ``benchmark`` and
``profile_trace`` run the model at 928x1600 and run on the card
(``chip_smoke.py`` phase 12).
"""

import contextlib
import io
import pathlib

import pytest
import torch

import jax

from vidar_tpu.tools import analysis as jax_analysis

from tests.data.fake_nuscenes import make_fake_nuscenes
from vidar_tpu_torch.core import timing
from vidar_tpu_torch.core.builder import build_model
from vidar_tpu_torch.core.config import load_config
from vidar_tpu_torch.tools import analysis
from vidar_tpu_torch.tools import train as train_cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = str(ROOT / 'configs' / 'tiny' / 'vidar_tiny.py')


@pytest.mark.parametrize('config', ['vidar_tiny.py',
                                    'vidar_tiny_openscene.py'])
def test_count_params_equals_jax(config, tmp_path, monkeypatch):
    config = str(ROOT / 'configs' / 'tiny' / config)
    model = dict(load_config(config)['model'])
    assert model.pop('type') == 'ViDAR'
    untyped = tmp_path / 'vidar_tiny_untyped.py'
    untyped.write_text(f'model = {model!r}\n')
    trees = []                     # the last is count_params' own call
    eval_shape = jax.eval_shape

    def keep(fn, *a, **kw):
        trees.append(eval_shape(fn, *a, **kw))
        return trees[-1]

    monkeypatch.setattr(jax, 'eval_shape', keep)
    want = jax_analysis.count_params(str(untyped))
    monkeypatch.undo()
    got = analysis.count_params(config)
    assert got == want
    want_by = {top: sum(x.size for x in jax.tree.leaves(sub))
               for top, sub in trees[-1]['params'].items()}
    tiny = build_model(load_config(config)['model'], device='cpu')
    total, by_top = analysis.param_counts(tiny)
    assert total == want and by_top == want_by
    # the frozen BatchNorms are the difference from the parameters alone
    assert total > sum(p.numel() for p in tiny.parameters())


@pytest.fixture(scope='module')
def fake(tmp_path_factory):
    root = tmp_path_factory.mktemp('analysis')
    pkl = make_fake_nuscenes(str(root / 'data'), num_samples=6, num_cams=3,
                             img_hw=(64, 96))
    return root, [f'data.train.ann_file={pkl}', f'data.test.ann_file={pkl}']


def test_analyze_logs_reads_the_train_cli(fake, capsys):
    root, data = fake
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = train_cli.main([TINY, '--work-dir', str(root / 'work'),
                              '--max-steps', '2', '--device', 'cpu',
                              '--deterministic', '--cfg-options', *data,
                              'log_interval=1'])
    finally:
        torch.set_num_threads(threads)
    log = root / 'train.log'
    log.write_text(capsys.readouterr().out)
    keys = ['loss', 'grad_norm', 'data_wait_s', 'absent']
    got = analysis.analyze_logs(str(log), keys)
    said = capsys.readouterr().out
    want = jax_analysis.analyze_logs(str(log), keys)
    assert got == want and said == capsys.readouterr().out
    assert [v for _, v in got['loss']] == [m['loss'] for m in out['log']]
    assert [i for i, _ in got['loss']] == [1, 2] and not got['absent']


def test_visibility_scan_equals_jax(fake):
    _, data = fake
    with contextlib.redirect_stdout(io.StringIO()):
        got = analysis.visibility_scan(TINY, max_samples=4, cfg_options=data)
        want = jax_analysis.visibility_scan(TINY, max_samples=4,
                                            cfg_options=data)
    assert got == want
    assert got['samples_scanned'] == 4 and got['per_camera_frames'] > 0


def test_timer_spans_accumulate_and_show_in_a_trace():
    timing.report()                                  # start from nothing
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timing.timer('test/span'):
                torch.ones(8).sum()
    with timing.timer('test/other'):
        pass
    rep = timing.report(reset=False)
    assert rep['test/span']['count'] == 3 and rep['test/other']['count'] == 1
    assert rep['test/span']['total_s'] > 0
    assert rep['test/span']['avg_s'] == pytest.approx(
        rep['test/span']['total_s'] / 3)
    spans = [e for e in prof.key_averages() if e.key == 'test/span']
    assert spans and spans[0].count == 3

    @timing.run_time
    def work():
        return 5

    assert work() == 5
    rep = timing.report()
    assert rep[work.__qualname__]['count'] == 1
    assert timing.report() == {}
