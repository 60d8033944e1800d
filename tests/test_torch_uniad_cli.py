"""The port's train and test CLIs on ``configs/tiny/uniad_tiny.py``, run in
this process on the CPU (``--device cpu``) on the fake on-disk dataset of
``tests/data/fake_nuscenes.py`` (two scenes): 2 clip steps, then the UniAD
eval of the checkpoint, which streams the tracker over the scenes and
writes the six headline metrics. Two processes:
tests/test_torch_uniad_distributed.py."""

import json

import numpy as np
import pytest
import torch

from tests.data.fake_nuscenes import make_fake_nuscenes
from vidar_tpu_torch.tools import test as test_cli
from vidar_tpu_torch.tools import train as train_cli

CONFIG = 'configs/tiny/uniad_tiny.py'
KEYS = ('amota', 'amotp', 'NDS', 'minADE', 'planning.L2',
        'planning.obj_box_col')


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_then_eval(tmp_path, one_thread):
    pkl = make_fake_nuscenes(str(tmp_path / 'data'), num_samples=8,
                             num_cams=3, img_hw=(32, 64), num_scenes=2)
    data = [f'data.train.ann_file={pkl}', f'data.test.ann_file={pkl}']
    work = tmp_path / 'work'
    out = train_cli.main([CONFIG, '--work-dir', str(work), '--max-steps',
                          '2', '--device', 'cpu', '--cfg-options', *data,
                          'log_interval=1'])
    assert out['step'] == 2 and len(out['log']) == 2
    for m in out['log']:
        for k in ('track.loss', 'map.loss', 'motion.loss', 'occ.loss',
                  'planning.loss', 'loss', 'grad_norm'):
            assert np.isfinite(m[k]), (k, m)
        assert m['loss'] > 0 and m['grad_norm'] > 0
    assert (work / 'latest' / 'model.pt').is_file()

    metrics_path = tmp_path / 'metrics.json'
    metrics = test_cli.main([CONFIG, str(work / 'latest'), '--max-samples',
                             '4', '--device', 'cpu', '--out',
                             str(metrics_path), '--cfg-options', *data])
    with open(metrics_path) as f:
        written = json.load(f)
    for k in KEYS:
        assert np.isfinite(written[k]), (k, written)
        assert written[k] == pytest.approx(float(metrics[k]))

