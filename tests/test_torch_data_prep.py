"""The port's data-preparation tools against the JAX package's, on nuScenes
tables this test writes (``chip_smoke._write_nuscenes_tables``, the card
script's phase-12 writer, at a small size: two scenes, the second without
CAN bus, and a ``v1.0-test`` version): ``data/nuscenes_converter.py``,
``tools/map_converter.py``, ``tools/data_tools.py`` (every subcommand) and
``tools/extra_converters.py``. All of them are numpy on the host, so every
output is held exactly equal to JAX's: the same pickles, field by field,
in the same order, arrays of the same dtype and bits.
"""

import json
import os
import pickle

import numpy as np
import pytest

from vidar_tpu.data import nuscenes_converter as jax_converter
from vidar_tpu.tools import data_tools as jax_data_tools
from vidar_tpu.tools import extra_converters as jax_extra
from vidar_tpu.tools import map_converter as jax_map

import chip_smoke
from tests.data.test_map_converter import _fake_map
from vidar_tpu_torch.data import nuscenes_converter
from vidar_tpu_torch.tools import data_tools, extra_converters, map_converter

KEYFRAMES = 16
INSTANCES = 6


def _same(a, b, where='root'):
    """a and b equal exactly: the same types, keys in the same order,
    arrays of the same dtype, shape and values (NaN equal to NaN)."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            _same(a[k], b[k], f'{where}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f'{where}[{i}]')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b or (a != a and b != b), (where, a, b)


def _load(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


@pytest.fixture(scope='module')
def tables(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('nusc'))
    jpegs = [chip_smoke._encode_jpeg(np.full((16, 24, 3), 60 + 20 * c,
                                             np.uint8)) for c in range(6)]
    kw = dict(keyframes=KEYFRAMES, img_hw=(16, 24), num_points=400,
              instances=INSTANCES, jpegs=jpegs)
    truth = chip_smoke._write_nuscenes_tables(root, canbus=(True, False),
                                              **kw)
    chip_smoke._write_nuscenes_tables(root, version='v1.0-test', scenes=1,
                                      first=2, seed=1, **kw)
    jax_out, out = os.path.join(root, 'jax'), os.path.join(root, 'port')
    jax_converter.create_nuscenes_infos(root, jax_out)
    nuscenes_converter.main([root, '--out-dir', out])
    jax_converter.create_nuscenes_infos(root, jax_out, version='v1.0-test')
    nuscenes_converter.main([root, '--out-dir', out, '--version',
                             'v1.0-test'])
    return dict(root=root, truth=truth, jax=jax_out, port=out)


def _pkl(t, side, split):
    return os.path.join(t[side], f'nuscenes_infos_temporal_{split}.pkl')


@pytest.mark.parametrize('split', ['train', 'val', 'test'])
def test_converter_pickles_equal_jax(tables, split):
    got = _load(_pkl(tables, 'port', split))
    _same(got, _load(_pkl(tables, 'jax', split)))
    assert len(got['infos']) == KEYFRAMES
    if split == 'test':
        assert 'gt_boxes' not in got['infos'][0]
    else:
        assert len(got['infos'][0]['gt_boxes']) == INSTANCES
        # max_sweeps 10: the 9 sweeps between two keyframes, then the
        # keyframe before them
        assert len(got['infos'][1]['sweeps']) == 10


def test_converter_against_the_written_tables(tables):
    """The card script's own check: keyframe counts, frame_idx, the
    nearest CAN-bus message (ties kept first; zeros without CAN bus), the
    GT boxes carried into the lidar frame."""
    infos = (_load(_pkl(tables, 'port', 'train'))['infos'] +
             _load(_pkl(tables, 'port', 'val'))['infos'])
    by_scene = chip_smoke._check_converted(infos, tables['truth'])
    assert not np.any(by_scene['scene-0002'][0]['can_bus'])
    assert np.any(by_scene['scene-0001'][0]['can_bus'])


def test_map_elements_and_boxes_equal_jax(tmp_path):
    path = str(tmp_path / 'loc.json')
    _fake_map(path)
    got = map_converter.load_map_elements(path)
    want = jax_map.load_map_elements(path)
    _same(got, want)
    rng = np.random.default_rng(0)
    for _ in range(4):
        a = rng.uniform(-np.pi, np.pi)
        g2l = np.eye(4)
        g2l[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        g2l[:2, 3] = rng.uniform(-30, 30, 2)
        pc = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
        _same(map_converter.sample_map_boxes(got, g2l, pc),
              jax_map.sample_map_boxes(want, g2l, pc))


def test_map_anns_equal_jax(tables, tmp_path):
    infos = _pkl(tables, 'port', 'train')
    out, jax_out = str(tmp_path / 'port.pkl'), str(tmp_path / 'jax.pkl')
    n = map_converter.main(['--data-root', tables['root'], '--infos', infos,
                            '--out', out])
    assert jax_map.create_map_anns(tables['root'], 'v1.0-trainval', infos,
                                   jax_out) == n == KEYFRAMES
    anns = _load(out)
    _same(anns, _load(jax_out))
    labels = np.concatenate([a['labels'] for a in anns.values()])
    assert set(labels.tolist()) == {0, 1, 2}


def test_merge_fullset_equals_jax(tables, tmp_path):
    args = (_pkl(tables, 'port', 'train'), _pkl(tables, 'port', 'test'))
    data_tools.main(['merge-fullset', *args, str(tmp_path / 'port.pkl')])
    jax_data_tools.merge_fullset_pkl(*args, str(tmp_path / 'jax.pkl'))
    got = _load(tmp_path / 'port.pkl')
    _same(got, _load(tmp_path / 'jax.pkl'))
    assert len(got['infos']) == 2 * KEYFRAMES


def test_collect_nuplan_equals_jax(tables, tmp_path):
    logs = tmp_path / 'logs'
    logs.mkdir()
    infos = _load(_pkl(tables, 'port', 'train'))['infos']
    for k in range(5):               # 4 train logs, 1 val; a bare list too
        part = infos[3 * k:3 * k + 3]
        with open(logs / f'log{k}.pkl', 'wb') as f:
            pickle.dump(part if k == 2 else dict(infos=part), f)
    data_tools.main(['collect-nuplan', str(logs), str(tmp_path / 'port')])
    jax_data_tools.collect_nuplan_data(str(logs), str(tmp_path / 'jax'))
    for split in ('train', 'val'):
        _same(_load(tmp_path / 'port' / f'nuplan_infos_{split}.pkl'),
              _load(tmp_path / 'jax' / f'nuplan_infos_{split}.pkl'))


def test_submission_tools_equal_jax(tmp_path, capsys):
    rng = np.random.default_rng(2)
    depth = tmp_path / 'depth'
    depth.mkdir()
    counts = {}
    for t in ('a', 'b'):
        counts[t] = []
        for fidx in range(1, 7):
            v = rng.uniform(0, 80, int(rng.integers(3, 9)))
            counts[t].append(len(v))
            (depth / f'{t}_{fidx}.txt').write_text(
                '\n'.join(repr(float(x)) for x in v))
    counts['b'][3] += 1                        # one count that disagrees
    meta = tmp_path / 'meta.pkl'
    with open(meta, 'wb') as f:
        pickle.dump(dict(tokens=['a', 'b'], counts=counts), f)
    data_tools.main(['convert-submission', str(depth), str(meta),
                     str(tmp_path / 'port.pkl')])
    jax_data_tools.convert_submission_pkl(str(depth), str(meta),
                                          str(tmp_path / 'jax.pkl'))
    _same(_load(tmp_path / 'port.pkl'), _load(tmp_path / 'jax.pkl'))
    capsys.readouterr()
    got = data_tools.main(['validate-submission',
                           str(tmp_path / 'port.pkl'), str(meta)])
    said = capsys.readouterr().out
    want = jax_data_tools.validate_submission(str(tmp_path / 'port.pkl'),
                                              str(meta))
    assert got is want is False
    assert said == capsys.readouterr().out


def test_kmeans_anchors_equal_jax(tables, tmp_path):
    infos = _pkl(tables, 'port', 'train')
    got = data_tools.main(['kmeans-anchors', infos,
                           str(tmp_path / 'port.pkl')])
    want = jax_data_tools.kmeans_motion_anchors(infos,
                                                str(tmp_path / 'jax.pkl'))
    _same(got, want)
    _same(_load(tmp_path / 'port.pkl'), _load(tmp_path / 'jax.pkl'))
    # the vehicles' trajectories outnumber the modes: k-means++ drew
    assert got['meta']['counts'][0] > 6
    assert all(a.shape == (6, 12, 2) and np.isfinite(a).all()
               for a in got['anchors_all'])


@pytest.mark.parametrize('case', ['spread', 'repeats', 'few'])
def test_kmeans_draws_equal_jax(case):
    rng = np.random.default_rng(3)
    x = {'spread': rng.normal(0, 5, (50, 4)),
         'repeats': np.repeat(rng.normal(0, 1, (3, 4)), 10, 0),
         'few': rng.normal(0, 1, (4, 4))}[case].astype(np.float32)
    for seed in (0, 7):
        _same(data_tools._kmeans(x, 6, seed=seed),
              jax_data_tools._kmeans(x, 6, seed=seed))


def test_gt_database_equals_jax(tables, tmp_path):
    ann = _pkl(tables, 'port', 'train')
    got = extra_converters.main(['create-gt-database', ann,
                                 str(tmp_path / 'port')])
    want = jax_extra.create_groundtruth_database(ann, str(tmp_path / 'jax'))
    _same(_load(got), _load(want))
    db = 'nuscenes_gt_database'
    files = sorted(os.listdir(tmp_path / 'port' / db))
    assert files == sorted(os.listdir(tmp_path / 'jax' / db))
    assert len(files) == KEYFRAMES * INSTANCES
    for name in files:
        assert (tmp_path / 'port' / db / name).read_bytes() == \
            (tmp_path / 'jax' / db / name).read_bytes(), name


def test_points_in_rbbox_and_kitti2waymo_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-10, 10, (300, 5))
    boxes = np.concatenate([rng.uniform(-8, 8, (7, 3)),
                            rng.uniform(1, 6, (7, 3)),
                            rng.uniform(-3, 3, (7, 1))], 1)
    _same(extra_converters.points_in_rbbox(pts, boxes),
          jax_extra.points_in_rbbox(pts, boxes))
    _same(extra_converters.points_in_rbbox(pts, boxes[:0]),
          jax_extra.points_in_rbbox(pts, boxes[:0]))
    results = [dict(name=np.array(['Car', 'Pedestrian', 'Cyclist', 'Van']),
                    dimensions=rng.uniform(1, 5, (4, 3)),
                    location=rng.uniform(-30, 30, (4, 3)),
                    rotation_y=rng.uniform(-4, 4, 4),
                    score=rng.uniform(0, 1, 4), sample_idx=k,
                    context_name=f'ctx{k}') for k in range(3)]
    extra_converters.kitti2waymo(results, str(tmp_path / 'port.bin'))
    jax_extra.kitti2waymo(results, str(tmp_path / 'jax.bin'))
    assert (tmp_path / 'port.bin').read_bytes() == \
        (tmp_path / 'jax.bin').read_bytes()


def test_nuimage_to_coco_equals_jax(tmp_path):
    version = 'v1.0-mini'
    tdir = tmp_path / 'nuim' / version
    tdir.mkdir(parents=True)
    rng = np.random.default_rng(5)
    names = ['vehicle.car', 'human.pedestrian.adult', 'animal',
             'movable_object.barrier']
    tables = dict(
        category=[dict(token=f'c{k}', name=n) for k, n in enumerate(names)],
        sample_data=[dict(token=f'sd{k}', filename=f'samples/{k}.jpg',
                          is_key_frame=k != 2, width=1600, height=900)
                     for k in (3, 0, 2, 1)],
        object_ann=[dict(token=f'a{k}', sample_data_token=f'sd{k % 4}',
                         category_token=f'c{k % 4}',
                         bbox=sorted(rng.uniform(0, 800, 2).tolist()) +
                         sorted(rng.uniform(0, 800, 2).tolist()))
                    for k in range(12)])
    for name, rows in tables.items():
        (tdir / f'{name}.json').write_text(json.dumps(rows))
    root = str(tmp_path / 'nuim')
    extra_converters.main(['nuimage-to-coco', root, version,
                           str(tmp_path / 'port.json')])
    jax_extra.nuimage_to_coco(root, version, str(tmp_path / 'jax.json'))
    assert (tmp_path / 'port.json').read_text() == \
        (tmp_path / 'jax.json').read_text()
