"""``vidar_tpu_torch`` and every submodule import with JAX, flax, Pillow and
matplotlib blocked, and neither they nor the JAX package are imported by
the port or by ``chip_smoke.py`` (the card's machine has no Pillow and no
matplotlib)."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / 'vidar_tpu_torch'


def _modules():
    return sorted('.'.join(p.relative_to(ROOT).with_suffix('').parts)
                  .replace('.__init__', '')
                  for p in PKG.rglob('*.py'))


def test_imports_without_jax():
    mods = _modules()
    assert 'vidar_tpu_torch.ops.msda' in mods
    assert {'vidar_tpu_torch.parallel', 'vidar_tpu_torch.parallel.mesh',
            'vidar_tpu_torch.parallel.multihost'} <= set(mods)
    # UniAD and what its CLI paths import
    assert {'vidar_tpu_torch.uniad', 'vidar_tpu_torch.uniad.uniad',
            'vidar_tpu_torch.uniad.loss', 'vidar_tpu_torch.uniad.metrics',
            'vidar_tpu_torch.uniad.motion_optimization',
            'vidar_tpu_torch.data.uniad_data',
            'vidar_tpu_torch.data.rasterize',
            'vidar_tpu_torch.evals.tracking',
            'vidar_tpu_torch.models.position_embedding'} <= set(mods)
    # the data-preparation and analysis tools, the rest of the fine-tune
    assert {'vidar_tpu_torch.core.timing',
            'vidar_tpu_torch.data.nuscenes_converter',
            'vidar_tpu_torch.tools.map_converter',
            'vidar_tpu_torch.tools.data_tools',
            'vidar_tpu_torch.tools.extra_converters',
            'vidar_tpu_torch.tools.analysis',
            'vidar_tpu_torch.train.losses',
            'vidar_tpu_torch.train.video_runner'} <= set(mods)
    # the BEVFormerV2 family, the voxel renderer and the visualisation tool
    assert {'vidar_tpu_torch.models.bevformer_v2',
            'vidar_tpu_torch.models.bev_head', 'vidar_tpu_torch.models.dd3d',
            'vidar_tpu_torch.models.internimage',
            'vidar_tpu_torch.models.vovnet', 'vidar_tpu_torch.ops.dcnv3',
            'vidar_tpu_torch.ops.voxel_render',
            'vidar_tpu_torch.data.nuscenes_mono',
            'vidar_tpu_torch.tools.visualize'} <= set(mods)
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'PIL', 'matplotlib'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "loaded = [k for k, v in sys.modules.items() if v]\n"
            "assert not [k for k in loaded if k.split('.')[0] in\n"
            "            ('jax', 'flax', 'vidar_tpu', 'PIL',\n"
            "             'matplotlib')], loaded\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_presets_equal_the_jax_packages():
    from vidar_tpu import configs as jax_configs
    from vidar_tpu_torch import configs
    for name in ('vidar_base', 'vidar_tiny', 'vidar_dryrun',
                 'vidar_1_8_nusc_1future',
                 'mem_efficient_vidar_1_8_nusc_3future',
                 'vidar_openscene_3future'):
        assert getattr(configs, name)() == getattr(jax_configs, name)(), name


def test_sources_name_no_jax():
    pattern = re.compile(
        r'^\s*(import|from)\s+(jax|flax|vidar_tpu|PIL|matplotlib)\b', re.M)
    sources = sorted(PKG.rglob('*.py')) + [ROOT / 'chip_smoke.py']
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders, offenders
