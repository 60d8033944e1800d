"""``vidar_tpu_torch`` and every submodule import with JAX and flax
blocked, and neither they nor the JAX package are imported by the port."""

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
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "loaded = [k for k, v in sys.modules.items() if v]\n"
            "assert not [k for k in loaded if k.split('.')[0] in\n"
            "            ('jax', 'flax', 'vidar_tpu')], loaded\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_presets_equal_the_jax_packages():
    from vidar_tpu import configs as jax_configs
    from vidar_tpu_torch import configs
    for name in ('vidar_base', 'vidar_tiny', 'vidar_dryrun'):
        assert getattr(configs, name)() == getattr(jax_configs, name)(), name


def test_sources_name_no_jax():
    pattern = re.compile(r'^\s*(import|from)\s+(jax|flax|vidar_tpu)\b',
                         re.M)
    offenders = [str(p) for p in PKG.rglob('*.py')
                 if pattern.search(p.read_text())]
    assert not offenders, offenders
