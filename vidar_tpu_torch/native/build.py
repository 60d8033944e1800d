"""Build the port's native host library (``hostops.cpp``) with ``g++``.

The library goes to ``build/vidar_tpu_torch/`` at the repository root,
beside the CUDA kernels' build, named after a hash of the source and the
flags: an edited source gets a fresh build, an unchanged one is reused. It
needs ``g++`` alone: the JPEG decoder is the library's own.

Usage: ``python -m vidar_tpu_torch.native.build`` (or, implicitly, the first
call of a function of ``vidar_tpu_torch.native``).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

from ..ops import _build

SRC = Path(__file__).resolve().with_name('hostops.cpp')
# no floating-point contraction: the resize must round as Pillow does; no
# -march=native: a library built on one machine loads on another
FLAGS = ('-O3', '-ffp-contract=off', '-shared', '-fPIC', '-std=c++17')


def _path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + ' '.join(FLAGS).encode())
    return _build.BUILD_DIR / f'hostops-{h.hexdigest()[:16]}.so'


def build() -> str:
    """Compile (or reuse) the library -> its path, under the build
    directory's lock (processes that start together build once). Raises
    RuntimeError where g++ fails."""
    out = _path()
    if not out.exists():
        with _build.build_lock():
            if not out.exists():
                _compile(out)
    return str(out)


def _compile(out: Path) -> None:
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    proc = subprocess.run(['g++', *FLAGS, str(SRC), '-o', str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed on {SRC.name}:\n{proc.stderr}')
    os.replace(tmp, out)


if __name__ == '__main__':
    print(build())
