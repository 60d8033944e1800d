"""Build and load the hand-written CUDA kernels of the port.

``vidar_tpu_torch/csrc/*.cu`` are compiled by ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ``ctypes``. The build runs at the first kernel
launch, writes into ``build/vidar_tpu_torch/`` at the repository root, and
names the library after a hash of the sources and flags: an edited source
gets a fresh build, an unchanged one is reused.

Each kernel's wrapper owns a :class:`KernelCounter`: ``launches`` counts
launches of the kernel itself (never of its plain PyTorch version), and
``on_launch``, when set, sees every launch's arguments, so a script can keep
the inputs a real run gave the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'vidar_tpu_torch'
NVCC_FLAGS = ('-gencode=arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: every pointer, and the stream, as void*; ints as int
SIGNATURES = {
    # value, value_is_bf16, shapes, level_start, loc, weights, out,
    # B, V, Q, heads, dim, L, P, stream
    'msda_forward': (_P, _I, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _P),
    # x, sx, sy, mask, weight, out, B, H, W, C, Q, CO, stream
    'dcn_conv_forward': (_P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _P),
    # occ, occ_is_bf16, grids, radial, steps, out,
    # B, H, W, Z, N, G, act_exp, stream
    'ray_first_hit_forward': (_P, _I, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _P),
    # fmap, fmap_is_bf16, grids, radial, steps, out,
    # B, H, W, CT, c_r, Z, N, G, eps, stream
    'ray_aggregate_forward': (_P, _I, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
}

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the build (or load) that made _lib


class KernelCounter:
    """Launch count and optional launch hook of one CUDA kernel."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.on_launch = None

    def launched(self, **args):
        self.launches += 1
        if self.on_launch is not None:
            self.on_launch(args)


def _nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and Path(cand, 'bin', 'nvcc').exists():
            return str(Path(cand, 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'vidar_tpu_torch are built on a machine with '
                           'the CUDA toolkit')
    return found


def _digest(sources) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(so_path: Path, sources) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f'{so_path.stem}.{os.getpid()}'
    objs, procs = [], []
    log_path = BUILD_DIR / 'build.log'
    with open(log_path, 'w') as log:
        # one nvcc per translation unit, in parallel, then one link
        for src in sources:
            if src.suffix != '.cu':
                continue
            obj = BUILD_DIR / f'{src.stem}.{tag}.o'
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, '-I', str(CSRC), '-c', str(src),
                 '-o', str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.write(f'== {src.name} (rc {proc.returncode})\n')
            log.write(out.decode(errors='replace'))
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}; see {log_path}')
        tmp = BUILD_DIR / f'{tag}.so.tmp'
        link = subprocess.run(
            [nvcc, '-gencode=arch=compute_90a,code=sm_90a', '-shared',
             *map(str, objs), '-o', str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        log.write(f'== link (rc {link.returncode})\n')
        log.write(link.stdout.decode(errors='replace'))
        if link.returncode != 0:
            raise RuntimeError(f'nvcc link failed; see {log_path}')
    for obj in objs:
        obj.unlink()
    os.replace(tmp, so_path)


def load_library() -> ctypes.CDLL:
    """Build (at first use, or after a source changed) and load the
    kernels' shared library."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            sources = sorted(list(CSRC.glob('*.cu')) +
                             list(CSRC.glob('*.cuh')))
            so_path = BUILD_DIR / f'libvidar_kernels_{_digest(sources)}.so'
            if not so_path.exists():
                _compile(so_path, sources)
            lib = ctypes.CDLL(str(so_path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
            build_seconds = time.perf_counter() - t0
    return _lib


def check(rc: int, name: str) -> None:
    """Raise when a kernel's C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA error {rc} at launch')


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
