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

The backward kernels (K5-K8) scatter with f32 ``atomicAdd`` into a gradient
buffer the wrapper zeroes; the order of those sums varies from run to run.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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
    # x, sx, sy, mask, out, B, H, W, C, Q, stream
    'dcn_sample_forward': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, out, H, W, C, Q -> which kernel dcn_sample_forward runs
    'dcn_sample_route': (_P, _P, _I, _I, _I, _I),
    # x (bf16), sx, sy, mask, out (bf16), B, H, W, C, Q, stream
    'dcn_sample16_forward': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, out, H, W, C, Q -> which kernel dcn_sample16_forward runs
    'dcn_sample16_route': (_P, _P, _I, _I, _I, _I),
    # occ, occ_is_bf16, grids, radial, steps, out,
    # B, H, W, Z, N, G, act_exp, stream
    'ray_first_hit_forward': (_P, _I, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _P),
    # occ, out, Z -> which kernel ray_first_hit_forward runs
    'ray_first_hit_route': (_P, _P, _I),
    # fmap, fmap_is_bf16, grids, radial, steps, out,
    # B, H, W, CT, c_r, Z, N, G, eps, stream
    'ray_aggregate_forward': (_P, _I, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # value, value_is_bf16, shapes, level_start, loc, weights, dout,
    # dvalue (f32), dloc, dweights, B, V, Q, heads, dim, L, P, stream
    'msda_backward': (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _P),
    # occ, occ_is_bf16, grids, radial, steps, gout, docc (f32),
    # B, H, W, Z, N, G, act_exp, stream
    'ray_first_hit_backward': (_P, _I, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _P),
    # occ, gout, docc, Z -> which kernel ray_first_hit_backward runs
    'ray_first_hit_backward_route': (_P, _P, _P, _I),
    # fmap, fmap_is_bf16, grids, radial, steps, gout, dfmap (f32),
    # B, H, W, CT, c_r, Z, N, G, eps, stream
    'ray_aggregate_backward': (_P, _I, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # fmap, gout, dfmap, c_r, Z -> which kernel ray_aggregate_backward runs
    'ray_aggregate_backward_route': (_P, _P, _P, _I, _I),
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


@contextlib.contextmanager
def build_lock():
    """Hold the build directory's lock, across processes: the ranks of a
    multi-process run that start together build once, and the others load
    that build. An ``flock``, which the kernel drops when its holder exits,
    so a process killed in a build leaves no stale lock."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / 'build.lock', 'w') as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


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
                with build_lock():
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
    """The raw handle of the current stream of CUDA tensor t's device: the
    call PyTorch's own generated launchers use, a fraction of the host time
    of ``torch.cuda.current_stream(dev).cuda_stream``."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(dev):
    """``torch.cuda.device(dev)``, or nothing to enter where dev is the
    current device already (the usual case, and a fraction of the
    context's host time)."""
    import torch
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
