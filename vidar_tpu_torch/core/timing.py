"""Phase timers (port of vidar_tpu/core/timing.py: the reference's
bricks.run_time decorator, generalised): ``timer(name)`` accumulates the
wall time of a span under ``name`` and marks it as a
``torch.profiler.record_function`` range, so the span shows in a torch
profiler trace; ``report()`` returns the totals."""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict

import torch

_ACCUM: Dict[str, float] = defaultdict(float)
_COUNT: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def timer(name: str):
    """Wall-clock span accumulated under ``name`` (host side: device work
    is asynchronous unless the block itself synchronises)."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    _ACCUM[name] += time.perf_counter() - t0
    _COUNT[name] += 1


def run_time(fn):
    """Decorator form."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with timer(fn.__qualname__):
            return fn(*args, **kwargs)
    return wrapped


def report(reset: bool = True) -> Dict[str, dict]:
    """{name: dict(total_s, count, avg_s)}; cleared unless ``reset`` is
    False."""
    out = {k: dict(total_s=v, count=_COUNT[k], avg_s=v / max(_COUNT[k], 1))
           for k, v in _ACCUM.items()}
    if reset:
        _ACCUM.clear()
        _COUNT.clear()
    return out
