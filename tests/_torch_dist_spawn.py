"""Two worker processes of tests/_torch_dist_worker.py, one a rank, for the
two-process CPU tests (no JAX here)."""

import os
import pathlib
import socket
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / 'tests' / '_torch_dist_worker.py'
# a group of two ranks that has not finished in this time has hung
SPAWN_TIMEOUT = 600


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _spawn(argvs, envs, log_dir):
    """Start one worker process a rank -> the processes (their output in
    log_dir/rank{r}.log)."""
    procs = []
    for r, (argv, env) in enumerate(zip(argvs, envs)):
        with open(os.path.join(log_dir, f'rank{r}.log'), 'w') as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), *argv], cwd=ROOT,
                env=dict(os.environ, OMP_NUM_THREADS='1', **env),
                stdout=log, stderr=subprocess.STDOUT))
    return procs


def _wait(procs, log_dir):
    """Wait for every rank; a rank that fails ends the others (they would
    wait for it in a collective) and the test."""
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        with open(os.path.join(log_dir, f'rank{r}.log')) as f:
            out = f.read()
        assert p.returncode == 0 and 'RANK_OK' in out, \
            f'rank {r} (rc {p.returncode}):\n{out[-4000:]}'
