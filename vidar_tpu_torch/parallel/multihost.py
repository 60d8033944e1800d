"""Multi-process launch and the collectives of the port's data parallelism
(counterpart of vidar_tpu/parallel/multihost.py).

The reference trains one sample per GPU across GPUs through
``torch.distributed.launch`` (MASTER_ADDR / MASTER_PORT / RANK env
rendezvous, reference tools/multinode_train.sh:12-36). The port runs one
process per card, as PyTorch does, and takes the JAX package's launch
contract: ``--coordinator host:port --num-processes N --process-id R``, or
the environment ``VIDAR_COORDINATOR`` / ``VIDAR_NUM_PROCESSES`` /
``VIDAR_PROCESS_ID``. Without either a run is one process and nothing here
changes it.

Each process loads its local slice of the global batch (the samplers are
rank-sharded), every loss normaliser is summed over the ranks in the
forward (``mesh.global_sum``), and the train steps sum the gradients over
the ranks after the backward: the update equals the JAX package's step on
the global batch. Rank 0 alone writes logs, checkpoints and evaluations.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

# The collectives' timeout. While rank 0 runs the in-training evaluation
# (unsharded, as in JAX), the other ranks wait at a barrier: a full nuScenes
# val split (6019 samples) at up to 3.5 s a sample (the f32 forecast eval
# and its loader, PERF.md §5) takes under 6 hours.
TIMEOUT = datetime.timedelta(hours=6)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def maybe_initialize_distributed(coordinator: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None, *,
                                 device='cuda',
                                 backend: Optional[str] = None) -> bool:
    """Join the process group of a multi-process launch; a no-op returning
    False for a single-process run (no flag and no ``VIDAR_*`` variable).

    Call before anything touches the device. The flags fall back to
    ``VIDAR_COORDINATOR`` / ``VIDAR_NUM_PROCESSES`` / ``VIDAR_PROCESS_ID``.
    The backend follows ``device``: NCCL on the card (each process on
    ``cuda:(process_id % device_count)``), Gloo on the CPU. ``backend``
    names another for a caller that needs one (Gloo for two ranks on one
    card, which NCCL refuses); nothing falls back from one to the other.
    """
    coordinator = coordinator or os.environ.get('VIDAR_COORDINATOR')
    if num_processes is None:
        num_processes = _env_int('VIDAR_NUM_PROCESSES')
    if process_id is None:
        process_id = _env_int('VIDAR_PROCESS_ID')
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError('a multi-process launch needs the coordinator, the '
                         'number of processes and the process id (flags or '
                         'VIDAR_* environment)')
    dev = resolve_device(device)
    if dev.type == 'cuda':
        index = (process_id % torch.cuda.device_count() if dev.index is None
                 else dev.index)
        dev = torch.device('cuda', index)
        torch.cuda.set_device(dev)
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    dist.init_process_group(backend, init_method=f'tcp://{coordinator}',
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    _warmup_collectives(dev)
    return True


def _warmup_collectives(device) -> None:
    """One scalar all-reduce right after the rendezvous, while the ranks
    are in step: it sets up the backend's connections (NCCL's communicator)
    before the first model-sized collective, and proves every rank
    joined."""
    one = torch.ones((), device=device)
    dist.all_reduce(one)
    if int(one.item()) != world_size():
        raise RuntimeError(f'warm-up all-reduce gave {one.item()}, not the '
                           f'world size {world_size()}')


def shutdown() -> None:
    """Leave the process group, where one was joined."""
    if initialized():
        dist.destroy_process_group()


def add_distributed_args(parser) -> None:
    """The train and test CLIs' flags of a multi-process launch."""
    parser.add_argument('--coordinator', default=None,
                        help='host:port of rank 0 for multi-process runs')
    parser.add_argument('--num-processes', type=int, default=None)
    parser.add_argument('--process-id', type=int, default=None)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every rank; nothing when one process runs."""
    if initialized():
        dist.barrier()


def process_gather_objects(obj):
    """Every rank's picklable ``obj``, in rank order (a list of one object
    when one process runs). The reference gathers eval results through a
    shared tmpdir (apis/test.py:117-161); here they ride
    ``all_gather_object``."""
    if not initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj):
    """Rank 0's picklable ``obj`` on every rank."""
    if not initialized():
        return obj
    box = [obj if is_main() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


__all__ = ['TIMEOUT', 'add_distributed_args', 'barrier', 'broadcast_object',
           'initialized', 'is_main', 'maybe_initialize_distributed',
           'process_gather_objects', 'rank', 'shutdown', 'world_size']
