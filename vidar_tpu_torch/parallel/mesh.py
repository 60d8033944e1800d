"""Device placement and the tensor collectives of data parallelism
(counterpart of vidar_tpu/parallel/mesh.py).

JAX lays one ``data`` mesh axis over the devices, shards the batch on it,
replicates the parameters and lets XLA insert the gradient psum. The port
runs one process per card: ``local_device`` picks the process's card,
``broadcast_parameters_`` makes the replicas equal, ``global_sum`` sums a
loss normaliser over the ranks and ``all_reduce_sum_`` the gradients.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from .multihost import initialized, rank


def local_device(device='cuda') -> torch.device:
    """The process's device: ``cuda:(rank % device_count)`` for 'cuda', the
    CPU only when asked for. Raises without a card (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', rank() % torch.cuda.device_count())
    return dev


def _buckets(tensors: Sequence[torch.Tensor]
             ) -> Dict[torch.dtype, List[torch.Tensor]]:
    out: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


def _flat_collective_(tensors: Sequence[torch.Tensor], op) -> None:
    """``op`` on one flattened bucket per dtype (in first-seen order, the
    same on every rank), the results copied back in place."""
    for group in _buckets(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place. Every rank passes the same
    list in the same order. Nothing when one process runs."""
    if initialized() and tensors:
        _flat_collective_(tensors, dist.all_reduce)


def broadcast_parameters_(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank, in place (JAX's
    ``put_replicated`` requires equal values; this makes them equal)."""
    if initialized():
        with torch.no_grad():
            _flat_collective_(list(module.state_dict().values()),
                              lambda flat: dist.broadcast(flat, src=0))


def _all_reduce(x: torch.Tensor, op) -> torch.Tensor:
    if not initialized():
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=op)
    return y


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, without gradient: a loss normaliser
    that JAX sums over the global batch. ``x`` itself when one process runs.
    Every rank must call it at the same point of the same code."""
    return _all_reduce(x, dist.ReduceOp.SUM)


def global_max(x: torch.Tensor) -> torch.Tensor:
    """``x``'s largest value over the ranks, without gradient; ``x`` itself
    when one process runs."""
    return _all_reduce(x, dist.ReduceOp.MAX)
