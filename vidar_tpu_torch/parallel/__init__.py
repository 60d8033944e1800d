"""Data parallelism across processes, one per card (counterpart of
vidar_tpu/parallel/): the launch contract and the object collectives in
``multihost``, device placement and the tensor collectives in ``mesh``."""

from .mesh import (all_reduce_sum_, broadcast_parameters_, global_max,
                   global_sum, local_device)
from .multihost import (add_distributed_args, barrier, broadcast_object,
                        initialized, is_main, maybe_initialize_distributed,
                        process_gather_objects, rank, shutdown, world_size)

__all__ = ['add_distributed_args', 'all_reduce_sum_', 'barrier',
           'broadcast_object', 'broadcast_parameters_', 'global_max',
           'global_sum', 'initialized', 'is_main', 'local_device',
           'maybe_initialize_distributed', 'process_gather_objects', 'rank',
           'shutdown', 'world_size']
