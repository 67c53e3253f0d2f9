"""Processes and collectives of multi-process training and evaluation
(counterpart of ``codd_tpu/parallel``)."""

from .mesh import (all_reduce_grads, all_reduce_sum, broadcast_state,
                   counting, gather_objects, gather_rows, global_count,
                   global_mean, init_distributed, launched_by_torchrun,
                   process_count, process_group_active, process_index)

__all__ = ["all_reduce_grads", "all_reduce_sum", "broadcast_state",
           "counting", "gather_objects", "gather_rows", "global_count",
           "global_mean", "init_distributed", "launched_by_torchrun",
           "process_count", "process_group_active", "process_index"]
