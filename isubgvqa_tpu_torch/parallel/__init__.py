"""Data-parallel training over ``torch.distributed``: the process group,
differentiable sums over the ranks, and the step's sharded draws."""

from .mesh import (all_reduce_, all_reduce_sum, barrier, data_shard,
                   device_for_rank, init_distributed, is_initialized,
                   is_main_process, local_rank, rank, shard_draw, shutdown,
                   world_size)

__all__ = ["all_reduce_", "all_reduce_sum", "barrier", "data_shard",
           "device_for_rank", "init_distributed", "is_initialized",
           "is_main_process", "local_rank", "rank", "shard_draw",
           "shutdown", "world_size"]
