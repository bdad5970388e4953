"""Data- and tensor-parallel training over ``torch.distributed``: the
process group and its ``(data, model)`` mesh, differentiable sums over
the groups, the tensor-parallel tables, and the step's sharded draws."""

from .mesh import (TP_PARAM_RULES, all_reduce_, all_reduce_sum, barrier,
                   copy_to_model_region, data_rank, data_shard, data_size,
                   device_for_rank, gather_shard, group_of, init_distributed,
                   init_mesh, is_initialized, is_main_process, local_rank,
                   model_rank, model_size, rank, reduce_from_model_region,
                   shard_dim, shard_draw, shard_model_, shard_of, shutdown,
                   tp_dim, world_size)

__all__ = ["TP_PARAM_RULES", "all_reduce_", "all_reduce_sum", "barrier",
           "copy_to_model_region", "data_rank", "data_shard", "data_size",
           "device_for_rank", "gather_shard", "group_of", "init_distributed",
           "init_mesh", "is_initialized", "is_main_process", "local_rank",
           "model_rank", "model_size", "rank", "reduce_from_model_region",
           "shard_dim", "shard_draw", "shard_model_", "shard_of", "shutdown",
           "tp_dim", "world_size"]
