"""Multi-GPU layer of the port (counterpart of `lumina_t2x_tpu/parallel`):
the (data, model) mesh, the sharding rules, the gradient norm and GPipe."""

from .mesh import (AXIS_DATA, AXIS_MODEL, batch_sharding, create_mesh, distributed_init,
                   form_global_batch, replicated_sharding)
from .pipeline import gpipe_spmd, merge_stages, split_stages, stage_shardings
from .sharding import model_parallel_dim_dict, param_shardings, shard_params, spec_for_param

__all__ = [
    "AXIS_DATA", "AXIS_MODEL", "create_mesh", "distributed_init",
    "batch_sharding", "replicated_sharding", "form_global_batch",
    "param_shardings", "shard_params", "spec_for_param", "model_parallel_dim_dict",
    "gpipe_spmd", "split_stages", "merge_stages", "stage_shardings",
]
