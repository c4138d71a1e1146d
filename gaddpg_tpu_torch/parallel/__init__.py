"""Data-parallel training over ranks (counterpart of gaddpg_tpu/parallel/).

- `mesh`: the `Mesh` of a rank, the divisibility guard, row sharding,
  globally drawn random rows and the collectives the slice needs;
- `launch`: starts the ranks, one process each, with timeouts;
- `dryrun`: both dry-run tiers of the data-parallel train iteration
  (`python -m gaddpg_tpu_torch.parallel.dryrun --ranks 2 --device cpu`).
"""

from gaddpg_tpu_torch.parallel.launch import RankFailure, launch, rank_devices
from gaddpg_tpu_torch.parallel.mesh import (
    Mesh, all_gather_rows, all_reduce_sum, all_to_all_rows, broadcast_, draw_rows, init_mesh,
    local_slice, make_mesh, make_sharded_update, replicate, shard_leading_axis, sum_grads,
    sum_over_ranks, validate_dp_divisibility,
)

__all__ = ["Mesh", "RankFailure", "all_gather_rows", "all_reduce_sum", "all_to_all_rows",
           "broadcast_", "draw_rows", "init_mesh", "launch", "local_slice", "make_mesh",
           "make_sharded_update", "rank_devices", "replicate", "shard_leading_axis",
           "sum_grads", "sum_over_ranks", "validate_dp_divisibility"]
