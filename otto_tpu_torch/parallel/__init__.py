"""Parallelism over ``torch.distributed``: one process a device, a named
``data x model`` mesh, the sharded tables and serving paths, and
data-parallel training.

Port of ``otto_tpu/parallel`` in part: the mesh helpers, the row-sharded
embedding functions, sharded serving, and data-parallel training (the GBDT,
the tower and the sequence models, ZeRO-1).  Model and expert parallelism are
not ported yet (ROADMAP M15c).
"""

from otto_tpu_torch.parallel.data_parallel import (
    ZeroState,
    make_dp_gbdt_grow,
    make_dp_ranker_step,
    make_dp_sequence_step,
    make_zero_sequence_step,
    make_zero_step,
    zero_init,
)
from otto_tpu_torch.parallel.mesh import (
    batch_sharded,
    host_shard_sessions,
    init_distributed,
    make_mesh,
    make_mesh3d,
    mesh_device,
    replicated,
    row_sharded,
    shard_rows,
)
from otto_tpu_torch.parallel.serving import (
    CANDGEN_TABLE_KINDS,
    ServingLayout,
    make_sharded_heuristic_routes,
    make_sharded_regular_chunk,
    pad_table_rows,
)
from otto_tpu_torch.parallel.sharded_embedding import (
    ShardedRetriever,
    make_sharded_mf_step,
    make_sharded_sgns_step,
    sharded_lookup,
    sharded_topk,
)

__all__ = [
    "make_mesh", "make_mesh3d", "init_distributed", "mesh_device", "shard_rows",
    "row_sharded", "batch_sharded", "replicated", "host_shard_sessions",
    "sharded_lookup", "ShardedRetriever", "sharded_topk", "make_sharded_sgns_step",
    "make_sharded_mf_step", "CANDGEN_TABLE_KINDS", "pad_table_rows", "ServingLayout",
    "make_sharded_regular_chunk", "make_sharded_heuristic_routes",
    "make_dp_ranker_step", "make_dp_gbdt_grow", "make_dp_sequence_step", "zero_init",
    "make_zero_step", "make_zero_sequence_step", "ZeroState",
]
