"""Parallelism over ``torch.distributed``: one process a device, a named
``data x model`` (or ``data x pipe x model``) mesh, the sharded tables and
serving paths, and data-, model- and expert-parallel training.

Port of ``otto_tpu/parallel``: the mesh helpers, the row-sharded embedding
functions, sharded serving, data-parallel training (the GBDT, the tower and
the sequence models, ZeRO-1), tensor-, sequence- and pipeline-parallel
training of the transformer and the 3-D step (``model_parallel``), and the
expert-parallel MoE recommender (``expert_parallel``), on the autograd-aware
collectives of ``collectives``.
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
from otto_tpu_torch.parallel.expert_parallel import (
    init_moe_recommender,
    make_ep_moe_step,
    moe_recommender_from_numpy,
    moe_recommender_loss,
    moe_recommender_specs,
)
from otto_tpu_torch.parallel.mesh import (
    batch_sharded,
    host_shard_sessions,
    init_distributed,
    make_mesh,
    in_mesh,
    make_mesh3d,
    mesh_device,
    replicated,
    row_sharded,
    shard_rows,
    sharded,
)
from otto_tpu_torch.parallel.model_parallel import (
    gather_params,
    make_pp_sequence_step,
    make_pp_tp_sequence_step,
    make_tp_sequence_step,
    pp_param_specs,
    pp_tp_param_specs,
    shard_params,
    stack_pipeline_params,
    tp_encode,
    tp_param_specs,
    unstack_pipeline_params,
    with_layout,
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
    "make_zero_step", "make_zero_sequence_step", "ZeroState", "in_mesh", "sharded",
    "tp_param_specs", "shard_params", "gather_params", "with_layout",
    "tp_encode", "make_tp_sequence_step", "stack_pipeline_params", "pp_param_specs",
    "make_pp_sequence_step", "unstack_pipeline_params", "pp_tp_param_specs",
    "make_pp_tp_sequence_step",
    "init_moe_recommender", "moe_recommender_from_numpy", "moe_recommender_specs",
    "moe_recommender_loss", "make_ep_moe_step",
]
