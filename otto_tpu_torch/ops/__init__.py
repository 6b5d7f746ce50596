"""Retrieval, selection, session, multiset and covisitation ops (port of
``otto_tpu/ops``), and forest routing (the forest pass of
``otto_tpu/models/gbdt.py``).

The hand-written CUDA kernels live in ``otto_tpu_torch/csrc`` and are built
at first CUDA use by :mod:`otto_tpu_torch.ops._kernels`; importing this
package builds nothing.  No export takes a submodule's name (``row_topk``
stays the module).
"""

from otto_tpu_torch.ops.covisit import (
    PairAccumulator,
    compact_live,
    pair_stream,
    sort_reduce_rows,
    topk_per_source,
)
from otto_tpu_torch.ops.forest import ForestPack, pack_forests, predict_forest
from otto_tpu_torch.ops.fused_retrieval import FusedRetriever, fused_stage1
from otto_tpu_torch.ops.fused_sessions import aid_vote_aggregate, per_aid_weight_top_fused
from otto_tpu_torch.ops.multiset import (
    compact_rows,
    concat_unique_cascade,
    gather_neighbors,
    mask_members,
    row_count_topk,
    row_weight_topk,
    sorted_unique_rows,
)
from otto_tpu_torch.ops.retrieval import build_neighbor_table, topk_scan
from otto_tpu_torch.ops.row_topk import peel_rows
from otto_tpu_torch.ops.scan import run_totals, segmented_cumsum, segmented_propagate_first
from otto_tpu_torch.ops.sessions import (
    distinct_first_seen,
    distinct_recent_first,
    first_occurrence,
    last_occurrence,
    per_aid_weight_top,
    recency_weighted_top_aids,
)
