"""Core: co-ranking and load-balanced stable merge (torch port).

Exports the ported part of ``repro.core``; the baselines and the
distributed shim are not ported yet.
"""

from repro_torch.core.corank import CoRankResult, co_rank, co_rank_batch
from repro_torch.core.merge import (
    merge_by_ranking,
    merge_partitioned,
    merge_segment_twofinger,
    partition_bounds,
)
from repro_torch.core.kway import (
    co_rank_kway,
    co_rank_kway_batch,
    kway_positions,
    merge_kway,
    merge_kway_ranked,
)
from repro_torch.core.mergesort import (
    merge_argsort,
    merge_runs_plain,
    merge_runs_ranked,
    merge_sort,
    sort_key_val,
)
from repro_torch.core.topk import (
    candidate_blocks,
    merge_topk,
    merge_topk_batch,
    tournament_rounds,
)

__all__ = [
    "CoRankResult",
    "co_rank",
    "co_rank_batch",
    "merge_by_ranking",
    "merge_partitioned",
    "merge_segment_twofinger",
    "partition_bounds",
    "co_rank_kway",
    "co_rank_kway_batch",
    "kway_positions",
    "merge_kway",
    "merge_kway_ranked",
    "merge_argsort",
    "merge_runs_plain",
    "merge_runs_ranked",
    "merge_sort",
    "sort_key_val",
    "candidate_blocks",
    "merge_topk",
    "merge_topk_batch",
    "tournament_rounds",
]
