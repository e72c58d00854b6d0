"""Sharded exchange subsystem: the paper's merge across ranks (torch port
of ``repro.distributed``).

The layer between the single-process k-way merge (``repro_torch.core.kway``)
and a ``torch.distributed`` process group.  Four modules:

* ``splitters`` -- exact global splitters: pairwise and k-way co-rank
  searches run over collectives, ``O(p^2)`` scalars a lock-step round,
  never gathering run data.
* ``exchange`` -- ``balanced_exchange``, the ragged ``all_to_all`` with an
  exact lengths sideband that ships each rank exactly its segments;
  ``slot_transpose`` (MoE capacity dispatch over local groups) is its
  single-process static-shape case.
* ``moe`` -- dropless expert-parallel dispatch: stable sort by expert id
  + ``distributed_segment_cuts`` + ``balanced_exchange`` + grouped
  products, zero drops at any routing skew.
* ``api`` -- ``sharded_sort`` / ``sharded_merge_kway`` /
  ``distributed_merge`` with the ``strategy=`` switch (``allgather |
  corank | exchange``) and the host-level padding wrapper.

Every function takes the process group where the reference takes its mesh
axis name; ``_collectives`` maps the reference's collectives onto
``torch.distributed``.
"""

from repro_torch.distributed.api import (
    distributed_merge,
    distributed_merge_corank,
    distributed_sort,
    sharded_merge_kway,
    sharded_sort,
    sharded_sort_host,
)
from repro_torch.distributed.exchange import (
    balanced_exchange,
    exchange_block,
    sentinel_max,
    slot_transpose,
    window,
    window_rows,
)
from repro_torch.distributed.splitters import (
    distributed_co_rank,
    distributed_co_rank_kway,
    distributed_segment_cuts,
)
from repro_torch.distributed.moe import (
    DroplessPlan,
    dropless_combine,
    dropless_dispatch,
    dropless_moe_ffn,
)

__all__ = [
    "distributed_merge",
    "distributed_merge_corank",
    "distributed_sort",
    "sharded_merge_kway",
    "sharded_sort",
    "sharded_sort_host",
    "balanced_exchange",
    "exchange_block",
    "slot_transpose",
    "sentinel_max",
    "window",
    "window_rows",
    "distributed_co_rank",
    "distributed_co_rank_kway",
    "distributed_segment_cuts",
    "DroplessPlan",
    "dropless_combine",
    "dropless_dispatch",
    "dropless_moe_ffn",
]
