"""Deprecated location: import from ``repro_torch.distributed`` instead.

A pure re-export shim, as the reference's ``repro.core.distributed`` is:
the distributed layer lives in ``repro_torch.distributed`` (``api`` /
``splitters``), and importing this module warns.
"""

import warnings

from repro_torch.distributed.api import (  # noqa: F401
    distributed_merge,
    distributed_merge_corank,
    distributed_sort,
    sharded_merge_kway,
    sharded_sort,
    sharded_sort_host,
)
from repro_torch.distributed.splitters import (  # noqa: F401
    distributed_co_rank,
    distributed_co_rank_kway,
)

warnings.warn(
    "repro_torch.core.distributed is deprecated; import from "
    "repro_torch.distributed (api / splitters) instead.",
    DeprecationWarning,
    stacklevel=2,
)

__all__ = [
    "distributed_merge",
    "distributed_merge_corank",
    "distributed_co_rank",
    "distributed_co_rank_kway",
    "distributed_sort",
    "sharded_merge_kway",
    "sharded_sort",
    "sharded_sort_host",
]
