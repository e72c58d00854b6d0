"""Continuous-batching decode service on the merge engine (torch port of
``repro.serving``).

* :mod:`repro_torch.serving.scheduler` -- FIFO queue + per-slot request
  progress (pure host bookkeeping);
* :mod:`repro_torch.serving.kv_pool` -- fixed-capacity recyclable KV slots
  over one shared cache with per-slot lengths (stale KV is masked, never
  zeroed);
* :mod:`repro_torch.serving.sampling` -- per-request reference samplers and
  the batched serving forms, whose merge top-k runs on the grouped launch
  of ``merge_kway_tile`` on the card;
* :mod:`repro_torch.serving.engine` -- :class:`DecodeEngine`, the per-step
  admit -> ragged decode -> batched sample -> retire loop.

Entry point: ``python -m repro_torch.launch.serve``.
"""

from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.kv_pool import KVPool
from repro_torch.serving.sampling import (
    batched_topk,
    request_keys,
    sample_greedy,
    sample_topk,
    sample_topk_batched,
    sample_topp,
    sample_topp_batched,
)
from repro_torch.serving.scheduler import Request, Scheduler, SlotState

__all__ = [
    "DecodeEngine",
    "KVPool",
    "Request",
    "Scheduler",
    "SlotState",
    "batched_topk",
    "request_keys",
    "sample_greedy",
    "sample_topk",
    "sample_topk_batched",
    "sample_topp",
    "sample_topp_batched",
]
