"""Fixed-capacity KV slot pool for the continuous-batching engine (torch
port of ``repro.serving.kv_pool``).

The pool owns one model :class:`~repro_torch.models.transformer.Cache`
whose batch dimension is the slot axis (``capacity`` slots) and whose
``length`` is a per-slot ``(capacity,)`` int32 vector: the ragged decode
step (``decode_step_ragged``) writes slot ``s``'s next token at position
``length[s]`` and masks its attention at ``length[s] + 1``.

Slots are recycled, not reallocated: claiming a slot resets its length to
zero, one int32 store on the device.  The stale KV left behind is never
read -- every attention read is masked by the slot's own length, which
restarts at 0 -- so the cache is never zeroed.
``tests/test_torch_serving.py`` pins that: a recycled slot's token stream
equals the same request's in a fresh pool.

Allocation is LIFO over the free list (slot identity never influences
tokens); admission fairness is the scheduler's job.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Cache, init_cache

__all__ = ["KVPool"]


class KVPool:
    """``capacity`` recyclable decode slots over one shared cache on
    ``device`` (the card unless the caller passes ``"cpu"``): host-side
    free-list bookkeeping plus the cache tensors, which the engine's decode
    step updates in place."""

    def __init__(self, cfg: ModelConfig, capacity: int, max_len: int,
                 dtype=torch.bfloat16, device="cuda"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        base = init_cache(cfg, capacity, max_len, dtype=dtype, device=device)
        self.capacity = capacity
        self.max_len = max_len
        self.cache = Cache(base.kind, base.data, torch.zeros(
            (capacity,), dtype=torch.int32, device=base.data[0].device))
        self._free = list(range(capacity - 1, -1, -1))  # pop() -> slot 0 first
        self._occupied: set[int] = set()

    # -- slot lifecycle ----------------------------------------------------

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> int:
        return len(self._occupied)

    def alloc(self) -> int:
        """Claim a free slot and reset its length to 0 (recycled KV past
        length 0 is masked, never cleared)."""
        if not self._free:
            raise RuntimeError("KVPool exhausted: no free slots")
        slot = self._free.pop()
        self._occupied.add(slot)
        self.cache.length[slot] = 0
        return slot

    def free(self, slot: int) -> None:
        """Return a slot to the pool; a double free raises, catching
        scheduler accounting errors early."""
        if slot not in self._occupied:
            raise RuntimeError(f"free() of slot {slot} not in use")
        self._occupied.remove(slot)
        self._free.append(slot)
        if obs.enabled():
            obs.counter("serve.slots_recycled", 1)

    def check_invariants(self) -> None:
        """Pool accounting must always partition the slot set exactly."""
        free, occ = set(self._free), self._occupied
        assert len(free) == len(self._free), "free list has duplicates"
        assert not (free & occ), f"slots both free and occupied: {free & occ}"
        assert len(free) + len(occ) == self.capacity, (
            f"slot leak: {len(free)} free + {len(occ)} active "
            f"!= capacity {self.capacity}"
        )

    # -- device state ------------------------------------------------------

    def lengths(self) -> torch.Tensor:
        """Per-slot cache lengths, ``(capacity,)`` int32."""
        return self.cache.length

    def set_cache(self, data, lengths) -> None:
        """Install the post-step cache tensors and per-slot lengths."""
        self.cache = Cache(self.cache.kind, data, lengths)
