"""FIFO request scheduler for per-step (iteration-level) admission
(torch port of ``repro.serving.scheduler``: pure host code, copied with
its invariants).

Continuous batching admits work between *decode steps*, not between
requests: every step, queued requests move into free pool slots, every
active slot advances one token (prompt tokens are fed through the same
ragged decode path as generated ones), and finished slots are recycled
before the next step's admission.  The scheduler is pure host-side
bookkeeping — deterministic, device-free, and property-tested in
isolation (``tests/test_torch_serving.py``: no slot leak under random
admit/complete traces, FIFO admission fairness).

Invariants it maintains (checked by :meth:`Scheduler.check_invariants`):

* every submitted request is in exactly one of: queue, a slot, done;
* admission order == submission order (FIFO — no request overtakes
  another into a slot);
* at most ``queue_depth`` requests wait; ``submit`` refuses beyond that
  (back-pressure is the caller's problem, by design).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch import obs

__all__ = ["Request", "SlotState", "Scheduler"]


@dataclasses.dataclass
class Request:
    """One decode request: prompt in, ``max_new_tokens`` out."""

    rid: int
    prompt: np.ndarray  # (prompt_len,) int32 token ids
    max_new_tokens: int

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


@dataclasses.dataclass
class SlotState:
    """Per-slot progress of the resident request.

    ``fed`` counts prompt tokens already pushed through the decode path;
    the slot starts sampling on the step that feeds its last prompt
    token (that step's logits are the first next-token distribution).
    """

    request: Request
    fed: int = 0  # prompt tokens consumed
    generated: int = 0
    tokens: list = dataclasses.field(default_factory=list)

    @property
    def next_feed(self) -> int:
        """Token to feed this step: prompt while prefilling, else the
        previously sampled token."""
        if self.fed < self.request.prompt.size:
            return int(self.request.prompt[self.fed])
        return self.tokens[-1]

    @property
    def samples_this_step(self) -> bool:
        """Will this step's logits be sampled for this slot?  True once
        the token fed this step is the prompt's last (or any generated
        one) and the request still wants tokens."""
        return (
            self.fed >= self.request.prompt.size - 1
            and self.generated < self.request.max_new_tokens
        )

    @property
    def done(self) -> bool:
        return self.generated >= self.request.max_new_tokens


class Scheduler:
    """FIFO admission into a fixed set of decode slots."""

    def __init__(self, max_batch: int, queue_depth: int):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.max_batch = max_batch
        self.queue_depth = queue_depth
        self.queue: deque[Request] = deque()
        self.slots: list[SlotState | None] = [None] * max_batch
        self.done: list[Request] = []
        self._submitted = 0
        self._admitted_rids: list[int] = []
        self._submitted_rids: list[int] = []

    # -- intake ------------------------------------------------------------

    def submit(self, request: Request) -> bool:
        """Queue a request; ``False`` when the queue is at depth (the
        caller sheds load or retries — nothing is silently dropped)."""
        if len(self.queue) >= self.queue_depth:
            return False
        self.queue.append(request)
        self._submitted += 1
        self._submitted_rids.append(request.rid)
        if obs.enabled():
            obs.gauge("serve.queue_depth", len(self.queue))
        return True

    # -- per-step transitions ---------------------------------------------

    def admit(self, free_slots: list[int]) -> list[tuple[int, Request]]:
        """Move queued requests into ``free_slots`` (FIFO), returning the
        ``(slot, request)`` placements made this step."""
        placed = []
        for slot in free_slots:
            if not self.queue:
                break
            req = self.queue.popleft()
            self.slots[slot] = SlotState(req)
            self._admitted_rids.append(req.rid)
            placed.append((slot, req))
        if placed and obs.enabled():
            obs.counter("serve.admitted", len(placed))
            obs.gauge("serve.queue_depth", len(self.queue))
        return placed

    def complete(self, slot: int) -> Request:
        """Retire the request in ``slot`` (the pool recycles the slot)."""
        state = self.slots[slot]
        if state is None:
            raise RuntimeError(f"complete() of empty slot {slot}")
        self.slots[slot] = None
        self.done.append(state.request)
        if obs.enabled():
            obs.counter("serve.completed", 1)
        return state.request

    # -- views -------------------------------------------------------------

    @property
    def active_slots(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def queued(self) -> int:
        return len(self.queue)

    @property
    def pending(self) -> int:
        """Requests not yet retired (queued + resident)."""
        return len(self.queue) + self.active_slots

    def occupied(self) -> list[tuple[int, SlotState]]:
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def check_invariants(self) -> None:
        """Conservation + FIFO: every request is in exactly one place,
        and slot admission never reordered the submit sequence."""
        queued = [r.rid for r in self.queue]
        resident = [s.request.rid for s in self.slots if s is not None]
        retired = [r.rid for r in self.done]
        seen = queued + resident + retired
        assert len(seen) == len(set(seen)), f"request duplicated: {seen}"
        assert len(seen) == self._submitted, (
            f"request leak: {len(seen)} tracked != {self._submitted} submitted"
        )
        assert self.active_slots <= self.max_batch
        assert len(self.queue) <= self.queue_depth
        # FIFO: admitted order is a prefix-order-preserving subsequence of
        # submit order — equal as sequences since nothing else admits.
        expect = [r for r in self._submitted_rids
                  if r in set(self._admitted_rids)]
        assert self._admitted_rids == expect, (
            f"admission reordered: {self._admitted_rids} vs {expect}"
        )
