"""Continuous-batching decode engine: admission -> ragged step -> sample
(torch port of ``repro.serving.engine``).

One :class:`DecodeEngine` owns a :class:`~repro_torch.serving.scheduler.Scheduler`
(FIFO queue + per-slot progress), a :class:`~repro_torch.serving.kv_pool.KVPool`
(fixed-capacity recyclable cache slots) and the two device stages of a
step, whose shapes are fixed by the pool, however occupancy churns:

* the ragged decode step (``decode_step_ragged``): every slot advances one
  token at its own position; inactive slots ride along masked (their
  lengths are held back, so their writes are never readable history);
* the batched sampler (``repro_torch.serving.sampling``): one merge per
  block-sort pass and per tournament round for the whole batch, each a
  grouped launch of ``merge_kway_tile`` on the card.

Prompt tokens are fed through the same decode path as generated ones
(iteration-level scheduling): a request admitted at step ``t`` joins the
batch at once, with no prefill entry point and no barrier on the others.

The steps run eagerly.  A step copies its inputs to the device once (one
packed ``(4, b)`` array: tokens, active flags, request ids, token
indices) and its sampled tokens back once, as the reference blocks on
them.

Determinism contract: a request's token stream is a function of ``(engine
seed, request id, prompt, sampler settings)`` alone -- the sampling key
hashes ``(seed, rid, token index)``, never the slot or the step -- so
streams are the same across runs, pool sizes and any admission
interleaving.  ``tests/test_torch_serving.py`` pins this.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import compute_params, decode_step_ragged
from repro_torch.serving.kv_pool import KVPool
from repro_torch.serving.sampling import (
    request_keys,
    sample_greedy,
    sample_topk_batched,
    sample_topp_batched,
)
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["DecodeEngine"]


class DecodeEngine:
    """Serve decode requests with per-step admission over a slot pool.

    ``params`` is the model's tree (``init_params`` or
    ``params_from_numpy``) on ``device``; the engine casts its weights to
    the compute dtype once (``compute_params``).  ``device`` defaults to
    the params' device.
    """

    def __init__(self, cfg: ModelConfig, params, *, max_len: int,
                 max_batch: int = 0, queue_depth: int = 0,
                 sampler: str = "topk", top_k: int = 50, top_p: float = 0.9,
                 temperature: float = 1.0, seed: int = 42,
                 cache_dtype=torch.bfloat16, device=None):
        if sampler not in ("greedy", "topk", "topp"):
            raise ValueError(f"unknown sampler {sampler!r}")
        max_batch = max_batch or cfg.max_batch
        queue_depth = queue_depth or cfg.queue_depth
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else (
            params["embed"]["table"].device)
        self.params = compute_params(cfg, params)
        self.max_len = max_len
        self.sampler = sampler
        self.top_k = min(top_k, cfg.vocab)
        self.top_p = top_p
        self.temperature = temperature
        self.seed = seed
        self.pool = KVPool(cfg, max_batch, max_len, cache_dtype, self.device)
        self.scheduler = Scheduler(max_batch, queue_depth)
        self.results: dict[int, list[int]] = {}
        self.steps = 0

    # -- intake ------------------------------------------------------------

    def submit(self, request: Request) -> bool:
        """Queue a request; ``False`` on a full queue.  A request that
        cannot fit the pool's per-slot sequence capacity raises."""
        need = request.prompt.size + request.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"request {request.rid}: prompt + max_new_tokens = {need} "
                f"exceeds pool max_len {self.max_len}"
            )
        return self.scheduler.submit(request)

    # -- the two device stages of a step -----------------------------------

    def _decode(self, tokens: torch.Tensor, active: torch.Tensor):
        """Ragged decode of every slot; only active slots bank their
        position (inactive ones re-write the same masked cell next step).
        Returns the logits (b, vocab)."""
        cache = self.pool.cache
        logits, new_cache = decode_step_ragged(
            self.cfg, self.params, cache, tokens, cache.length)
        lengths = torch.where(active, cache.length + 1, cache.length)
        self.pool.set_cache(new_cache.data, lengths)
        return logits

    def _sample(self, keys: torch.Tensor, logits: torch.Tensor):
        if self.sampler == "greedy":
            return sample_greedy(logits)
        if self.sampler == "topk":
            return sample_topk_batched(
                keys, logits, k=self.top_k, temperature=self.temperature,
                fanout=self.cfg.fanout,
            )
        return sample_topp_batched(
            keys, logits, p=self.top_p, k=self.top_k,
            temperature=self.temperature, fanout=self.cfg.fanout,
        )

    # -- one engine step ---------------------------------------------------

    def step(self) -> dict:
        """Admit, advance every active slot one token, sample, retire.

        Returns ``{"admitted": [rids], "sampled": {rid: token},
        "completed": [rids], "active": int}`` for the caller's loop.
        """
        sched, pool = self.scheduler, self.pool
        t0 = time.perf_counter()

        n_free = min(pool.free_slots, sched.queued)
        placed = sched.admit([pool.alloc() for _ in range(n_free)])
        if obs.enabled():
            obs.gauge("serve.active_slots", sched.active_slots,
                      capacity=pool.capacity)
        occupied = sched.occupied()
        if not occupied:
            return {"admitted": [], "sampled": {}, "completed": [],
                    "active": 0}

        # tokens, active flags, request ids, token indices: one copy
        host = np.zeros((4, pool.capacity), np.int64)
        due = np.zeros((pool.capacity,), bool)
        for slot, st in occupied:
            host[:, slot] = (st.next_feed, 1, st.request.rid, st.generated)
            due[slot] = st.samples_this_step
        dev = torch.from_numpy(host).to(self.device)

        logits = self._decode(dev[0][:, None], dev[1].bool())
        keys = request_keys(self.seed, dev[2], dev[3])
        nxt = self._sample(keys, logits).cpu().numpy()  # blocks: step done

        sampled: dict[int, int] = {}
        completed: list[int] = []
        for slot, st in occupied:
            if st.fed < st.request.prompt.size:
                st.fed += 1
            if due[slot]:
                tok = int(nxt[slot])
                st.tokens.append(tok)
                st.generated += 1
                sampled[st.request.rid] = tok
            if st.done:
                req = sched.complete(slot)
                pool.free(slot)
                self.results[req.rid] = list(st.tokens)
                completed.append(req.rid)

        self.steps += 1
        if obs.enabled():
            obs.gauge("serve.step_latency",
                      (time.perf_counter() - t0) * 1e6,
                      batch=len(occupied), unit="us")
        return {"admitted": [r.rid for _, r in placed], "sampled": sampled,
                "completed": completed, "active": len(occupied)}

    # -- drive -------------------------------------------------------------

    @property
    def pending(self) -> int:
        return self.scheduler.pending

    def run(self, max_steps: int = 100_000,
            arrivals=None) -> dict[int, list[int]]:
        """Step until every submitted request retires.

        ``arrivals``: optional iterable of ``(step, Request)`` injected
        when the engine reaches that step (staggered arrivals).  Returns
        ``{rid: generated tokens}``.
        """
        schedule = sorted(arrivals or [], key=lambda a: a[0])
        i = 0
        while True:
            while i < len(schedule) and schedule[i][0] <= self.steps:
                if not self.submit(schedule[i][1]):
                    break  # queue full: retry next step
                i += 1
            if self.pending == 0 and i == len(schedule):
                return dict(self.results)
            if self.steps >= max_steps:
                raise RuntimeError(
                    f"engine did not drain in {max_steps} steps "
                    f"({self.pending} pending)"
                )
            self.step()
