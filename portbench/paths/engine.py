"""The continuous serving path: ``repro_torch.serving.DecodeEngine``.

Every batch is served by a fresh engine, whose pool holds ``clients``
slots and whose queue takes them all: row ``r``'s request has the id
``r`` (its sampling keys are ``(seed, r, i)``, as a lock-step row's are)
and asks for the batch's ``new_tokens``.  All are admitted at the first
step, the prompt is fed one token a step through the ragged decode step,
a slot samples from the step that feeds its prompt's last token, and the
engine steps until it drains: ``prompt_len + new_tokens - 1`` steps.

The harness's subclass adds, around the program's own ``_decode`` and
``_sample`` as ``paths/lockstep.py`` does, device stamps and profiler
spans (``portbench.decode``, ``portbench.sample``) when tracing, and a
copy of the logits of the rows the check will read, taken before the
sampler runs at the steps where those rows sample.  When tracing it also
marks the engine's own host work of a step, on either side of those two
spans, as ``portbench.engine``: admission and the packed input copy
before the decode; the blocking readback of the sampled tokens and the
retire loop after the sampler (``metrics/engine_gap_ms.py`` reads it).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import compute_params
from repro_torch.serving import DecodeEngine, Request

HOST_SPAN = "portbench.engine"


class _Engine(DecodeEngine):
    probe = None
    _host = None  # the open host-work span, while tracing

    def _open_host(self) -> None:
        self._host = torch.profiler.record_function(HOST_SPAN)
        self._host.__enter__()

    def _close_host(self) -> None:
        if self._host is not None:
            self._host.__exit__(None, None, None)
            self._host = None

    def step(self):
        if not self.probe.spans:
            return super().step()
        self._open_host()
        try:
            return super().step()
        finally:
            self._close_host()

    def _decode(self, tokens, active):
        p = self.probe
        if not p.spans:
            return super()._decode(tokens, active)
        self._close_host()
        start = p.clock.stamp()
        with torch.profiler.record_function("portbench.decode"):
            out = super()._decode(tokens, active)
        p.decodes.append((start, p.clock.stamp()))
        return out

    def _sample(self, keys, logits):
        p = self.probe
        p.keep(self.scheduler, logits)
        if not p.spans:
            return super()._sample(keys, logits)
        start = p.clock.stamp()
        with torch.profiler.record_function("portbench.sample"):
            out = super()._sample(keys, logits)
        p.samples.append((start, p.clock.stamp()))
        self._open_host()
        return out


class Probe:
    """What the subclass records: ``decodes`` and ``samples`` (pairs of
    stamps, when ``spans``), and ``kept`` (the logits of the requests
    ``keep_rows`` at each step where they sample, in the current
    batch)."""

    def __init__(self, clock):
        self.clock = clock
        self.spans = False
        self.decodes, self.samples, self.kept = [], [], []
        self.keep_rows = None
        self._slots = self._index = None

    def start(self, keep_rows) -> None:
        self.kept, self.keep_rows = [], keep_rows
        self._slots = self._index = None

    def keep(self, scheduler, logits) -> None:
        if self.keep_rows is None:
            return
        if self._slots is None:  # the batch's slots, once all are admitted
            where = {st.request.rid: s for s, st in scheduler.occupied()}
            self._slots = [where[r] for r in self.keep_rows]
            self._index = torch.tensor(self._slots, dtype=torch.long,
                                       device=logits.device)
        states = [scheduler.slots[s] for s in self._slots]
        if all(st is not None and st.samples_this_step for st in states):
            self.kept.append(logits.index_select(0, self._index))


class Path:
    def __init__(self, cfg, params, *, clients: int, max_len: int,
                 sampler: str, top_k: int, top_p: float | None = None,
                 seed: int, device, clock):
        self.probe = Probe(clock)
        self.cfg, self.clients, self.max_len = cfg, clients, max_len
        self.sampler, self.top_k, self.seed = sampler, top_k or 50, seed
        self.top_p = top_p  # the engine reads it for topp only
        self.device = device
        self.params = compute_params(cfg, params)
        self.eng = None

    def run_batch(self, prompts, new_tokens: int, after_step, keep_rows=None):
        """Serve one batch from a fresh pool; ``keep_rows`` names the rows
        whose logits are kept.  ``after_step(i + 1)`` follows the step that
        samples token ``i``.  Returns the served tokens ``(clients,
        new_tokens)`` and the kept logits ``(len(keep_rows), new_tokens,
        vocab)`` (or ``None``)."""
        p = self.probe
        p.start(None if keep_rows is None else list(keep_rows))
        self.eng = None  # the last batch's pool goes before the next is made
        eng = self.eng = _Engine(
            self.cfg, self.params, max_len=self.max_len,
            max_batch=self.clients, queue_depth=self.clients,
            sampler=self.sampler, top_k=self.top_k, top_p=self.top_p,
            seed=self.seed, device=self.device)
        eng.probe = p
        for r, prompt in enumerate(prompts):
            eng.submit(Request(r, prompt, new_tokens))
        done = 0
        while eng.pending:
            if eng.step()["sampled"]:
                done += 1
                after_step(done)
        served = np.array([eng.results[r] for r in range(len(prompts))],
                          dtype=np.int64)
        kept = torch.stack(p.kept, dim=1) if p.kept else None
        p.start(None)
        return served, kept

    def free(self) -> None:
        """Drop the program's state: the engine, its pool and the compute
        copy of the weights."""
        self.eng = self.params = None
