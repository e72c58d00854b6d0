"""The lock-step serving path: ``repro_torch.launch.serve.LockstepDecoder``.

One decoder of ``clients`` rows serves every batch, each from a fresh
cache (the port's ``init_cache``) through ``LockstepDecoder.generate``.
The harness's subclass adds, around the program's own ``_decode`` and
``_sample``: device stamps and profiler spans (``portbench.decode``,
``portbench.sample``) when tracing, and a copy of the logits of the rows
the check will read, taken before the sampler runs.
"""

from __future__ import annotations

import torch

from repro_torch.launch.serve import LockstepDecoder
from repro_torch.models.transformer import init_cache


class _Decoder(LockstepDecoder):
    probe = None

    def _decode(self, tokens):
        p = self.probe
        if not p.spans:
            return super()._decode(tokens)
        start = p.clock.stamp()
        with torch.profiler.record_function("portbench.decode"):
            out = super()._decode(tokens)
        p.decodes.append((start, p.clock.stamp()))
        return out

    def _sample(self, keys, logits):
        p = self.probe
        if p.keep_rows is not None:
            p.kept.append(logits.index_select(0, p.keep_rows))
        if not p.spans:
            return super()._sample(keys, logits)
        start = p.clock.stamp()
        with torch.profiler.record_function("portbench.sample"):
            out = super()._sample(keys, logits)
        p.samples.append((start, p.clock.stamp()))
        return out


class Probe:
    """What the subclass records: ``decodes`` and ``samples`` (pairs of
    stamps, when ``spans``), and ``kept`` (the logits of ``keep_rows`` at
    each generated step of the current batch)."""

    def __init__(self, clock):
        self.clock = clock
        self.spans = False
        self.decodes, self.samples, self.kept = [], [], []
        self.keep_rows = None


# ``LockstepDecoder._sample``'s own nucleus for ``topp``: p over k
# candidates, at temperature 1.  The decoder takes neither from its caller.
TOPP = (0.9, 64)


class Path:
    """The decoder takes ``top_k`` for ``topk``; for ``topp`` it fixes the
    nucleus itself (``TOPP``), so a traffic mix that asks for another is
    refused here rather than served at the decoder's and judged against
    its own."""

    def __init__(self, cfg, params, *, clients: int, max_len: int,
                 sampler: str, top_k: int, top_p: float | None = None,
                 seed: int, device, clock):
        if sampler == "topp" and (top_p, top_k) != TOPP:
            raise ValueError(f"the lock-step decoder samples topp at p, k = "
                             f"{TOPP}, not {(top_p, top_k)}")
        self.probe = Probe(clock)
        self.cfg, self.clients, self.max_len = cfg, clients, max_len
        self.device = device
        self.dec = _Decoder(cfg, params, batch=clients, max_len=max_len,
                            sampler=sampler, top_k=top_k or 50, seed=seed,
                            device=device)
        self.dec.probe = self.probe

    def run_batch(self, prompts, new_tokens: int, after_step, keep_rows=None):
        """Serve one batch from a fresh cache; ``keep_rows`` names the rows
        whose logits are kept.  Returns the served tokens ``(clients,
        new_tokens)`` and the kept logits ``(len(keep_rows), new_tokens,
        vocab)`` (or ``None``)."""
        p = self.probe
        p.kept = []
        p.keep_rows = (None if keep_rows is None else
                       torch.tensor(keep_rows, dtype=torch.long, device=self.device))
        self.dec.cache = None
        self.dec.cache = init_cache(self.cfg, self.clients, self.max_len,
                                    device=self.device)
        served = self.dec.generate(prompts, new_tokens, after_step=after_step)
        kept = torch.stack(p.kept, dim=1) if p.kept else None
        p.kept, p.keep_rows = [], None
        return served, kept

    def free(self) -> None:
        """Drop the program's state: its cache and its compute copy of the
        weights."""
        self.dec = None
