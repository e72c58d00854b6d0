"""The one traffic generator: a traffic file's parameters and ``--seed``
give every batch of requests the run sends.

A file (``traffic/<name>.json``) has ``loop`` (``closed``: each of
``clients`` clients sends its next request when its last one ends; on the
lock-step path the clients form one batch and the next batch starts when
the last one ends), ``prompt_len`` (one length for every prompt: the
lock-step path takes a batch of equal prompts), ``new_tokens``,
``prompt_tokens`` (``uniform``: ids drawn uniformly from 1 to the
configuration's prompt vocabulary), ``sampler`` (``greedy``, ``topk`` or
``topp``), for ``topk`` and ``topp`` ``top_k`` (the candidates), and for
``topp`` ``top_p`` (the nucleus: in (0, 1]).

``new_tokens`` is either one count for every request, or a length
distribution ``{"lognormal": {"median": m, "sigma": s}, "scale": f,
"max": n}``: each batch's ``clients`` requests ask for the ``clients``
quantiles ``(i + 1/2) / clients`` of that lognormal, times ``f``, rounded
and held to ``[1, n]``.  Every batch of every seed asks for the same set of
counts, and the seed only decides which row asks for which, so a seed
changes the requests and not the work.  The batch runs ``max`` of its
counts steps; a request is finished at its own count.

Batch ``j`` of a seed is drawn from ``(seed, j)`` alone, so two runs of one
seed send the same requests.  Other keys (``source``, ``reduced``,
``assumed``, ``why``) describe the mix and are not read.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

LOOPS = ("closed",)
SAMPLERS = ("greedy", "topk", "topp")


def length_set(spec, clients: int) -> np.ndarray:
    """The new-token counts of one batch, in ascending order."""
    if isinstance(spec, int):
        return np.full(clients, spec, dtype=np.int64)
    ln = spec["lognormal"]
    z = [NormalDist().inv_cdf((i + 0.5) / clients) for i in range(clients)]
    raw = [ln["median"] * math.exp(ln["sigma"] * zi) * spec["scale"] for zi in z]
    return np.clip(np.rint(raw), 1, spec["max"]).astype(np.int64)


class Traffic:
    def __init__(self, params: dict, seed: int, prompt_vocab: int):
        if params["loop"] not in LOOPS:
            raise ValueError(f"unknown loop {params['loop']!r}")
        if params["sampler"] not in SAMPLERS:
            raise ValueError(f"unknown sampler {params['sampler']!r}")
        if params["prompt_tokens"] != "uniform":
            raise ValueError(f"unknown prompt_tokens {params['prompt_tokens']!r}")
        self.clients = int(params["clients"])
        self.prompt_len = int(params["prompt_len"])
        self.lengths = length_set(params["new_tokens"], self.clients)
        self.new_tokens = int(self.lengths.max())  # steps a batch runs
        self.sampler = params["sampler"]
        self.top_k = int(params.get("top_k", 0))
        self.top_p = None
        if self.sampler == "topp":
            self.top_p = float(params.get("top_p", math.nan))  # absent: refused
            if not 0.0 < self.top_p <= 1.0 or self.top_k < 1:
                raise ValueError(f"topp needs 0 < top_p <= 1 and top_k >= 1, "
                                 f"got {self.top_p!r}, {self.top_k!r}")
        self.seed = int(seed) % (1 << 64)
        self.prompt_vocab = prompt_vocab

    def prompts(self, batch: int) -> np.ndarray:
        """Batch ``batch``'s prompts: int64 ``(clients, prompt_len)``."""
        rng = np.random.default_rng([self.seed, batch])
        return rng.integers(1, self.prompt_vocab,
                            (self.clients, self.prompt_len), dtype=np.int64)

    def asks(self, batch: int) -> np.ndarray:
        """Batch ``batch``'s new-token counts, one a row: the batch's set
        in an order drawn from ``(seed, batch)``."""
        rng = np.random.default_rng([self.seed, batch, 1])
        return rng.permutation(self.lengths)

    def warmup_prompts(self, length: int = 2) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 1 << 40])
        return rng.integers(1, self.prompt_vocab, (self.clients, length),
                            dtype=np.int64)
