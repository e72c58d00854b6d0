"""Sampling on merge-sorted logits (torch port of ``repro.serving.sampling``).

top-k uses the merge tournament (``repro_torch.core.topk``); top-p keeps
the merge-sorted prefix whose boundary is the engine's value-keyed cut, so
equal logits resolve toward the lower token id.

Two call shapes, as in the reference:

* the per-request references :func:`sample_topk` / :func:`sample_topp`
  run one single-row tournament per request: the semantics oracle;
* the batched serving forms :func:`sample_topk_batched` /
  :func:`sample_topp_batched` push the whole decode batch through
  ``merge_topk_batch``: one merge per block-sort pass and per tournament
  round for the whole batch, each a grouped launch of ``merge_kway_tile``
  on the card.  Per request, both shapes give the same token bit for bit.

**The draw is the port's own.**  The reference draws with
``jax.random.categorical`` on threefry keys, which torch cannot
reproduce.  Here a request's key is a stateless 32-bit counter hash of
``(seed, request id, token index)`` (:func:`request_keys`), and the draw
is Gumbel-max over the ``k`` candidates: candidate ``j`` scores
``log(p_j + 1e-20) + G_j``, with ``G_j = -log(-log(u_j))`` and ``u_j`` the
hash of ``(key, j)`` mapped into (0, 1); the token is the best-scoring
candidate (the first on a tie).  The hash is int64 tensor arithmetic on
the device, so a token depends only on the seed, the request id, the
token index and the logits -- never on the slot, the step, the batch or
the other requests -- and the draw needs no host sync and no per-request
``torch.Generator``.  The ``log(p + 1e-20)`` guard is the reference's.

Under a profiler each sampler's merge tournament sits in a
``sample.topk`` span and the rest of its draw in a ``sample.draw`` span:
once a call in the batched forms (the lock-step decoder's ``topk`` and
the engine's samplers), once a row in the per-request forms (the
lock-step decoder's ``topp``).
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core import engine
from repro_torch.core.topk import (
    candidate_blocks,
    merge_topk,
    merge_topk_batch,
    tournament_rounds,
)

__all__ = [
    "request_keys",
    "sample_greedy",
    "sample_topk",
    "sample_topp",
    "sample_topk_batched",
    "sample_topp_batched",
    "batched_topk",
    "nucleus_counts",
]

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 tensors holding 32-bit values, in
    16-bit halves so that no product leaves the int64 range."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (xor-shift-multiply; constants of
    Wellons' "lowbias32") on int64 tensors holding 32-bit values."""
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def request_keys(seed: int, rids: torch.Tensor,
                 token_idx: torch.Tensor) -> torch.Tensor:
    """Per-request sampling keys, int64 ``(b,)`` holding 32-bit values:
    the hash of ``(seed, rids[i], token_idx[i])``, each taken mod 2^32."""
    rids = rids.to(torch.int64)
    s = _mix32(torch.full_like(rids, seed & _MASK32))
    return _mix32(_mix32(s ^ (rids & _MASK32)) ^ (token_idx.to(torch.int64)
                                                  & _MASK32))


def _gumbel_choice(keys: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Index into each row of ``probs`` (b, k) drawn by Gumbel-max with
    the counter-hash uniforms of ``keys`` (b,)."""
    k = probs.shape[-1]
    j = torch.arange(k, dtype=torch.int64, device=probs.device)
    h = _mix32(keys.to(probs.device)[:, None] ^ _mix32(j + 0x9E3779B9))
    u = (h.double() + 0.5) * (1.0 / 4294967296.0)  # in (0, 1)
    gumbel = -torch.log(-torch.log(u))
    score = torch.log(probs + 1e-20).double() + gumbel
    return torch.argmax(score, dim=-1)


# ---------------------------------------------------------------------------
# per-request references (the semantics oracle)
# ---------------------------------------------------------------------------


def sample_topk(keys, logits, k: int = 50, temperature: float = 1.0,
                fanout: int = 0):
    """logits: (b, vocab) -> token ids (b,) int32 sampled from the top-k
    set, one single-row tournament per request."""
    out = []
    for i in range(logits.shape[0]):
        with obs.span("sample.topk"):
            vals, idx = merge_topk(logits[i], k, fanout=fanout)
        with obs.span("sample.draw"):
            probs = torch.softmax(vals.float() / temperature, dim=-1)
            out.append(idx[_gumbel_choice(keys[i:i + 1], probs[None])])
    return torch.cat(out)


def sample_topp(keys, logits, p: float = 0.9, k: int = 256,
                temperature: float = 1.0, fanout: int = 0):
    """Nucleus sampling over merge-sorted top-k candidates, per request."""
    out = []
    for i in range(logits.shape[0]):
        with obs.span("sample.topk"):
            vals, idx = merge_topk(logits[i], k, fanout=fanout)
        with obs.span("sample.draw"):
            probs = torch.softmax(vals.float() / temperature, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep = cum - probs < p  # first token always kept
            probs = torch.where(keep, probs, 0.0)
            out.append(idx[_gumbel_choice(keys[i:i + 1], probs[None])])
    return torch.cat(out)


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """Arg-max token per row (the first on a tie), int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# batched serving forms: one merge per pass and round for the whole batch
# ---------------------------------------------------------------------------


def _record_topk_metrics(b: int, n: int, k: int, fanout: int) -> None:
    """Static tournament geometry -> the ``serve.topk_*`` evidence: the
    merges a step costs after the block sort (independent of the batch)
    and the candidates entering the final merge."""
    if not obs.enabled():
        return
    _, nb = candidate_blocks(n, k)
    rounds = tournament_rounds(nb, fanout)
    final_runs = rounds[-1] if rounds else 1
    obs.gauge("serve.topk_merge_rounds", len(rounds),
              batch=b, blocks=nb, fanout=fanout or 0)
    obs.counter("serve.topk_candidates", b * final_runs * k,
                batch=b, k=k)


def batched_topk(logits: torch.Tensor, k: int = 50, fanout: int = 0):
    """Row-wise ``(values, indices)`` top-k of a ``(b, vocab)`` batch,
    bit-identical per row to ``merge_topk(logits[i], k)``."""
    b, n = logits.shape
    _record_topk_metrics(b, n, k, fanout)
    return merge_topk_batch(logits, k, fanout=fanout)


def sample_topk_batched(keys, logits, k: int = 50,
                        temperature: float = 1.0, fanout: int = 0):
    """Batched top-k sampling with per-request ``keys`` (from
    :func:`request_keys`): the same token per row as :func:`sample_topk`
    given the same key."""
    with obs.span("sample.topk"):
        vals, idx = batched_topk(logits, k, fanout=fanout)
    with obs.span("sample.draw"):
        probs = torch.softmax(vals.float() / temperature, dim=-1)
        choice = _gumbel_choice(keys, probs)
        return torch.gather(idx, 1, choice[:, None])[:, 0]


def nucleus_counts(probs: torch.Tensor, p: float) -> torch.Tensor:
    """Candidates kept per row of descending ``probs`` (b, k): the value
    cut of ``p`` into the row's non-decreasing ``cum - probs`` run, int32
    ``(b,)`` (at least 1 for ``p > 0``)."""
    cum = torch.cumsum(probs, dim=-1)
    bound = torch.full((probs.shape[0], 1), p, dtype=torch.float32,
                       device=probs.device)
    return engine.value_cut_counts(cum - probs, bound)[:, 0]


def sample_topp_batched(keys, logits, p: float = 0.9, k: int = 256,
                        temperature: float = 1.0, fanout: int = 0):
    """Batched nucleus sampling.  The nucleus of each request is the
    engine's value-keyed cut into its sorted ``cum - probs`` run
    (``value_cut_counts``: one ``searchsorted`` per request), the same
    prefix as the reference's ``cum - probs < p`` since that run is
    non-decreasing."""
    with obs.span("sample.topk"):
        vals, idx = batched_topk(logits, k, fanout=fanout)
    with obs.span("sample.draw"):
        probs = torch.softmax(vals.float() / temperature, dim=-1)
        n_keep = nucleus_counts(probs, p)
        keep = torch.arange(k, dtype=torch.int32,
                            device=probs.device)[None, :] < n_keep[:, None]
        probs = torch.where(keep, probs, 0.0)
        choice = _gumbel_choice(keys, probs)
        return torch.gather(idx, 1, choice[:, None])[:, 0]
