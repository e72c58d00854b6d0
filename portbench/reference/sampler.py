"""The samplers, plainly: greedy, and top-k and top-p with the per-request
draw.

Greedy is the first index of the largest logit.  Top-k takes the ``k``
largest logits by a stable sort (equal logits to the lower token id), and
draws one by Gumbel-max: candidate ``j`` (in that order) scores
``log(p_j + 1e-20) + G_j``, ``p`` the softmax of the ``k`` logits and
``G_j = -log(-log(u_j))`` with ``u_j`` a 32-bit counter hash of the
request's key and ``j`` mapped into (0, 1); the request's key hashes
``(seed, row, token index)``.  Top-p takes the same ``k`` candidates
and their softmax (temperature 1), keeps a candidate while the sum of the
probabilities before it is under ``p`` (the first always stays), zeroes
the rest, and draws by the same Gumbel-max over all ``k``.  The hash and
the draw are frozen copies of the port's definition
(``repro_torch.serving.sampling``), so a change of that definition shows
as a mismatch.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def request_key(seed: int, row: int, token_idx: int, device) -> torch.Tensor:
    """The key of ``row``'s draw at ``token_idx``: int64 ``(1,)``."""
    r = torch.tensor([row], dtype=torch.int64, device=device)
    s = _mix32(torch.full_like(r, seed & _MASK32))
    return _mix32(_mix32(s ^ (r & _MASK32)) ^ (token_idx & _MASK32))


def _gumbel_choice(key: torch.Tensor, probs: torch.Tensor) -> int:
    j = torch.arange(probs.shape[-1], dtype=torch.int64, device=probs.device)
    h = _mix32(key[:, None] ^ _mix32(j + 0x9E3779B9))
    u = (h.double() + 0.5) * (1.0 / 4294967296.0)
    score = torch.log(probs + 1e-20).double() - torch.log(-torch.log(u))
    return int(torch.argmax(score, dim=-1)[0])


def greedy(row: torch.Tensor) -> int:
    return int(torch.argmax(row))


def topk(row: torch.Tensor, key: torch.Tensor, k: int) -> int:
    """The token drawn from ``row``'s top ``k`` with ``key``."""
    order = torch.sort(row, descending=True, stable=True).indices[:k]
    probs = torch.softmax(row[order].float() / 1.0, dim=-1)
    return int(order[_gumbel_choice(key, probs[None])])


def topp(row: torch.Tensor, key: torch.Tensor, p: float, k: int) -> int:
    """The token drawn with ``key`` from the nucleus ``p`` of ``row``'s top
    ``k``."""
    order = torch.sort(row, descending=True, stable=True).indices[:k]
    probs = torch.softmax(row[order].float(), dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < p
    probs = torch.where(keep, probs, 0.0)
    return int(order[_gumbel_choice(key, probs[None])])


def choose(row: torch.Tensor, *, sampler: str, seed: int, row_id: int,
           token_idx: int, k: int, p: float | None = None) -> int:
    if sampler == "greedy":
        return greedy(row)
    key = request_key(seed, row_id, token_idx, row.device)
    if sampler == "topk":
        return topk(row, key, k)
    if sampler == "topp":
        return topp(row, key, p, k)
    raise ValueError(f"unknown sampler {sampler!r}")
