"""The comparison that decides ``correct``.

Once the window has closed, a sample of the finished requests, drawn from
the seed among those whose logits the harness kept (rows drawn from both
halves of every batch) and half from each half of a batch's rows, is held
against the plain reference (``reference/<family>.py``, float32, TF32
off), which runs once over each request's prompt and the tokens it asked
for.  The numbers:

* ``decode_gap``: at every generated position of the sample, how far the
  reference's logit of the token the program's logits put first lies below
  the reference's best, in standard deviations of the reference's logits
  at that position; the widest such gap.  It judges the decode step (every
  layer of the model) through what the sampler is given.  The unit keeps
  the number apart from the scale of a model's logits, so the CPU tests'
  small widths read it as the cells do.
* ``decode_gap_mean``: the same gaps' mean over the positions.  A cell
  whose model swings its widest gap from seed to seed (a router's choice
  flipped by rounding moves one position a long way) compares this one.
* ``sampler_mismatch``: served tokens that differ from what the plain
  sampler (``reference/sampler.py``) chooses from the program's own logits
  of that position, with the request's key.  It judges the sampler (its
  top-k set, top-p's nucleus cut and the draw), and whether the served
  token is the one the program chose; an exact comparison.

A cell's file (``limits``) names the numbers it compares, each with its
limit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import sampler as ref_sampler
from portbench.reference.common import Precision, float32_only


@dataclasses.dataclass
class Request:
    """One finished request: its prompt and served tokens, the program's
    logits at each generated position (float32, ``(new, vocab)``), and
    the lock-step row it was served in."""

    row: int
    prompt: np.ndarray
    served: np.ndarray
    logits: torch.Tensor


def halves(n: int, k: int, rng) -> list:
    """``k`` of the rows ``0..n-1``, half of them drawn from each half of
    the batch (all rows if ``n <= k``), ascending.  A fault that spoils one
    half of a batch always reaches the sample."""
    if n <= k:
        return list(range(n))
    lo = rng.choice(n // 2, size=k // 2, replace=False)
    hi = n // 2 + rng.choice(n - n // 2, size=k - k // 2, replace=False)
    return sorted(int(r) for r in np.concatenate([lo, hi]))


def draw(requests: list, seed: int, n: int, clients: int) -> list:
    """``n`` of ``requests``, drawn from the seed, half of them served in
    the first half of a batch's rows and half in the second (all of them
    if fewer)."""
    if len(requests) <= n:
        return list(requests)
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    pick = []
    for side, want in ((0, n // 2), (1, n - n // 2)):
        idx = [i for i, r in enumerate(requests)
               if (r.row >= clients // 2) == side]
        pick += rng.choice(idx, size=min(want, len(idx)), replace=False).tolist()
    return [requests[i] for i in sorted(pick)]


def reference_logits(ref, spec: dict, weights: dict, reqs: list, device,
                     precision: str = "fp32") -> torch.Tensor:
    """The reference's logits at every generated position of ``reqs``:
    ``(len(reqs), n, vocab)`` float32, ``n`` the longest request's count,
    from one pass over each prompt and its served tokens (the last served
    token is not fed).  A shorter request is padded by repeating its last
    token; its logits past its own count are not read."""
    float32_only()
    n = max(len(r.served) for r in reqs)
    seqs = np.stack([np.concatenate([r.prompt, np.pad(r.served,
                                                      (0, n - len(r.served)),
                                                      mode="edge")])
                     for r in reqs])
    p = len(reqs[0].prompt)
    tokens = torch.from_numpy(seqs[:, :-1].astype(np.int64)).to(device)
    positions = list(range(p - 1, p - 1 + n))
    with torch.no_grad():
        return ref.logits(spec, weights, tokens, positions, Precision(precision))


def position_gaps(ref_logits: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """At each position, the gap between the reference's best logit and its
    logit of the token ``first`` names there (same leading shape), over the
    standard deviation of the reference's logits there."""
    best = ref_logits.max(dim=-1).values
    chosen = torch.gather(ref_logits, -1, first[..., None].long())[..., 0]
    return (best - chosen) / ref_logits.std(dim=-1)


def request_gaps(ref_logits: torch.Tensor, reqs: list, firsts: list) -> torch.Tensor:
    """:func:`position_gaps` at each request's own positions, ``firsts[i]``
    naming the first token at each of request ``i``'s (and maybe past its
    count, where it is not read), all in one vector."""
    return torch.cat([position_gaps(ref_logits[i, :len(r.served)],
                                    f[:len(r.served)].to(ref_logits.device))
                      for i, (r, f) in enumerate(zip(reqs, firsts))])


def decode_gaps(ref_logits: torch.Tensor, reqs: list) -> dict:
    """``decode_gap`` and ``decode_gap_mean`` of the program's logits."""
    # argmax: the first index of the largest
    gaps = request_gaps(ref_logits, reqs,
                        [torch.argmax(r.logits, dim=-1) for r in reqs])
    return {"decode_gap": float(gaps.max()),
            "decode_gap_mean": float(gaps.double().mean())}


def sampler_mismatch(reqs: list, *, sampler: str, seed: int, k: int,
                     p: float | None = None) -> int:
    bad = 0
    for r in reqs:
        for i, token in enumerate(r.served.tolist()):
            want = ref_sampler.choose(r.logits[i], sampler=sampler, seed=seed,
                                      row_id=r.row, token_idx=i, k=k, p=p)
            bad += int(want != token)
    return bad


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct when none is over."""
    table = {name: {"value": numbers[name], "limit": limits[name]}
             for name in limits}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
