"""Seeded random weights, made on the device in the dtype they are stored in.

Every family module builds its tree with :func:`normal` and :func:`full`,
in one fixed order of calls on one ``torch.Generator`` seeded from
``--seed``, so the same seed gives the same weights, and a leaf is drawn
straight into its storage dtype a large slab at a time (no float32 copy of
a bfloat16 model is ever held).  As in the port's ``init_params``, every
leaf of two or more dimensions is stored in the parameter dtype, stacks
of per-layer vectors (norm scales, the Mamba2 vectors) included.
"""

from __future__ import annotations

import torch

# Elements drawn per call: 2^30 (2 GiB of bfloat16), a few calls a leaf.
SLAB = 1 << 30


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    """``std`` times a standard normal, drawn in place in ``dtype``."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for lo in range(0, flat.numel(), SLAB):
        flat[lo:lo + SLAB].normal_(0.0, std, generator=gen)
    return out


def uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    """Float32 uniform in ``[lo, hi)``."""
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        lo, hi, generator=gen)


def full(shape, value: float, dtype, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=device)
