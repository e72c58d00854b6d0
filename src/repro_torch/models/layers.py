"""Shared model building blocks (torch port of ``repro.models.layers``).

Plain functions on nested dicts of tensors, as the reference's params
pytrees: the carry-over from the reference (``models.convert``) is then a
leaf-for-leaf copy.  Each ``init_*`` takes an explicit
``torch.Generator`` and a required ``device`` keyword and returns the params alone (the
reference also returns sharding specs, which the port has no use for).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "truncated_normal",
    "init_rmsnorm",
    "rmsnorm",
    "init_embedding",
    "embed",
    "unembed",
    "init_mlp",
    "mlp",
    "rope_frequencies",
    "apply_rope",
    "sinusoidal_positions",
]


# Elements drawn in float32 at a time (1 GiB): a full-width leaf is drawn
# and cast chunk by chunk, so float32 never holds more than one chunk.
DRAW_CHUNK = 1 << 28


def truncated_normal(gen: torch.Generator, shape, std: float,
                     dtype=torch.float32, *, device) -> torch.Tensor:
    """``std`` times a normal truncated to [-2, 2], drawn from ``gen``
    (which lives on ``device``) in float32 and stored in ``dtype``, at
    most :data:`DRAW_CHUNK` elements at a time."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for lo in range(0, flat.numel(), DRAW_CHUNK):
        n = min(DRAW_CHUNK, flat.numel() - lo)
        t = torch.empty((n,), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        flat[lo:lo + n] = t.mul_(std)
    return out


# -- normalisation -----------------------------------------------------------


def init_rmsnorm(d: int, *, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalisation over the last axis, in float32 inside."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


# -- embeddings --------------------------------------------------------------


def init_embedding(gen, vocab: int, d: int, *, device, dtype=torch.float32):
    return {"table": truncated_normal(gen, (vocab, d), 0.02, dtype,
                                      device=device)}


def embed(params, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return params["table"].to(dtype)[tokens]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Project activations to vocab logits (tied or untied table)."""
    return torch.einsum("bsd,vd->bsv", x, params["table"].to(x.dtype))


# -- MLP ---------------------------------------------------------------------


def init_mlp(gen, d: int, ff: int, kind: str = "swiglu", *, device,
             layers: tuple = (), dtype=torch.float32):
    """MLP weights, stored in ``dtype``; ``layers`` prepends stacked-layer
    axes to each."""
    std_in = 1.0 / math.sqrt(d)
    std_out = 1.0 / math.sqrt(ff)
    names = ("w_gate", "w_up") if kind == "swiglu" else ("w_up",)
    p = {n: truncated_normal(gen, (*layers, d, ff), std_in, dtype,
                             device=device)
         for n in names}
    p["w_down"] = truncated_normal(gen, (*layers, ff, d), std_out, dtype,
                                   device=device)
    return p


def mlp(params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    dt = x.dtype
    if kind == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, params["w_gate"].to(dt))
        u = torch.einsum("bsd,df->bsf", x, params["w_up"].to(dt))
        h = F.silu(g) * u
    else:  # jax.nn.gelu's default is the tanh approximation
        u = torch.einsum("bsd,df->bsf", x, params["w_up"].to(dt))
        h = F.gelu(u, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, params["w_down"].to(dt))


# -- rotary embeddings -------------------------------------------------------


def rope_frequencies(head_dim: int, max_pos: int, theta: float = 1e4, *,
                     device):
    """``(cos, sin)`` tables, float32 ``(max_pos, head_dim / 2)``."""
    inv = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos, sin, positions) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer.

    The split-halves convention: the first and second halves of the head
    dimension are the two coordinates each frequency rotates.
    """
    c = cos[positions][..., None, :]  # (..., seq, 1, hd/2)
    s = sin[positions][..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, dtype=torch.bfloat16, *,
                         device) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (1e4 ** (dim / d))
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    return pe.to(dtype)
