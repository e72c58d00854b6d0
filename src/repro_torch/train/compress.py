"""int8 block quantisation of gradients (torch port of
``repro.train.compress``).

Gradients are scaled per block of 256 values to int8 with stochastic
rounding (unbiased: the expected quantised value is the input), which is
the payload of the reference's compressed all-reduce.  The random bits
come from an explicit ``torch.Generator``, so they are not JAX's: the
rounding is held to its bounds and its mean, not to the reference's bits.
``compressed_psum`` needs a process group and comes with the port's
distributed layer.
"""

from __future__ import annotations

import torch

__all__ = ["BLOCK", "quantize_int8", "dequantize_int8"]

BLOCK = 256


def _pad_to_block(x: torch.Tensor):
    n = x.numel()
    pad = (-n) % BLOCK
    return torch.cat([x.reshape(-1), x.new_zeros(pad)]), n


def quantize_int8(x: torch.Tensor, gen: torch.Generator):
    """Stochastic-rounding int8 block quantisation: ``(q (nb, BLOCK) int8,
    scales (nb,) float32, original size)``.  ``gen`` lives on ``x``'s
    device."""
    flat, n = _pad_to_block(x.float())
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    y = blocks / scale
    lo = torch.floor(y)
    u = torch.rand(y.shape, generator=gen, device=y.device)
    q = lo + (u < y - lo)  # stochastic round: E[q] == y
    return torch.clamp(q, -127, 127).to(torch.int8), scale[:, 0], n


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, n: int, shape,
                    dtype) -> torch.Tensor:
    x = q.float() * scales[:, None]
    return x.reshape(-1)[:n].reshape(shape).to(dtype)
