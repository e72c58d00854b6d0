"""int8 block quantisation of gradients (torch port of
``repro.train.compress``).

Gradients are scaled per block of 256 values to int8 with stochastic
rounding (unbiased: the expected quantised value is the input), which is
the payload of the reference's compressed all-reduce.  The random bits
come from an explicit ``torch.Generator``, so they are not JAX's: the
rounding is held to its bounds and its mean, not to the reference's bits.
``compressed_psum`` is the all-reduce of that payload over a
``torch.distributed`` process group.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import _collectives as C

__all__ = ["BLOCK", "quantize_int8", "dequantize_int8", "compressed_psum"]

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


def compressed_psum(x: torch.Tensor, group, gen: torch.Generator) -> torch.Tensor:
    """Sum of every rank's ``x`` over ``group`` with an int8 payload:
    quantise, reduce as int32, dequantise.

    The block scales are reduced with a max (a conservative shared scale,
    ``nb`` float32 a rank) so that the int8 sum is well defined; each rank
    requantises its blocks to the shared scale before the sum.
    """
    q, scales, n = quantize_int8(x, gen)
    smax = C.pmax(scales, group)
    requant = torch.clamp(torch.round(q.float() * (scales / smax)[:, None]),
                          -127, 127).to(torch.int8)
    total = C.psum(requant.to(torch.int32), group)
    return dequantize_int8(total, smax, n, x.shape, x.dtype)
