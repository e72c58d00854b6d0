"""Plain float32 building blocks of the references, and the control's
lower precision.

Every product with a weight goes through :class:`Precision`: ``fp32``
casts both sides to float32 (the reference, TF32 off); ``fp8`` rounds both
sides to float8 e4m3 with one scale per tensor (weights) or per row
(activations), then multiplies in float32 (the control: the step from the
bfloat16 the configurations state down to fp8).  Nothing here imports the
program.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def float32_only() -> None:
    """Full float32 products: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor, dims) -> torch.Tensor:
    t = t.float()
    amax = t.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def act(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return _fp8(x, -1) if self.name == "fp8" else x

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _fp8(w, tuple(range(w.dim()))) if self.name == "fp8" else w

    def einsum(self, eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``einsum(eq, x, w)`` of an activation and a weight."""
        return torch.einsum(eq, self.act(x), self.weight(w))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` (rows, seq, [heads,] dim) at positions
    0..seq-1: the first and second halves of ``dim`` are the two
    coordinates each frequency ``theta^(-2i/dim)`` rotates."""
    seq, dim = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                       device=x.device) / dim)
    ang = torch.arange(seq, dtype=torch.float64, device=x.device)[:, None] * inv
    shape = (1, seq) + (1,) * (x.dim() - 3) + (dim // 2,)
    cos = torch.cos(ang).float().reshape(shape)
    sin = torch.sin(ang).float().reshape(shape)
    x1, x2 = x[..., :dim // 2], x[..., dim // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
