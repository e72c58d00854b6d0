"""Plain float32 Mamba2 language model (arXiv:2405.21060, the Mamba2 layer
of ``mamba_ssm`` with ``ngroups`` B/C groups), token by token over whole
sequences.

Per layer: ``h = RMSNorm(x)``; ``[z, xBC, dt] = h W_in``; ``xBC`` through
a causal depthwise conv of width ``d_conv`` with bias, then SiLU, split
into ``x, B, C``; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``;
the state ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T`` and
``y_t = S_t C_t + D x_t`` per head; ``y = RMSNorm(y * SiLU(z)) *
norm_scale`` (the gate before the norm); ``x += y W_out``.  The logits
are ``RMSNorm(x) E^T`` with the tied embedding ``E``.  The input
projection's order is the port's ``[x, z, B, C, dt]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import Precision, rmsnorm


def logits(spec: dict, w: dict, tokens: torch.Tensor, positions,
           prec: Precision) -> torch.Tensor:
    """``tokens`` (rows, seq) -> float32 logits (rows, len(positions),
    vocab rows) at the given positions."""
    a = spec["assumed"]
    eps = spec["norm_epsilon"]
    d = spec["d_model"]
    d_inner = a["expand"] * d
    hd, n, g = a["headdim"], a["d_state"], a["ngroups"]
    nh = d_inner // hd
    gs = g * n
    rows, seq = tokens.shape
    table = w["embed"]["table"]
    x = table[tokens].float()
    lw = w["layers"]
    for i in range(spec["n_layer"]):
        m = {k: v[i] for k, v in lw["mamba"].items()}
        h = rmsnorm(x, lw["ln"]["scale"][i], eps)
        proj = prec.einsum("bsd,de->bse", h, m["w_in"])
        xs, z = proj[..., :d_inner], proj[..., d_inner:2 * d_inner]
        bc = proj[..., 2 * d_inner:2 * d_inner + 2 * gs]
        dt = proj[..., 2 * d_inner + 2 * gs:]
        conv_in = torch.cat([xs, bc], dim=-1)
        k = m["conv_w"].shape[0]
        padded = F.pad(conv_in, (0, 0, k - 1, 0))
        conv = sum(padded[:, j:j + seq] * m["conv_w"][j].float() for j in range(k))
        conv = F.silu(conv + m["conv_b"].float())
        xs = conv[..., :d_inner].reshape(rows, seq, nh, hd)
        bmat = conv[..., d_inner:d_inner + gs].reshape(rows, seq, g, n)
        cmat = conv[..., d_inner + gs:].reshape(rows, seq, g, n)
        bmat = bmat.repeat_interleave(nh // g, dim=2)  # (rows, seq, nh, n)
        cmat = cmat.repeat_interleave(nh // g, dim=2)
        dt = F.softplus(dt + m["dt_bias"].float())  # (rows, seq, nh)
        a_neg = -torch.exp(m["A_log"].float())
        decay = torch.exp(dt * a_neg)
        state = torch.zeros((rows, nh, hd, n), device=x.device)
        ys = []
        for t in range(seq):
            state = (state * decay[:, t, :, None, None]
                     + (dt[:, t, :, None] * xs[:, t])[..., None]
                     * bmat[:, t, :, None, :])
            ys.append(torch.einsum("bhpn,bhn->bhp", state, cmat[:, t]))
        y = torch.stack(ys, dim=1) + m["D"].float()[:, None] * xs
        y = y.reshape(rows, seq, d_inner) * F.silu(z)
        y = rmsnorm(y, m["norm_scale"], eps)
        x = x + prec.einsum("bse,ed->bsd", y, m["w_out"])
    h = rmsnorm(x[:, positions], w["final_norm"]["scale"], eps)
    return prec.einsum("bsd,vd->bsv", h, table)
