"""FLOPs a Mamba2 language model needs for one token fed at a position,
from the configuration's widths: every product with a weight (2 per
multiply-add), the conv, the state update and read-out of the scan, and
the logits.  The position does not matter: the state has a fixed size."""

from __future__ import annotations


def per_token(spec: dict, position: int) -> float:
    a = spec["assumed"]
    d = spec["d_model"]
    d_inner = a["expand"] * d
    n, g, hd = a["d_state"], a["ngroups"], a["headdim"]
    nh = d_inner // hd
    conv_dim = d_inner + 2 * g * n
    proj = 2 * d_inner + 2 * g * n + nh
    pad = spec["pad_vocab_size_multiple"]
    vocab = -(-spec["vocab_size"] // pad) * pad
    layer = (2 * d * proj                 # input projection
             + 2 * a["d_conv"] * conv_dim  # depthwise conv
             + 4 * nh * hd * n            # state: decay, then dt x B^T added
             + 2 * nh * hd * n            # y = S C
             + 2 * d_inner * d)           # output projection
    return spec["n_layer"] * layer + 2 * d * vocab
