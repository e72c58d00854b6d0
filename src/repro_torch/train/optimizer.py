"""AdamW and the cosine schedule (torch port of ``repro.train.optimizer``).

The moment dtype is configurable (``ModelConfig.adam_dtype``: bfloat16
for the 671B config, float32 elsewhere); the update math is float32
whatever it is, op for op the reference's.  The reference returns new
trees; the port writes the new params and moments into the tensors it
was given (a full-size state is four copies of the params, and a fifth
and sixth would not fit the card) and returns those same trees.

The params may hold layer stacks; the grads may hold the same stacks or,
as the train step gives them, lists of per-layer gradients
(``transformer.layer_trees``): each per-layer gradient then updates its
layer's view of the stacked tensors.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule"]

# Elements updated by one group of ``torch._foreach_*`` calls: bounds the
# float32 temporaries of the update at a few hundred MB.
GROUP_ELEMENTS = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any
    v: Any


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def adamw_init(params, *, dtype=torch.float32) -> AdamWState:
    """Zero moments in ``dtype`` beside every leaf of ``params``, step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)

    dev = next(_leaves(params)).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=_map(zeros, params), v=_map(zeros, params))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _at(tree, i: int):
    """Layer ``i`` of a stack: an item of a list, or views of a stacked
    tree."""
    if isinstance(tree, list):
        return tree[i]
    return _map(lambda a: a[i], tree)


def _aligned(grads, *trees):
    """``(grad, leaf of each tree)`` tuples, walking ``grads``: where it
    holds a list of layers, the other trees' stacks are taken a layer at a
    time."""
    if isinstance(grads, dict):
        for k, g in grads.items():
            yield from _aligned(g, *(t[k] for t in trees))
    elif isinstance(grads, list):
        for i, g in enumerate(grads):
            yield from _aligned(g, *(_at(t, i) for t in trees))
    else:
        yield (grads, *trees)


def _groups(rows):
    group, size = [], 0
    for row in rows:
        group.append(row)
        size += row[0].numel()
        if size >= GROUP_ELEMENTS:
            yield group
            group, size = [], 0
    if group:
        yield group


def _f32(ts):
    return [t.float() for t in ts]


def adamw_update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step with global-norm clipping.  ``lr`` is a number or a
    float32 scalar tensor.  Returns ``(params, state, gnorm)``: the params
    and moments updated in place, the step one higher, and the float32
    global norm of the grads before clipping."""
    rows = list(_aligned(grads, params, state.m, state.v))
    dev = rows[0][1].device
    gsq = torch.stack([torch.sum(torch.square(g.float())) for g, *_ in rows]).sum()
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    sf = step.float()
    c1 = 1.0 - torch.pow(torch.tensor(b1, device=dev), sf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, device=dev), sf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    for group in _groups(rows):
        g_, p_, m_, v_ = (list(col) for col in zip(*group))
        g = torch._foreach_mul(_f32(g_), scale)
        m = torch._foreach_mul(_f32(m_), b1)  # b1 m + (1 - b1) g
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        v = torch._foreach_mul(_f32(v_), b2)  # b2 v + (1 - b2) g g
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
        del g
        denom = torch._foreach_sqrt(torch._foreach_div(v, c2))  # sqrt(vhat) + eps
        torch._foreach_add_(denom, eps)
        delta = torch._foreach_div(torch._foreach_div(m, c1), denom)
        del denom
        p32 = _f32(p_)
        torch._foreach_add_(delta, torch._foreach_mul(p32, weight_decay))
        p_new = torch._foreach_sub(p32, torch._foreach_mul(delta, lr))
        for dst, src in ((p_, p_new), (m_, m), (v_, v)):
            torch._foreach_copy_(dst, src)
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm


def cosine_schedule(step, *, peak_lr, warmup: int, total: int,
                    floor_frac: float = 0.1, device=None) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor_frac``
    of it at ``total``: a float32 scalar tensor (on ``step``'s device, or
    ``device`` for a number)."""
    s = torch.as_tensor(step, device=device).float()
    warm = peak_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
