"""The train step: gradient accumulation, mixed precision, AdamW (torch
port of ``repro.train.train_step``).

``build_train_step(cfg)`` returns ``train_step(params, opt_state, batch,
step) -> (params, opt_state, metrics)``.  Gradients are taken with
respect to per-layer views of the stored params (``layer_trees``), so
each layer's gradient is its own tensor and no stacked gradient is ever
assembled; AdamW then updates each layer's views of the stacks in place.
With ``cfg.grad_accum`` > 1 the batch is cut into that many microbatches
along dim 0, and the loss and gradients are accumulated in float32 and
divided by the count, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import constrain_batch_leading
from repro_torch.models.transformer import layer_trees, train_loss
from repro_torch.train.optimizer import _leaves, adamw_update, cosine_schedule

__all__ = ["build_train_step", "loss_and_grads"]


def _leaf_views(tree, out: list):
    """``tree`` with every leaf replaced by a detached view that requires
    a gradient, each appended to ``out``."""
    if isinstance(tree, dict):
        return {k: _leaf_views(v, out) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_views(v, out) for v in tree]
    view = tree.detach().requires_grad_(True)
    out.append(view)
    return view


def _rebuild(tree, values):
    """``tree``'s structure with its leaves taken, in order, from the
    iterator ``values``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, values) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, values) for v in tree]
    return next(values)


def loss_and_grads(cfg: ModelConfig, params, batch):
    """``(loss, grads)``: the float32 training loss of ``batch`` and its
    gradient, a tree like ``params`` whose layer stacks are lists of
    per-layer gradients (``layer_trees``' layout), each in its param's
    dtype."""
    split = dict(params)
    for name in ("dense_layers", "layers"):
        if name in split:
            split[name] = layer_trees(split[name])
    leaves: list = []
    tree = _leaf_views(split, leaves)
    loss = train_loss(cfg, tree, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _rebuild(tree, iter(grads))


def build_train_step(cfg: ModelConfig, *, total_steps: int = 10_000,
                     warmup: int = 200):
    accum = max(cfg.grad_accum, 1)

    def train_step(params, opt_state, batch, step):
        if accum == 1:
            loss, grads = loss_and_grads(cfg, params, batch)
        else:
            def micro(x, i):
                mb = x.shape[0] // accum
                # on a mesh, the rows over the batch axes that divide them
                return constrain_batch_leading(x[i * mb:(i + 1) * mb])

            loss, grads = 0.0, None
            for i in range(accum):
                l, g = loss_and_grads(
                    cfg, params, {k: micro(v, i) for k, v in batch.items()})
                g32 = [x.float() for x in _leaves(g)]
                if grads is None:  # the reference's zeros + g, exactly
                    grads = _rebuild(g, iter(g32))
                else:
                    torch._foreach_add_(list(_leaves(grads)), g32)
                loss = loss + l
            loss = loss / accum
            torch._foreach_div_(list(_leaves(grads)), accum)
        lr = cosine_schedule(step, peak_lr=cfg.learning_rate, warmup=warmup,
                             total=total_steps, device=opt_state.step.device)
        params, opt_state, gnorm = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=cfg.weight_decay)
        return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return train_step
