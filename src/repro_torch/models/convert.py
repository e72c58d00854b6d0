"""Carry weights over from the reference package (``repro``) to the port.

The reference's params are a pytree of arrays; the caller turns it into
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``), and
:func:`params_from_numpy` makes the port's tree of tensors from that,
leaf for leaf, on a given device.  It takes numpy arrays only, never an
object of JAX.  The tree's layout is the same in both packages (layers
stacked on a leading axis), so nothing is reshaped.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a: np.ndarray, device="cuda") -> torch.Tensor:
    """A copy of ``a`` as a tensor on ``device`` (the card unless the caller
    passes ``"cpu"``); bfloat16 arrays (numpy's ``ml_dtypes`` extension
    type) keep their bits."""
    if not isinstance(a, np.ndarray):
        raise TypeError(f"expected a numpy array, got {type(a).__name__}")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device="cuda"):
    """Nested dicts of numpy arrays -> the same nested dicts of tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
