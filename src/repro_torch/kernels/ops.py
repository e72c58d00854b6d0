"""Public kernel entry points: dispatch the CUDA kernels vs torch ops.

Port of ``repro.kernels.ops``.  Backends:

* ``cuda`` — the hand-written Hopper kernels (``repro_torch.kernels.merge``);
  the inputs must be CUDA tensors, or the call raises.
* ``torch`` — the rank merges in torch ops (``merge_ref``,
  ``merge_kway_ranked``, ``merge_sort``), the counterpart of ``xla``.
* ``torch_native`` — as ``torch``, except that ``stable_sort`` is
  ``torch.sort(stable=True)``, the counterpart of ``xla_native``.

``backend=None`` resolves through ``REPRO_TORCH_MERGE_BACKEND`` (one of the
three names, or ``auto``); ``auto`` picks ``cuda`` for CUDA tensors and
``torch`` for CPU tensors (the policy lives in ``repro_torch.backend``).  The port reads its own variable, not
``REPRO_MERGE_BACKEND``, so one process can drive both packages.  A bad
name raises, and asking for ``cuda`` with a CPU tensor raises: there is no
silent fallback.

The out-of-core path (``repro_torch.external``) merges every output window
through :func:`merge_window`, under the same policy.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.backend import (
    BACKEND_ENV_VAR,
    VALID_BACKENDS,
    default_backend,
    dispatch,
)
from repro_torch.core.kway import merge_kway_ranked
from repro_torch.core.mergesort import merge_sort
from repro_torch.kernels import ref
from repro_torch.kernels.merge import merge_kway_tiled, merge_tiled

__all__ = [
    "stable_merge",
    "stable_merge_kway",
    "merge_window",
    "stable_sort",
    "default_backend",
    "BACKEND_ENV_VAR",
    "VALID_BACKENDS",
]


def stable_merge(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    backend: str | None = None,
) -> torch.Tensor:
    """Stable merge of two ordered 1-D tensors.

    backend: 'cuda' (the ``merge_tile`` kernel), 'torch' / 'torch_native'
    (rank merge via ``searchsorted``), or None = auto.
    """
    backend = dispatch("stable_merge", backend, a, b)
    with obs.span("repro.stable_merge"):
        if backend == "cuda":
            return merge_tiled(a, b)
        return ref.merge_ref(a, b)


def stable_merge_kway(
    runs: torch.Tensor,
    *,
    backend: str | None = None,
) -> torch.Tensor:
    """Stable merge of ``k`` sorted runs (``(k, w)``, rows ascending).

    backend: 'cuda' (the one-pass ``merge_kway_tile`` kernel) or 'torch' /
    'torch_native' (the k-way rank merge), None = auto.
    """
    backend = dispatch("stable_merge_kway", backend, runs)
    with obs.span("repro.stable_merge_kway"):
        if backend == "cuda":
            return merge_kway_tiled(runs)
        return merge_kway_ranked(runs)


def merge_window(
    runs: torch.Tensor,
    vals: torch.Tensor | None = None,
    lengths: torch.Tensor | None = None,
    *,
    out_len: int | None = None,
    backend: str | None = None,
):
    """Stable ragged k-way merge of one external-sort output window.

    ``runs``: ``(k, w)`` sentinel-padded sorted rows; ``lengths``: real row
    lengths; ``vals``: optional payload carried through the permutation.
    Returns the first ``out_len`` merged elements (``k*w`` when unset);
    with ``lengths``, positions ``>= lengths.sum()`` are backend-dependent
    filler — callers slice to the real count.
    """
    backend = dispatch("merge_window", backend, runs, vals, lengths)
    k, w = runs.shape
    total = k * w if out_len is None else out_len
    with obs.span("repro.merge_window"):
        if backend == "cuda":
            return merge_kway_tiled(runs, vals, lengths=lengths, out_len=total)
        return merge_kway_ranked(runs, vals, lengths, out_len=total)


def stable_sort(x: torch.Tensor, *, backend: str | None = None) -> torch.Tensor:
    """Stable 1-D sort: merge sort on the co-rank primitive (torch ops on
    every backend but ``torch_native``, which is ``torch.sort``)."""
    backend = dispatch("stable_sort", backend, x)
    with obs.span("repro.stable_sort"):
        if backend == "torch_native":
            return torch.sort(x, stable=True).values
        return merge_sort(x)
