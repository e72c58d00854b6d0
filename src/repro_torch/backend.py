"""The port's merge-backend policy: which implementation an entry point runs.

``backend=None`` resolves through ``REPRO_TORCH_MERGE_BACKEND`` (``cuda``,
``torch``, ``torch_native`` or ``auto``); ``auto`` picks ``cuda`` for CUDA
tensors and ``torch`` for CPU tensors.  A bad name raises, and ``cuda``
with a CPU tensor raises: there is no silent fallback.  The kernel entry
points (``repro_torch.kernels.ops``) and the core's grouped merge
(``repro_torch.core.mergesort.merge_runs_ranked``) both dispatch here.
"""

from __future__ import annotations

import os

import torch

from repro_torch import obs

__all__ = [
    "BACKEND_ENV_VAR",
    "VALID_BACKENDS",
    "default_backend",
    "announce",
    "dispatch",
]

BACKEND_ENV_VAR = "REPRO_TORCH_MERGE_BACKEND"
VALID_BACKENDS = ("cuda", "torch", "torch_native")

# (op, backend, source) triples already announced — the dispatch choice is
# logged once per distinct selection, not once per call.
_LOGGED_CHOICES: set = set()


def default_backend(device: torch.device | str = "cpu") -> str:
    """``cuda`` for CUDA tensors, ``torch`` elsewhere;
    ``REPRO_TORCH_MERGE_BACKEND`` overrides."""
    env = os.environ.get(BACKEND_ENV_VAR, "auto").strip().lower()
    if env in VALID_BACKENDS:
        return env
    if env not in ("", "auto"):
        raise ValueError(
            f"{BACKEND_ENV_VAR} must be 'cuda', 'torch', 'torch_native' or "
            f"'auto', got {env!r}"
        )
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def announce(op: str, backend: str, source: str, device) -> None:
    """Log ``kernels.backend_selected`` once per distinct ``(op, backend,
    source)``: ``source`` is ``arg``, ``env`` or ``auto`` for the policy's
    choice, ``shape`` where a call's shape sends it past the kernel."""
    key = (op, backend, source)
    if key not in _LOGGED_CHOICES:
        _LOGGED_CHOICES.add(key)
        obs.log_event(
            "kernels.backend_selected", op=op, backend=backend,
            source=source, device=str(device),
        )


def dispatch(op: str, backend: str | None, *tensors) -> str:
    """Resolve and validate the backend for ``tensors``; announce it once.

    An explicit ``backend=`` typo fails loudly; ``cuda`` on a tensor that
    is not on the card fails too (the counterpart of the reference's
    ``_resolve_interpret``, which refuses compiled Pallas off the TPU).
    """
    device = tensors[0].device
    if backend is None:
        resolved = default_backend(device)
        env = os.environ.get(BACKEND_ENV_VAR, "").strip().lower()
        source = "env" if env in VALID_BACKENDS else "auto"
    else:
        if backend not in VALID_BACKENDS:
            raise ValueError(
                f"{op}: backend must be one of {VALID_BACKENDS}, "
                f"got {backend!r}"
            )
        resolved = backend
        source = "arg"
    if resolved == "cuda":
        for t in tensors:
            if t is not None and t.device.type != "cuda":
                raise ValueError(
                    f"{op}: backend 'cuda' needs CUDA tensors, got one on "
                    f"{t.device} — move it to the card or use backend='torch'"
                )
    announce(op, resolved, source, device)
    if obs.enabled():
        obs.counter("kernels.dispatch_calls", 1, op=op, backend=resolved)
    return resolved
