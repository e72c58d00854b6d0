"""Profiler spans and the trace dump (torch port of ``repro.obs.trace``).

Three span flavours, all empty contexts while obs is disabled (so the
instrumented code dispatches nothing more on the off path):

* :func:`span` -- a subsystem boundary (``repro.merge_kway``, kernel
  dispatch): ``torch.profiler.record_function``, which groups the
  operations inside it in the profiler's views;
* :func:`host_span` -- a host region (``serve.prefill``, the external
  sort's loop): the same annotation on the host timeline;
* :func:`step_span` -- the launcher loop marker, named ``<name>#<step>``
  as the profiler names its own steps.

Plus the opt-in trace dump (:func:`start_profile` / :func:`stop_profile`,
``--profile-steps`` on the launcher): a ``torch.profiler.profile`` of the
CPU, and of the card when there is one, written as a Chrome trace under
``log_dir``.  The reference's ``attach_hlo_report`` reads XLA's compiled
HLO and has no counterpart here (ROADMAP.md, Queue 1 item 2).
"""

from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.obs.registry import enabled, log_event

__all__ = [
    "span",
    "host_span",
    "step_span",
    "start_profile",
    "stop_profile",
]


@contextlib.contextmanager
def span(name: str):
    """Group the operations inside under ``name`` when enabled."""
    if not enabled():
        yield
        return
    with torch.profiler.record_function(name):
        yield


def host_span(name: str):
    """A named region on the host timeline when enabled (the same
    annotation as :func:`span`: torch's profiler puts both on the host
    timeline, with the device work they launch beneath)."""
    return span(name)


@contextlib.contextmanager
def step_span(name: str, step: int):
    """Per-step profiler marker ``<name>#<step>`` when enabled."""
    if not enabled():
        yield
        return
    with torch.profiler.record_function(f"{name}#{step}"):
        yield


_PROFILER: torch.profiler.profile | None = None


def start_profile(log_dir: str) -> bool:
    """Begin a ``torch.profiler`` trace into ``log_dir`` (idempotent)."""
    global _PROFILER
    if _PROFILER is not None:
        return False
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    _PROFILER = prof
    log_event("obs.profile_started", log_dir=log_dir)
    return True


def stop_profile() -> bool:
    """End the running trace and write it, if there is one."""
    global _PROFILER
    if _PROFILER is None:
        return False
    prof, _PROFILER = _PROFILER, None
    prof.stop()  # on_trace_ready writes <log_dir>/<host>_<pid>.<ms>.pt.trace.json
    log_event("obs.profile_stopped")
    return True
