"""Profiler spans and the trace dump (torch port of ``repro.obs.trace``).

Three span flavours, each a ``torch.profiler.record_function`` while a
profiler records (``torch.autograd.profiler._is_profiler_enabled``, the
profiler's own on-flag) and one shared null context otherwise, whether
obs is on or off.  So a span lands in the same kineto trace as the device
operations, on one clock, and a device operation's launch falls inside
the span that was open when it was launched; with no profiler a span
makes no generator, no annotation and no tensor operation:

* :func:`span` -- a layer or subsystem boundary (``serve.decode``,
  ``model.ssm``, ``moe.dispatch``, ``repro.merge_kway``);
* :func:`host_span` -- a host region (``serve.prefill``, the external
  sort's loop): the same annotation on the host timeline;
* :func:`step_span` -- the launcher loop marker, named ``<name>#<step>``
  as the profiler names its own steps.

The metric record points keep ``obs.enabled()`` as their switch; a span
does not read it.

Plus the opt-in trace dump (:func:`start_profile` / :func:`stop_profile`,
``--profile-steps`` on the launcher): a ``torch.profiler.profile`` of the
CPU, and of the card when there is one, written as a Chrome trace under
``log_dir``, spans included.  :func:`attach_hlo_report` logs the
collective traffic of a traced step (the reference reads it from XLA's
compiled HLO; the port counts it with ``launch.hlo_stats.TraceStats``).
"""

from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.obs.registry import log_event

__all__ = [
    "span",
    "host_span",
    "step_span",
    "start_profile",
    "stop_profile",
    "attach_hlo_report",
]


_NULL = contextlib.nullcontext()
_profiler = torch.autograd.profiler  # its on-flag is read at each call


def span(name: str):
    """Group the operations inside under ``name`` while a profiler
    records."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(name)


def host_span(name: str):
    """A named region on the host timeline while a profiler records (the
    same annotation as :func:`span`: torch's profiler puts both on the
    host timeline, with the device work they launch beneath)."""
    return span(name)


def step_span(name: str, step: int):
    """Per-step profiler marker ``<name>#<step>`` while a profiler
    records."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(f"{name}#{step}")


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


def attach_hlo_report(name: str, stats_or_fn, **labels) -> dict | None:
    """Log the predicted collective traffic of an entry point.

    ``stats_or_fn`` is a :class:`~repro_torch.launch.hlo_stats.TraceStats`
    that counted a step, or a callable of no arguments that runs one (it
    is traced under a fresh ``TraceStats``).  Returns ``{total_bytes,
    per_op_bytes, op_counts}`` and emits it as an ``hlo.collectives``
    event, so runtime per-peer byte counters can be reconciled against
    the prediction.

    A report must never kill the launcher that asked for it: any failure
    is logged as an ``hlo.report_failed`` event carrying the exception
    type, and ``None`` is returned.
    """
    from repro_torch.launch.hlo_stats import TraceStats, trace_stats

    try:
        stats = stats_or_fn
        if not isinstance(stats, TraceStats):
            _, stats = trace_stats(stats_or_fn)
        coll = stats.collective_bytes()
    except Exception as e:  # a report is best-effort by contract
        log_event("hlo.report_failed", entry=name,
                  error_type=type(e).__name__, error=repr(e), **labels)
        return None
    log_event("hlo.collectives", entry=name, total_bytes=coll["total_bytes"],
              per_op_bytes=coll["per_op_bytes"], op_counts=coll["op_counts"],
              **labels)
    return coll
