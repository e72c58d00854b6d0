"""Metrics registry: record points that cost nothing when off (torch port
of ``repro.obs.registry``).

Every record point checks :func:`enabled` first and returns before it
touches its arguments, so a disabled point dispatches no tensor operation
(``tests/test_torch_obs.py`` counts them).  When enabled, a point never
waits for the device either: it snapshots its tensor value and tensor
labels on their own device (``detach().clone()``, queued behind the work
that produces them) into an ordered pending list, and :func:`flush` copies
every snapshot to the host at once, emits the records in call order and
flushes the sink.  This is the reference's deferral (``jax.debug.callback``
drained by ``effects_barrier`` at flush) on eager tensors.  A snapshot is
taken at record time, so an in-place update after the call (the decode
steps update caches and lengths in place) does not change the record.

Values take JAX's default 32-bit float type (a Python or float64 value is
recorded as the float32 the reference's ``jnp.asarray`` makes of it), so
the records equal the reference's for the same calls, ``ts`` aside.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time

import numpy as np
import torch

__all__ = [
    "enable",
    "disable",
    "enabled",
    "capture",
    "record",
    "counter",
    "gauge",
    "histogram",
    "log_event",
    "set_step",
    "flush",
    "totals",
]

_log = logging.getLogger("repro_torch.obs")

# Arrays longer than this are summarised instead of stored verbatim; the
# per-peer vectors the hot paths emit (p, k, E <= a few hundred) stay exact.
_MAX_VERBATIM = 1024


@dataclasses.dataclass
class _Pending:
    """One record point's call, its tensors snapshotted on their device."""

    ts: float
    name: str
    kind: str
    step: int | None
    value: object  # a tensor or numpy snapshot; None for an event
    labels: dict  # host values as given, tensors snapshotted


@dataclasses.dataclass
class _ObsState:
    enabled: bool = False
    sink: object | None = None
    step: int | None = None
    pending: list = dataclasses.field(default_factory=list)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


_STATE = _ObsState()


def enabled() -> bool:
    """The switch every record point checks first."""
    return _STATE.enabled


def enable(metrics_dir: str | None = None, sink=None) -> None:
    """Turn metric emission on.

    ``metrics_dir`` opens a :class:`repro_torch.obs.sink.JsonlSink` there;
    ``sink`` passes an explicit sink (tests).  Exactly one must be given.
    Records still pending go to the sink that was active when they were
    made.
    """
    from repro_torch.obs.sink import JsonlSink

    if (metrics_dir is None) == (sink is None):
        raise ValueError("enable() needs exactly one of metrics_dir / sink")
    if sink is None:
        sink = JsonlSink(metrics_dir)
    _drain()
    with _STATE.lock:
        old = _STATE.sink
        _STATE.sink = sink
        _STATE.enabled = True
    if old is not None and old is not sink:
        old.close()


def disable() -> None:
    """Emit what is pending, turn emission off and close the sink."""
    _drain()
    with _STATE.lock:
        old, _STATE.sink = _STATE.sink, None
        _STATE.enabled = False
        _STATE.step = None
    if old is not None:
        old.close()


@contextlib.contextmanager
def capture():
    """Collect records in memory for the duration of a ``with`` block.

    Yields the live ``list`` of record dicts.  If obs was already
    enabled, the previous sink is restored (not closed) on exit;
    otherwise this is a scoped enable/disable.
    """
    from repro_torch.obs.sink import ListSink

    sink = ListSink()
    if not _STATE.enabled:
        enable(sink=sink)
        try:
            yield sink.records
        finally:
            disable()
        return
    _drain()
    with _STATE.lock:
        prev, _STATE.sink = _STATE.sink, sink
    try:
        yield sink.records
    finally:
        _drain()
        with _STATE.lock:
            _STATE.sink = prev


def set_step(step: int | None) -> None:
    """Host-side step label stamped on subsequent records."""
    _STATE.step = None if step is None else int(step)


def flush() -> None:
    """Copy the pending snapshots to the host, emit them and drain the
    sink's buffer (launchers call this once a step)."""
    _drain()
    sink = _STATE.sink
    if sink is not None:
        sink.flush()


def totals() -> dict[str, float]:
    """Running counter totals of the records flushed to the active sink."""
    sink = _STATE.sink
    return dict(sink.totals) if sink is not None else {}


# ---------------------------------------------------------------------------
# record points
# ---------------------------------------------------------------------------


def _snapshot(v):
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    return np.array(v)


def record(name: str, value, *, kind: str = "gauge", **labels) -> None:
    """The one record point: nothing when disabled, a snapshot when
    enabled.

    ``value`` may be a tensor (on any device), a numpy array or a Python
    scalar or list.  ``labels`` are attached to the record: plain Python
    values as they are, tensors snapshotted like the value (e.g. a
    per-device index computed on the card).
    """
    if not _STATE.enabled:
        return
    snap = {k: _snapshot(v) if isinstance(v, torch.Tensor) else v
            for k, v in labels.items()}
    item = _Pending(time.time(), name, kind, _STATE.step, _snapshot(value),
                    snap)
    with _STATE.lock:
        _STATE.pending.append(item)


def counter(name: str, inc=1, **labels) -> None:
    """Monotonic increment event (sinks accumulate ``totals[name]``)."""
    record(name, inc, kind="counter", **labels)


def gauge(name: str, value, **labels) -> None:
    """Point-in-time value; arrays are stored verbatim (<= 1024 elems)."""
    record(name, value, kind="gauge", **labels)


def histogram(name: str, values, **labels) -> None:
    """Distribution summary: count/min/p50/p90/max/sum of ``values``."""
    record(name, values, kind="histogram", **labels)


def log_event(name: str, **fields) -> None:
    """Host-side event: config choices, reports.

    Always logged through ``logging.getLogger('repro_torch.obs')``; also
    queued for the sink when metrics are enabled (in call order with the
    other records).
    """
    fields = {k: _normalise(v) for k, v in fields.items()}
    _log.info("%s %s", name, fields)
    if _STATE.enabled:
        item = _Pending(time.time(), name, "event", _STATE.step, None, fields)
        with _STATE.lock:
            _STATE.pending.append(item)


# ---------------------------------------------------------------------------
# host-side normalisation + emission
# ---------------------------------------------------------------------------


def _normalise(v):
    """numpy scalar/array -> plain Python (JSON-serialisable)."""
    if isinstance(v, np.ndarray):
        if v.ndim == 0:
            return v.item()
        return v.tolist()
    if isinstance(v, (np.generic,)):
        return v.item()
    return v


def _summary(arr: np.ndarray) -> dict:
    flat = arr.astype(np.float64).reshape(-1)
    return {
        "count": int(flat.size),
        "min": float(flat.min()),
        "p50": float(np.percentile(flat, 50)),
        "p90": float(np.percentile(flat, 90)),
        "max": float(flat.max()),
        "sum": float(flat.sum()),
    }


def _to_numpy(v) -> np.ndarray:
    """A host tensor or numpy snapshot as numpy, floats as JAX's default
    float32 (bfloat16 widened to it exactly)."""
    if isinstance(v, torch.Tensor):
        if v.dtype in (torch.bfloat16, torch.float64):
            v = v.float()
        return v.numpy()
    return v.astype(np.float32) if v.dtype == np.float64 else v


def _drain() -> None:
    """Emit every pending record into the active sink, in call order, after
    one batch of device-to-host copies."""
    with _STATE.lock:
        pending, _STATE.pending = _STATE.pending, []
    if not pending:
        return
    tensors = [t for p in pending for t in (p.value, *p.labels.values())
               if isinstance(t, torch.Tensor) and t.device.type != "cpu"]
    host = {id(t): t.to("cpu", non_blocking=True) for t in tensors}
    for device in {t.device for t in tensors}:
        torch.cuda.synchronize(device)

    def on_host(t):
        return host.get(id(t), t)

    for p in pending:
        labels = {k: v for k, v in p.labels.items()
                  if not isinstance(v, torch.Tensor)}
        labels.update({k: _normalise(_to_numpy(on_host(v)))
                       for k, v in p.labels.items()
                       if isinstance(v, torch.Tensor)})
        value = None if p.value is None else _to_numpy(on_host(p.value))
        _emit(p, value, labels)


def _emit(p: _Pending, value, labels: dict) -> None:
    rec: dict = {"ts": p.ts, "metric": p.name, "kind": p.kind}
    if p.step is not None:
        rec["step"] = p.step
    if value is not None:
        if p.kind == "histogram":
            rec.update(_summary(value))
        elif value.ndim > 0 and value.size > _MAX_VERBATIM:
            rec.update(_summary(value))
            rec["truncated"] = True
        else:
            rec["value"] = _normalise(value)
    if labels:
        rec["labels"] = labels
    sink = _STATE.sink
    if sink is not None:
        sink.write(rec)
