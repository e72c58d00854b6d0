"""Telemetry surface of the port: a no-op shim.

The port's instrumented sites call the same record points as
``repro.obs`` (``enabled``, ``counter``, ``gauge``, ``histogram``,
``log_event``, ``span``, ``host_span``).  Until the full telemetry layer
is ported, telemetry is always disabled: every record point does nothing
and every span is an empty context manager, so instrumented code adds no
work on the device.
"""

from __future__ import annotations

import contextlib

__all__ = [
    "enabled",
    "counter",
    "gauge",
    "histogram",
    "log_event",
    "span",
    "host_span",
]


def enabled() -> bool:
    """Telemetry is off: callers skip computing what they would record."""
    return False


def counter(metric: str, value=1, **labels) -> None:
    """Record point for a monotone count (no-op)."""


def gauge(metric: str, value, **labels) -> None:
    """Record point for a current value (no-op)."""


def histogram(metric: str, values, **labels) -> None:
    """Record point for a distribution summary (no-op)."""


def log_event(metric: str, **labels) -> None:
    """Record point for a one-off event (no-op)."""


def span(name: str):
    """Device-side subsystem span (empty context)."""
    return contextlib.nullcontext()


def host_span(name: str):
    """Host-side wall-clock span (empty context)."""
    return contextlib.nullcontext()
