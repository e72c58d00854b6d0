"""The profiled slice: a ``torch.profiler`` trace (CPU and CUDA activity)
of a run of steady steps, reduced to what the per-layer readers need.

Device operations are the trace's kernels, copies and sets on the device.
Each is tied to the host call that launched it by its correlation id, so
it falls in the harness's span (``portbench.decode``,
``portbench.sample``) whose host interval holds that launch.  The slice's
length is the device's, from the first operation's start to the last
one's end; its busy time is the union of the operations' intervals.  An
idle gap is named by what the host was doing when it launched the
operation that ends the gap: the harness span and the outermost operator
around the launch.

Every other annotation on the host (the program's own spans, such as
``moe.dispatch`` or ``serve.decode``, and its step markers) is kept apart,
as named host intervals (``Slice.program_spans``), for readers of a
model layer's host time, or of the device time of the operations launched
inside (``Slice.launched_in``); it names no operation and no gap.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

from portbench.stats import union_length

SPAN_PREFIX = "portbench."
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 120


@dataclasses.dataclass
class Op:
    name: str
    kind: str
    start: int  # ns
    end: int
    span: str  # the harness span its launch fell in ("" outside any)
    launched_by: str  # outermost host operator around the launch
    launch: int | None = None  # ns on the host of its launch, where known


@dataclasses.dataclass
class Slice:
    steps: int
    ops: list
    span_s: float
    busy_s: float
    idle_gaps: list  # [(name, seconds)], largest first
    # the program's annotations: name -> [(start, end)] ns on the host
    program_spans: dict = dataclasses.field(default_factory=dict)

    @property
    def kernels(self) -> list:
        return [o for o in self.ops if o.kind == "kernel"]

    def in_span(self, span: str) -> list:
        return [o for o in self.ops if o.span == span]

    def program_s(self, name: str) -> float | None:
        """Seconds of the host inside the program's spans ``name`` (the
        union: a span nested in one of the same name counts once);
        ``None`` where the slice has none."""
        spans = self.program_spans.get(name)
        return None if not spans else union_length(spans) * 1e-9

    def launched_in(self, name: str) -> list | None:
        """The operations launched while one of the program's spans
        ``name`` was open on the host; ``None`` where the slice has none."""
        spans = self.program_spans.get(name)
        if not spans:
            return None
        inside = _Intervals([(s, e, name) for s, e in spans])
        return [o for o in self.ops if o.launch is not None and inside.at(o.launch)]

    def device_ops(self, top: int = 10) -> list:
        total = defaultdict(float)
        for o in self.ops:
            total[o.name[:NAME_CHARS]] += (o.end - o.start) * 1e-9
        return sorted(total.items(), key=lambda kv: -kv[1])[:top]


class _Intervals:
    """Host intervals, sorted, for 'which one holds time t' queries; the
    outermost (earliest-starting) holder wins."""

    def __init__(self, items):
        top, end = [], -1
        for s, e, name in sorted(items):
            if s >= end:  # not inside the previous outermost one
                top.append((s, e, name))
                end = e
        self.starts = [s for s, _, _ in top]
        self.items = top

    def at(self, t: int) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.items[i][0] <= t <= self.items[i][1]:
            return self.items[i][2]
        return ""


def _kind(e) -> str:
    """The kineto activity of an event: its ``activity_type()`` where the
    torch build has it, else from the device, the annotation flag and the
    name (CUDA runtime and driver calls are ``cuda*``/``cu*`` without a
    namespace; device copies and sets are ``Memcpy``/``Memset``)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    annotation = e.is_user_annotation()
    if str(e.device_type()).endswith("CUDA"):
        if annotation:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if annotation:
        return "user_annotation"
    if name.startswith("cu") and "::" not in name:
        return "cuda_runtime"
    return "cpu_op"


def device_busy_ns(events) -> int:
    """Nanoseconds in which an operation ran on the device: the union of
    the intervals of the kernels, copies and sets among kineto
    ``events``."""
    return int(union_length([(e.start_ns(), e.end_ns()) for e in events
                             if _kind(e) in DEVICE_KINDS]))


def read(events, steps: int) -> Slice | None:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``) of
    ``steps`` profiled steps; ``None`` when the device ran nothing."""
    launches, spans, cpu_ops, device = {}, [], [], []
    program = defaultdict(list)
    for e in events:
        kind = _kind(e)
        if kind in DEVICE_KINDS:
            device.append((kind, e))
        elif kind in LAUNCH_KINDS:
            launches[e.correlation_id()] = e.start_ns()
        elif kind == "user_annotation":
            name, t = e.name(), (e.start_ns(), e.end_ns())
            if name.startswith(SPAN_PREFIX):
                spans.append((*t, name[len(SPAN_PREFIX):]))
            else:
                program[name].append(t)
        elif kind == "cpu_op":
            cpu_ops.append((e.start_ns(), e.end_ns(), e.name()))
    if not device:
        return None
    span_at, op_at = _Intervals(spans), _Intervals(cpu_ops)
    ops = []
    for kind, e in device:
        t = launches.get(e.correlation_id())
        if t is None:
            t = launches.get(e.linked_correlation_id())
        ops.append(Op(e.name(), kind, e.start_ns(), e.end_ns(),
                      span_at.at(t) if t is not None else "",
                      op_at.at(t) if t is not None else "", t))
    ops.sort(key=lambda o: o.start)
    first, last = ops[0].start, max(o.end for o in ops)
    busy = union_length([(o.start, o.end) for o in ops])
    gaps = defaultdict(float)
    reach = ops[0].end
    for o in ops[1:]:
        if o.start > reach:
            gaps[f"{o.span or 'other'}:{o.launched_by or 'launch'}"[:NAME_CHARS]] += (
                o.start - reach) * 1e-9
        reach = max(reach, o.end)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return Slice(steps=steps, ops=ops, span_s=(last - first) * 1e-9,
                 busy_s=busy * 1e-9, idle_gaps=idle,
                 program_spans=dict(program))
