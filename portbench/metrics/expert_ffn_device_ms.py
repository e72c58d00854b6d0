"""MoE experts on the device: ms a step of the profiled slice in which an
operation launched inside the program's ``moe.experts`` spans ran (the
union of their device intervals: the per-expert products and what
gathers their inputs), every MoE layer of the step summed.  Nothing to
read where no model Python runs in the slice (a replayed CUDA graph), the
model has no MoE layer, or the spans launched nothing."""

from portbench.stats import union_length

UNIT = "ms"
SPAN = "moe.experts"


def read(view):
    sl = view.slice
    ops = None if sl is None else sl.launched_in(SPAN)
    if not ops:
        return None
    return union_length([(o.start, o.end) for o in ops]) * 1e-6 / sl.steps
