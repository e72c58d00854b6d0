"""MoE dispatch on the device: ms a step of the profiled slice in which
an operation launched inside the program's ``moe.dispatch`` spans ran
(the union of their device intervals: the assignment sort's kernels, the
bounds, the copy of the segment sizes to the host), every MoE layer of
the step summed.  What the host waits for in those spans does not count.
Nothing to read where no model Python runs in the slice (a replayed CUDA
graph), the model has no MoE layer, or the spans launched nothing."""

from portbench.stats import union_length

UNIT = "ms"
SPAN = "moe.dispatch"


def read(view):
    sl = view.slice
    ops = None if sl is None else sl.launched_in(SPAN)
    if not ops:
        return None
    return union_length([(o.start, o.end) for o in ops]) * 1e-6 / sl.steps
