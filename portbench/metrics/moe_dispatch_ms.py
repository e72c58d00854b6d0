"""MoE dispatch: host ms a step of the profiled slice inside the program's
``moe.dispatch`` spans (``models/moe.py``: the assignment sort, the
segment bounds and the blocking host read of the segment sizes), nested
spans inclusive, every MoE layer of the step summed.  The host read waits
for all device work queued before it, that layer's attention and router
included, so this is the host's time in the layer, waits and all; the
layer's own device time is ``moe_dispatch_device_ms``.  Nothing to read
where no model Python runs in the slice (a replayed CUDA graph) or the
model has no MoE layer."""

UNIT = "ms"
SPAN = "moe.dispatch"


def read(view):
    sl = view.slice
    s = None if sl is None else sl.program_s(SPAN)
    return None if s is None else 1e3 * s / sl.steps
