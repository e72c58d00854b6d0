"""MoE experts: host ms a step of the profiled slice inside the program's
``moe.experts`` spans (``models/moe.py``: the per-expert products over
the dispatched segments), nested spans inclusive, every MoE layer of the
step summed: the host's time launching them, which a grouped launch would
cut whatever the products' device time; that is ``expert_ffn_device_ms``.
Nothing to read where no model Python runs in the slice (a replayed CUDA
graph) or the model has no MoE layer."""

UNIT = "ms"
SPAN = "moe.experts"


def read(view):
    sl = view.slice
    s = None if sl is None else sl.program_s(SPAN)
    return None if s is None else 1e3 * s / sl.steps
