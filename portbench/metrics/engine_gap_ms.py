"""Engine host loop: device idle time, in ms a step of the profiled
slice, in the gaps that end at an operation launched in the engine's own
host work (the ``portbench.engine`` span of ``paths/engine.py``: a step's
admission and packed input copy, and the readback and retire loop that
follow its sampler).  Such a gap is the host's time between one step's
tokens reaching it and the next step's inputs leaving it.  Nothing to
read on a path without that span."""

UNIT = "ms"


def read(view):
    sl = view.slice
    if sl is None or not any(o.span == "engine" for o in sl.ops):
        return None
    idle, reach = 0, sl.ops[0].end
    for o in sl.ops[1:]:
        if o.start > reach and o.span == "engine":
            idle += o.start - reach
        reach = max(reach, o.end)
    return idle * 1e-6 / sl.steps
