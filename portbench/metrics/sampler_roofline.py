"""Tile kernels behind the sampler: the least time the sampler's work
needs, over the device time of every kernel launched inside the sampler's
span in the profiled slice, in percent.  The least time is the byte bound
of a top-k sample of every row (``roofline.topk_bytes``: each float32
logit read once, ``k`` values and ``k`` int32 indices written), whatever
implements it; a top-p sample is held to the same bound over its ``k``
candidates (the nucleus cut and the draw read only those).  Nothing to
read where no merge kernel runs in the span (a greedy sampler)."""

from portbench import roofline

UNIT = "%"


def read(view):
    sl = view.slice
    if (sl is None or view.peaks is None
            or view.sampler not in ("topk", "topp")):
        return None
    ops = [o for o in sl.in_span("sample") if o.kind == "kernel"]
    if not any("merge" in o.name.lower() for o in ops):
        return None
    device_s = sum(o.end - o.start for o in ops) * 1e-9
    least = sl.steps * roofline.byte_bound_s(
        roofline.topk_bytes(view.clients, view.vocab, view.top_k), view.peaks)
    return 100.0 * least / device_s
