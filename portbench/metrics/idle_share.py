"""Device: share of the profiled slice's length in which no operation ran
on the device (1 - busy / length), in percent."""

UNIT = "%"


def read(view):
    if view.slice is None or view.slice.span_s <= 0:
        return None
    return 100.0 * (1.0 - view.slice.busy_s / view.slice.span_s)
