"""Serve loop: device kernels launched a step (sample and decode) in the
profiled slice of steady generated steps."""

UNIT = "kernels/step"


def read(view):
    if view.slice is None or not view.slice.kernels:
        return None
    return len(view.slice.kernels) / view.slice.steps
