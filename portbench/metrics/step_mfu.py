"""Whole step: FLOPs the configuration needs for every token fed through
the traced run's window (``flops/<family>.py``, at each decode step's
position, for the rows whose request needs that step: a row past its own
count is the lock-step path's waste), over the window's seconds times the
device's bfloat16 peak, in percent."""

from portbench import roofline

UNIT = "%"


def read(view):
    if not view.fed_positions or view.peaks is None:
        return None
    flops = sum(rows * view.flops_per_token(p)
                for p, rows in zip(view.fed_positions, view.fed_rows))
    return 100.0 * roofline.flop_bound_s(flops, view.peaks) / view.seconds
