"""Serve loop, in a cell whose end-to-end metrics leave out the host-bound
cadence (``tpot_p95_ms`` too unsteady on the card's host to bound): the
same number, the 95th percentile of the gaps between a request's tokens
in the traced run's window.  Nothing to read where the cell reports
``tpot_p95_ms`` end to end."""

from portbench import stats

UNIT = "ms"


def read(view):
    if "tpot_p95_ms" in view.end_to_end or not view.gaps:
        return None
    return stats.percentile(view.gaps, 95)
