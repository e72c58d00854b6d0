"""Serve loop, in a cell whose end-to-end metrics leave out the host-bound
rate (``decode_tok_s`` too unsteady on the card's host to bound): the
same number, tokens the traced run's window asked for over that window.
Nothing to read where the cell reports ``decode_tok_s`` end to end."""

from portbench import stats

UNIT = "tokens/s"


def read(view):
    if "decode_tok_s" in view.end_to_end or not view.tokens or view.seconds <= 0:
        return None
    return stats.rate(view.tokens, view.seconds)
