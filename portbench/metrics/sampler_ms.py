"""Sampler: device time a ``LockstepDecoder._sample`` call spans (its
stamps, recorded around the call in the traced run's window), averaged
over every generated step in the window."""

UNIT = "ms"


def read(view):
    if not view.sample_ms:
        return None
    return sum(view.sample_ms) / len(view.sample_ms)
