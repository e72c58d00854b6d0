"""Decode step: device time a ``LockstepDecoder._decode`` call spans (its
stamps, recorded around the call in the traced run's window), averaged
over every decode step in the window, prompt and generated."""

UNIT = "ms"


def read(view):
    if not view.decode_ms:
        return None
    return sum(view.decode_ms) / len(view.decode_ms)
