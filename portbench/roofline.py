"""Least times of a unit of work on a device, from its operations or
bytes and the device's peaks (``peaks.py``).

The byte bound counts each input byte read once and each output byte
written once, whatever the kernel reads again; it is the arithmetic of
the port's ``kernels/bench.py`` (bytes over the HBM rate), copied so that
the yardstick stays here."""

from __future__ import annotations


def byte_bound_s(n_bytes: float, peaks: dict) -> float:
    return n_bytes / peaks["hbm_bytes_per_s"]


def flop_bound_s(flops: float, peaks: dict) -> float:
    return flops / peaks["bf16_flop_per_s"]


def topk_bytes(rows: int, vocab: int, k: int) -> int:
    """One top-k sample of ``rows`` float32 logit rows: every logit read
    once, ``k`` float32 values and ``k`` int32 indices written a row."""
    return rows * (vocab * 4 + k * (4 + 4))
