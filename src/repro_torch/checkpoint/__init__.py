"""Atomic checkpoints (torch port of ``repro.checkpoint``)."""
