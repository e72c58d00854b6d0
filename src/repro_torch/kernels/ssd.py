"""Hopper kernel for one token of the Mamba2 SSD recurrence, writing the
cached state in place (``csrc/ssd_step.cu``).

:func:`ssd_step_update` computes, for every (row, head),
``h' = exp(dt * a) * h + (dt * x) (outer) B`` into ``state`` itself and
returns ``y = C . h' + D * x`` in ``x``'s dtype: one launch that reads and
writes the float32 state once.  Its plain version is
:func:`repro_torch.models.ssm.ssd_step` followed by ``state.copy_`` of the
new state; the state equals it bit for bit and ``y`` differs only by the
order of the float32 sum.  It replaces no TPU kernel (the reference runs
the step as ``ssd_chunked`` at ``s = chunk = 1`` in XLA ops).

The wrapper takes CUDA tensors only and raises on anything the kernel does
not take; :func:`repro_torch.models.ssm.ssd_step_` chooses between it and
the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["ssd_step_update", "MAX_STATE"]

#: The widest ``d_state`` the kernel takes (a multiple of 4 up to this).
MAX_STATE = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F32X4 = (torch.float32,) * 4

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64


@functools.cache
def _ssd_step_fn():
    fn = _build.load("ssd_step").ssd_step_launch
    fn.argtypes = [_I, _P, _L, _P, _L, _P, _L, _P, _L, _P, _P, _P, _P, _L,
                   _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _problem(x, dt, b, c, a_log, d_skip, state) -> str | None:
    """What the C entry cannot see and the kernel does not take, or None:
    devices, dtypes, shapes and strides (an axis of size 1 may have any
    stride).  The entry refuses the rest itself (``d_state``,
    ``ngroups``, the state's alignment).  The decode step calls this once
    a layer: the checks read ints and tuples the tensors hold, and the
    messages are built only for a refusal."""
    dev = state.get_device()
    if (dev < 0 or dev != torch.cuda.current_device()
            or x.get_device() != dev or dt.get_device() != dev
            or b.get_device() != dev or c.get_device() != dev
            or a_log.get_device() != dev or d_skip.get_device() != dev):
        return (f"needs CUDA tensors on the current device, got "
                f"{sorted({str(t.device) for t in (x, dt, b, c, a_log, d_skip, state)})}")
    if (x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype
            or (dt.dtype, a_log.dtype, d_skip.dtype, state.dtype) != _F32X4):
        return (f"x, b and c must share float32 or bfloat16 and dt, a_log, "
                f"d_skip and the state be float32, got {x.dtype}/{b.dtype}/"
                f"{c.dtype} and {dt.dtype}/{a_log.dtype}/{d_skip.dtype}/"
                f"{state.dtype}")
    if x.dim() != 3 or b.dim() != 3:
        return "x (bt, h, p), b and c (bt, g, n)"
    bt, h, p = x.shape
    _, g, n = b.shape
    if (state.shape != (bt, h, p, n) or dt.shape != (bt, h)
            or b.shape[0] != bt or c.shape != b.shape
            or a_log.shape != (h,) or d_skip.shape != (h,)):
        return (f"x (bt, h, p), dt (bt, h), b and c (bt, g, n), a_log and "
                f"d_skip (h,), the state (bt, h, p, n), got "
                f"{[tuple(t.shape) for t in (x, dt, b, c, a_log, d_skip, state)]}")
    xs, bs, cs = x.stride(), b.stride(), c.stride()
    if not (state.is_contiguous() and a_log.is_contiguous()
            and d_skip.is_contiguous() and (dt.stride(1) == 1 or h == 1)
            and (xs[2] == 1 or p == 1) and (xs[1] == p or h == 1)
            and (bs[2] == 1 or n == 1) and (bs[1] == n or g == 1)
            and (cs[2] == 1 or n == 1) and (cs[1] == n or g == 1)):
        return (f"the state, a_log and d_skip must be contiguous, x, dt, b "
                f"and c contiguous but for their row stride, got strides "
                f"{[t.stride() for t in (x, dt, b, c, a_log, d_skip, state)]}")
    return None


def ssd_step_update(x, dt, b, c, a_log, d_skip, state) -> torch.Tensor:
    """One token for every row: ``state`` (bt, h, p, n) float32 is
    overwritten with ``h'`` and ``y`` (bt, h, p) is returned in ``x``'s
    dtype.  x: (bt, h, p); dt: (bt, h) float32 (after the softplus);
    b/c: (bt, g, n); a_log, d_skip: (h,) float32.

    x, b and c are float32 or bfloat16 (one dtype), contiguous but for
    their row stride (the slices of the conv output the block takes);
    ``state`` is contiguous and 16-byte aligned; ``n`` is a multiple of 4
    up to :data:`MAX_STATE`; ``g`` divides ``h``; every tensor is on the
    current CUDA device, and the kernel runs on its current stream.
    Raises on anything else."""
    problem = _problem(x, dt, b, c, a_log, d_skip, state)
    if problem:
        raise ValueError(f"ssd_step: {problem}")
    bt, h, p = x.shape
    g, n = b.shape[1], b.shape[2]
    y = torch.empty((bt, h, p), dtype=x.dtype, device=x.device)
    err = _ssd_step_fn()(
        _DTYPES[x.dtype], x.data_ptr(), x.stride(0), dt.data_ptr(),
        dt.stride(0), b.data_ptr(), b.stride(0), c.data_ptr(), c.stride(0),
        a_log.data_ptr(), d_skip.data_ptr(), state.data_ptr(), y.data_ptr(),
        bt, h, p, n, g, torch.cuda.current_stream().cuda_stream,
    )
    if err == -1:
        raise ValueError(
            f"ssd_step: the kernel takes d_state a multiple of 4 up to "
            f"{MAX_STATE}, ngroups dividing nheads and a 16-byte aligned "
            f"state; got d_state {n}, ngroups {g}, nheads {h}, the state at "
            f"{state.data_ptr():#x}")
    if err:
        raise RuntimeError(f"ssd_step: kernel launch failed with CUDA error {err}")
    ssd_step_update.launches += 1
    return y


ssd_step_update.launches = 0
