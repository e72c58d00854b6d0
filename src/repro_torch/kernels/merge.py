"""Hopper kernels for the co-rank stable merge (port of
``repro.kernels.merge``).

Two kernels, each with a wrapper, a launch counter and a plain PyTorch
version of the same function:

* :func:`merge_tile` (``csrc/merge_tile.cu``) replaces
  ``merge_tile_kernel``: the output tiles of ``S`` elements of the stable
  merge of ``A`` and ``B``, walked by persistent CUDA blocks that stage
  the next tile's windows while they merge the current one.
* :func:`merge_kway_tile` (``csrc/merge_kway_tile.cu``) replaces
  ``merge_kway_tile_kernel``: one ``S``-tile of the stable merge of ``k``
  runs per CUDA block, with an optional payload, as a tree of pairwise
  merges of the tile's non-empty segments in shared memory; ragged runs
  need no kernel change.

Both take their tile windows from phase 1 — the co-ranks of every tile
boundary ``r*S`` (``co_rank_batch`` / ``co_rank_kway_batch`` in torch
ops, as the reference computes them in plain JAX).  :func:`merge_tiled`
and :func:`merge_kway_tiled` run both phases, the counterparts of
``merge_pallas`` and ``merge_kway_pallas``.

A wrapper takes its plain version only when every tensor it is given lies
on the CPU (the tests).  For CUDA tensors it launches the kernel on the
current stream, or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.corank import co_rank_batch
from repro_torch.core.engine import SIDE_STRICT, SIDE_TIES
from repro_torch.core.kway import co_rank_kway_batch
from repro_torch.core.mergesort import merge_runs_plain
from repro_torch.kernels import _build

__all__ = [
    "merge_tile",
    "merge_tile_plain",
    "merge_tiled",
    "merge_kway_tile",
    "merge_kway_tile_plain",
    "merge_kway_tiled",
    "merge_kway_tile_groups",
    "merge_kway_groups_plain",
    "tile_bounds",
    "MERGE_TILE",
    "KWAY_TILE",
    "KWAY_MAX_RUNS",
]

#: Output elements per tile: the one tile each kernel is compiled for
#: (256 threads with 15 outputs each; an odd count per thread keeps a warp's
#: strided shared-memory writes on distinct banks).
MERGE_TILE = 3840
KWAY_TILE = 3840
#: Most runs one k-way launch merges (each block reads its tile's k cuts).
KWAY_MAX_RUNS = 16384

_MERGE_DTYPES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2,
                 torch.int64: 3, torch.float64: 4, torch.float16: 5}
_KWAY_DTYPES = {torch.int32: 0, torch.float32: 1, torch.int64: 2,
                torch.float64: 3, torch.float16: 4, torch.bfloat16: 5}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64


@functools.cache
def _merge_tile_fn():
    fn = _build.load("merge_tile").merge_tile_launch
    fn.argtypes = [_I, _I, _P, _P, _P, _P, _P, _L, _L, _L, _P]
    fn.restype = _I
    return fn


@functools.cache
def _merge_kway_tile_fn():
    fn = _build.load("merge_kway_tile").merge_kway_tile_launch
    fn.argtypes = [_I, _I, _I, _I, _P, _P, _L, _P, _P, _P, _L, _L, _P]
    fn.restype = _I
    return fn


@functools.cache
def _merge_kway_groups_fn():
    fn = _build.load("merge_kway_tile").merge_kway_groups_launch
    fn.argtypes = [_I, _I, _I, _I, _I, _L, _I, _P, _P, _P, _P, _P]
    fn.restype = _I
    return fn


def _on_cpu(*tensors) -> bool:
    """True iff every tensor lies on the CPU; raises unless they all lie
    on the CPU or all on one CUDA device."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check(cond: bool, op: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{op}: {what}")


def _raise_on_error(op: str, err: int) -> None:
    if err == -1:
        raise ValueError(f"{op}: the kernel has no instance for these arguments")
    if err:
        raise RuntimeError(f"{op}: kernel launch failed with CUDA error {err}")


def tile_bounds(total: int, tile: int, device) -> torch.Tensor:
    """Output tile boundaries ``min(r * tile, total)``, r = 0..ceil(total/tile),
    as int32 (the cut dtype of phase 1)."""
    if total >= 1 << 31:
        raise ValueError(f"{total} outputs: tile bounds and cuts are int32")
    g = -(-total // tile)
    r = torch.arange(g + 1, dtype=torch.int64, device=device) * tile
    return torch.clamp(r, max=total).to(torch.int32)


# ---------------------------------------------------------------------------
# pairwise: merge_tile
# ---------------------------------------------------------------------------


def merge_tile_plain(a, b, jb, kb, *, tile: int = MERGE_TILE) -> torch.Tensor:
    """Plain version of :func:`merge_tile`: rank merging inside the tile
    windows.

    Element ``a[j]`` of tile ``r`` (``jb[r] <= j < jb[r+1]``) lands at
    ``r*tile + (j - jb[r]) + |{B-window elements < a[j]}|``, and
    ``b[k]`` of tile ``r`` at ``r*tile + (k - kb[r]) + |{A-window
    elements <= b[k]}|`` — the Lemma-1 sides, counted only inside the
    windows that phase 1 assigned to the tile.
    """
    m, n = a.shape[0], b.shape[0]
    out = torch.empty((m + n,), dtype=a.dtype, device=a.device)
    jb, kb = jb.long(), kb.long()
    for x, own, other, side, y in (
        (a, jb, kb, SIDE_STRICT, b),
        (b, kb, jb, SIDE_TIES, a),
    ):
        idx = torch.arange(x.shape[0], device=x.device)
        r = torch.searchsorted(own, idx, side="right") - 1
        lo, hi = other[r], other[r + 1]
        cnt = torch.clamp(torch.searchsorted(y, x, side=side), lo, hi) - lo
        out[r * tile + (idx - own[r]) + cnt] = x
    return out


def merge_tile(a, b, jb, kb):
    """Merge the output tiles ``[r*MERGE_TILE, min((r+1)*MERGE_TILE, m+n))``
    of the stable merge of sorted ``a`` and ``b`` in one launch.

    ``jb``/``kb``: int32 ``(G+1,)`` co-ranks of the tile boundaries
    ``min(r*MERGE_TILE, m+n)`` (phase 1).  ``a`` and ``b`` share a dtype
    (int32, int64, float32, float64, float16 or bfloat16).  Returns the
    merged ``(m+n,)`` tensor.
    """
    op = "merge_tile"
    on_cpu = _on_cpu(a, b, jb, kb)
    _check(a.dtype == b.dtype and a.dtype in _MERGE_DTYPES, op,
           f"keys must share one of {list(_MERGE_DTYPES)}, got {a.dtype}/{b.dtype}")
    _check(a.dim() == b.dim() == jb.dim() == kb.dim() == 1, op, "all inputs must be 1-D")
    _check(jb.dtype == kb.dtype == torch.int32, op, "co-ranks must be int32")
    _check(jb.shape == kb.shape, op, "jb and kb must have one shape")
    for t in (a, b, jb, kb):
        _check(t.is_contiguous(), op, "inputs must be contiguous")
    total = a.shape[0] + b.shape[0]
    g = jb.shape[0] - 1
    _check(g == -(-total // MERGE_TILE), op,
           f"{g} tiles given for {total} outputs at tile {MERGE_TILE}")
    if on_cpu:
        return merge_tile_plain(a, b, jb, kb, tile=MERGE_TILE)
    out = torch.empty((total,), dtype=a.dtype, device=a.device)
    if g > 0:
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _merge_tile_fn()(
                _MERGE_DTYPES[a.dtype], MERGE_TILE, a.data_ptr(), b.data_ptr(),
                jb.data_ptr(), kb.data_ptr(), out.data_ptr(), a.shape[0],
                b.shape[0], g, stream,
            )
        _raise_on_error(op, err)
        merge_tile.launches += 1
    return out


merge_tile.launches = 0


def merge_tiled(a, b) -> torch.Tensor:
    """Stable merge of two sorted 1-D tensors: phase 1 co-ranks every tile
    boundary, :func:`merge_tile` merges the tiles (``merge_pallas``)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype).contiguous(), b.to(dtype).contiguous()
    bounds = tile_bounds(a.shape[0] + b.shape[0], MERGE_TILE, a.device)
    cr = co_rank_batch(bounds, a, b)
    return merge_tile(a, b, cr.j, cr.k)


# ---------------------------------------------------------------------------
# k-way: merge_kway_tile
# ---------------------------------------------------------------------------


def merge_kway_tile_plain(runs, cb, *, tile: int = KWAY_TILE, vals=None,
                          out_len: int):
    """Plain version of :func:`merge_kway_tile`: the kernel's tile program
    in torch ops, every tile at once.

    Tile ``r`` stages its non-empty segments ``[cb[r,q], cb[r+1,q])`` side
    by side in run order (compaction), then ``ceil(log2(k'))`` levels merge
    adjacent segments ``(2i, 2i+1)`` of its ``k'`` segments pairwise, the
    left one winning ties; an odd segment passes through.  A level places
    each element at its pair's start plus its index in its own segment plus
    the sibling segment's elements before it (strict for the left side,
    ties for the right: the engine's run-index tie-break).  Elements past
    the last cut are not emitted; unwritten outputs are zero.
    """
    k, w = runs.shape
    g = cb.shape[0] - 1
    dev = runs.device
    out_k = torch.zeros((out_len,), dtype=runs.dtype, device=dev)
    out_v = None if vals is None else torch.zeros(
        (out_len,), dtype=vals.dtype, device=dev)
    if g == 0:
        return out_k if vals is None else (out_k, out_v)

    # Compaction: the non-empty segments, tile-major and in run order.
    lo = cb[:-1].long()
    n = cb[1:].long() - lo
    seg_tile, seg_run = torch.nonzero(n > 0, as_tuple=True)
    seg_n = n[seg_tile, seg_run]
    kp = torch.bincount(seg_tile, minlength=g)  # k' of every tile
    first_seg = torch.cumsum(kp, 0) - kp
    seg_off = torch.cumsum(seg_n, 0) - seg_n  # first element of each segment
    tile_len = torch.zeros(g, dtype=torch.long, device=dev).index_add_(
        0, seg_tile, seg_n)
    tile_off = torch.cumsum(tile_len, 0) - tile_len  # first element of each tile
    seg_start = seg_off - tile_off[seg_tile]  # tile-local slot of each segment

    # Staging: element e is slot pos[e] of tile t[e], from compacted
    # segment c[e] (tile-local index) of run q.
    e_seg = torch.repeat_interleave(torch.arange(seg_n.numel(), device=dev),
                                    seg_n)
    u = torch.arange(e_seg.numel(), device=dev) - seg_off[e_seg]
    t = seg_tile[e_seg]
    c = e_seg - first_seg[t]
    pos = seg_start[e_seg] + u
    src = seg_run[e_seg], lo[t, seg_run[e_seg]] + u
    keys = runs[src]
    payload = None if vals is None else vals[src]
    # Order-preserving integer ranks of the keys (equal keys, -0.0 and
    # 0.0 included, share one), so that a sibling's elements before a key
    # can be counted for every segment at once by one search.
    wide = keys.float() if keys.element_size() == 2 else keys
    rank = torch.unique(wide, return_inverse=True)[1].long()

    def start(level_seg, step):
        """Tile-local slot where level segment ``level_seg`` of tile ``t``
        starts (the tile's length when it has no such segment)."""
        first = level_seg * step
        return torch.where(first < kp[t],
                           seg_start[first_seg[t] + torch.clamp(
                               first, max=kp[t] - 1)],
                           tile_len[t])

    step = 1
    while bool((kp > step).any()):
        own = c // step  # this level's segment of each element
        sib = own ^ 1
        own_start, sib_start = start(own, step), start(sib, step)
        sib_len = start(sib + 1, step) - sib_start
        # The level's slots in tile and slot order, keyed (segment, rank):
        # non-decreasing, since each segment is sorted.
        level_key = torch.empty_like(rank)
        level_key[tile_off[t] + pos] = ((first_seg[t] + own) << 31) | rank
        # The left segment counts its right sibling's keys below its own
        # (strict); the right one counts its left sibling's ties too.
        left = own % 2 == 0
        probe = ((first_seg[t] + sib) << 31) | rank
        before = torch.where(
            left,
            torch.searchsorted(level_key, probe, side=SIDE_STRICT),
            torch.searchsorted(level_key, probe, side=SIDE_TIES),
        ) - (tile_off[t] + sib_start)
        before = torch.minimum(before.clamp(min=0), sib_len)
        pair_start = torch.where(left, own_start, sib_start)
        pos = pair_start + (pos - own_start) + before
        step *= 2

    out_k[t * tile + pos] = keys
    if vals is not None:
        out_v[t * tile + pos] = payload
    return out_k if vals is None else (out_k, out_v)


def merge_kway_tile(runs, cb, *, vals=None, out_len: int):
    """Merge the output tiles ``[r*KWAY_TILE, (r+1)*KWAY_TILE)`` of the
    stable k-way merge of the rows of ``runs`` in one launch.

    ``runs``: ``(k, w)`` sorted rows, ``1 <= k <= KWAY_MAX_RUNS``, keys
    int32, int64, float32, float64, float16 or bfloat16; ``vals``: optional
    ``(k, w)`` payload of any 4- or 8-byte dtype; ``cb``: int32 ``(G+1, k)``
    cut matrix of the tile boundaries ``min(r*KWAY_TILE, out_len)`` (phase
    1, clamped at the real run lengths).  Returns ``(out_len,)`` keys (and
    payload); positions past the real total are unspecified.
    """
    op = "merge_kway_tile"
    on_cpu = _on_cpu(runs, cb, vals)
    _check(runs.dim() == 2, op, f"runs must be (k, w), got {tuple(runs.shape)}")
    k, w = runs.shape
    _check(runs.dtype in _KWAY_DTYPES, op,
           f"keys must be one of {list(_KWAY_DTYPES)}, got {runs.dtype}")
    _check(1 <= k <= KWAY_MAX_RUNS, op,
           f"k must be in [1, {KWAY_MAX_RUNS}], got {k}")
    _check(cb.dtype == torch.int32 and cb.dim() == 2 and cb.shape[1] == k,
           op, f"cut matrix must be int32 (G+1, {k}), got {tuple(cb.shape)}")
    g = cb.shape[0] - 1
    _check(g == -(-out_len // KWAY_TILE), op,
           f"{g} tiles given for {out_len} outputs at tile {KWAY_TILE}")
    _check(runs.is_contiguous() and cb.is_contiguous(), op,
           "inputs must be contiguous")
    if vals is not None:
        _check(vals.shape == runs.shape and vals.is_contiguous()
               and vals.element_size() in (4, 8), op,
               "payload must be a contiguous 4- or 8-byte tensor shaped like runs")
    if on_cpu:
        return merge_kway_tile_plain(runs, cb, tile=KWAY_TILE, vals=vals,
                                     out_len=out_len)
    out_k = torch.empty((out_len,), dtype=runs.dtype, device=runs.device)
    out_v = None if vals is None else torch.empty(
        (out_len,), dtype=vals.dtype, device=vals.device)
    if g > 0:
        with torch.cuda.device(runs.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _merge_kway_tile_fn()(
                _KWAY_DTYPES[runs.dtype],
                0 if vals is None else vals.element_size(), KWAY_TILE, k,
                runs.data_ptr(), None if vals is None else vals.data_ptr(),
                w, cb.data_ptr(), out_k.data_ptr(),
                None if out_v is None else out_v.data_ptr(), out_len, g,
                stream,
            )
        _raise_on_error(op, err)
        merge_kway_tile.launches += 1
    return out_k if vals is None else (out_k, out_v)


merge_kway_tile.launches = 0


def merge_kway_tiled(runs, vals=None, *, lengths=None,
                     out_len: int | None = None):
    """Stable merge of ``k`` sorted rows in one tiled pass
    (``merge_kway_pallas``).

    Phase 1 cuts every tile boundary into every run at once
    (``co_rank_kway_batch``, clamped at ``lengths`` so padding is never
    merged: rows must stay sorted over their full width); phase 2 is
    :func:`merge_kway_tile`.  Returns the first ``out_len`` (default
    ``k*w``) merged keys (and payload); with ``lengths``, positions
    ``>= sum(lengths)`` are unspecified.
    """
    k, w = runs.shape
    total = k * w if out_len is None else out_len
    runs = runs.contiguous()
    bounds = tile_bounds(total, KWAY_TILE, runs.device)
    cb = co_rank_kway_batch(bounds, runs, lengths)  # (G+1, k)
    return merge_kway_tile(runs, cb,
                           vals=None if vals is None else vals.contiguous(),
                           out_len=total)


# ---------------------------------------------------------------------------
# k-way, grouped: merge_kway_tile_groups
# ---------------------------------------------------------------------------


#: Plain version of :func:`merge_kway_tile_groups`: the core's rank merge.
merge_kway_groups_plain = merge_runs_plain


def merge_kway_tile_groups(keys, vals=None):
    """Merge ``g`` independent groups of ``k`` sorted runs in one launch:
    ``keys`` ``(g, k, w)`` with every ``keys[i, q]`` sorted -> ``(g, k*w)``
    stably merged (lower ``q`` wins ties); ``vals`` (same shape, any 4- or
    8-byte dtype) follows the same permutation.  Returns ``(keys, vals)``,
    ``vals`` ``None`` without a payload.

    The grouped launch of ``csrc/merge_kway_tile.cu``: a group must fit one
    tile (``k*w <= KWAY_TILE``), so its cuts are trivial and there is no
    phase 1; each CUDA block packs ``KWAY_TILE // (k*w)`` whole groups.
    """
    op = "merge_kway_tile_groups"
    on_cpu = _on_cpu(keys, vals)
    _check(keys.dim() == 3, op, f"keys must be (g, k, w), got {tuple(keys.shape)}")
    g, k, w = keys.shape
    _check(keys.dtype in _KWAY_DTYPES, op,
           f"keys must be one of {list(_KWAY_DTYPES)}, got {keys.dtype}")
    _check(k >= 1 and w >= 1 and k * w <= KWAY_TILE, op,
           f"a group of k*w = {k}*{w} must fit one tile of {KWAY_TILE}")
    _check(keys.is_contiguous(), op, "keys must be contiguous")
    if vals is not None:
        _check(vals.shape == keys.shape and vals.is_contiguous()
               and vals.element_size() in (4, 8), op,
               "payload must be a contiguous 4- or 8-byte tensor shaped like keys")
    if on_cpu:
        return merge_kway_groups_plain(keys, vals)
    out_k = torch.empty((g, k * w), dtype=keys.dtype, device=keys.device)
    out_v = None if vals is None else torch.empty(
        (g, k * w), dtype=vals.dtype, device=vals.device)
    if g > 0:
        with torch.cuda.device(keys.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _merge_kway_groups_fn()(
                _KWAY_DTYPES[keys.dtype],
                0 if vals is None else vals.element_size(), KWAY_TILE, k, w,
                g, KWAY_TILE // (k * w), keys.data_ptr(),
                None if vals is None else vals.data_ptr(), out_k.data_ptr(),
                None if out_v is None else out_v.data_ptr(), stream,
            )
        _raise_on_error(op, err)
        merge_kway_tile_groups.launches += 1
    return out_k, out_v


merge_kway_tile_groups.launches = 0
