"""Hopper kernels for the co-rank stable merge (port of
``repro.kernels.merge``).

Two TPU kernels, ported as four launches, each with a wrapper, a launch
counter and a plain PyTorch version of the same function:

* :func:`merge_tile` (``csrc/merge_tile.cu``) replaces
  ``merge_tile_kernel`` and the phase 1 in front of it: the stable merge
  of ``A`` and ``B`` in tiles of ``S`` outputs, each CUDA block co-ranking
  the boundaries of its own contiguous range of tiles (the paper's
  Algorithm 1) and then staging the next tile's windows while it merges
  the current one.
* :func:`merge_kway_tile` (``csrc/merge_kway_tile.cu``) replaces
  ``merge_kway_tile_kernel``: one ``S``-tile of the stable merge of ``k``
  runs per CUDA block, with an optional payload, as a tree of pairwise
  merges of the tile's non-empty segments in shared memory; ragged runs
  need no kernel change.

* :func:`merge_kway_tile_groups` (``merge_kway_groups_kernel`` in the
  same file) merges ``g`` independent groups of ``k`` runs of width ``w``
  that fit one tile of ``GROUPS_TILE`` (the sort plan's leaf, the top-k's
  block sort and rounds): persistent blocks, each group sorted in
  registers and warp shuffles, the levels above a warp in shared memory.
* :func:`merge_kway_groups_wide` (``merge_kway_groups_wide_kernel``)
  merges groups wider than that tile (merge sort's later passes), with an
  optional ragged form (run lengths, ``out_len``): each block co-ranks its
  own output tiles inside its group and merges them as ``merge_kway_tile``
  does.

Only :func:`merge_kway_tile` takes its tile windows from a phase 1 in
torch ops (``co_rank_kway_batch``, as the reference computes them in
plain JAX).  :func:`merge_tiled` and :func:`merge_kway_tiled` are the
counterparts of ``merge_pallas`` and ``merge_kway_pallas``: one launch of
:func:`merge_tile`, and for ``k <= WIDE_MAX_RUNS`` runs one wide launch
with ``g = 1``; more runs take phase 1 and :func:`merge_kway_tile`.

A wrapper takes its plain version only when every tensor it is given lies
on the CPU (the tests).  For CUDA tensors it launches the kernel on the
current stream, or raises; it never falls back.

Each entry point is also a ``torch.library`` custom op
(``repro_torch::merge_tile``, ``::merge_kway_tile``,
``::merge_kway_groups``, ``::merge_kway_groups_wide``) whose fake
implementation gives the kernel's output shapes and dtypes, so a fake
trace (the dry-run) runs through it, and :func:`register_dtensor_rules`
gives DTensor its sharding: groups are independent, so the grouped
launches may shard their group axis; the other two replicate.  Real CUDA tensors call the kernel directly (the
dispatcher's own cost per call stays off the host-bound decode path);
fake tensors, DTensors and CPU tensors go through the op, whose body is
the same wrapper code.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.corank import co_rank_batch
from repro_torch.core.engine import SIDE_STRICT, SIDE_TIES
from repro_torch.core.kway import co_rank_kway_batch, kway_positions
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
    "merge_kway_groups_wide",
    "merge_kway_groups_wide_plain",
    "wide_tile_cuts",
    "tile_bounds",
    "register_dtensor_rules",
    "MERGE_TILE",
    "KWAY_TILE",
    "KWAY_MAX_RUNS",
    "GROUPS_TILE",
    "WIDE_TILE",
    "WIDE_MAX_RUNS",
]

#: Output elements per tile: the one tile each kernel is compiled for
#: (256 threads with 15 outputs each; an odd count per thread keeps a warp's
#: strided shared-memory writes on distinct banks).
MERGE_TILE = 3840
KWAY_TILE = 3840
#: Most runs one k-way launch merges (each block reads its tile's k cuts).
KWAY_MAX_RUNS = 16384
#: Elements of one tile of the grouped launch: 256 threads with 16 keys
#: each, a power of two, so that power-of-two groups (the sort plan's
#: leaf, ``LEAF_WIDTH`` in ``core.mergesort``) fill it exactly.  A group
#: of ``k*w`` elements is padded to the next power of two inside a tile.
GROUPS_TILE = 4096
#: Output elements of one tile of the wide grouped launch (the k-way
#: kernel's tile and merge tree) and the most runs a group of it may have
#: (a block co-ranks its tiles with a window of each run in shared memory).
WIDE_TILE = 3840
WIDE_MAX_RUNS = 64

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
    fn.argtypes = [_I, _I, _P, _P, _P, _L, _L, _L, _P, _P, _P]
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
    fn.argtypes = [_I, _I, _I, _I, _I, _L, _P, _P, _P, _P, _P]
    fn.restype = _I
    return fn


@functools.cache
def _merge_kway_groups_wide_fn():
    fn = _build.load("merge_kway_tile").merge_kway_groups_wide_launch
    fn.argtypes = [_I, _I, _I, _I, _L, _L, _P, _P, _P, _L, _P, _P, _P]
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


def _direct(*tensors) -> bool:
    """Real CUDA tensors (plain ``torch.Tensor``: neither fake nor a
    DTensor) call the kernel without the dispatcher; the rest go through
    the custom op."""
    return all(t is None or (type(t) is torch.Tensor and t.is_cuda)
               for t in tensors)


def merge_tile(a, b, *, cuts: bool = False):
    """Stable merge of sorted 1-D ``a`` and ``b`` (one dtype of int32,
    int64, float32, float64, float16 or bfloat16; ``m + n < 2^31``) in one
    launch, tiles of ``MERGE_TILE`` outputs.

    The kernel co-ranks every tile boundary ``min(r*MERGE_TILE, m+n)``
    itself (Algorithm 1, a lane a boundary).  Returns the merged ``(m+n,)``
    tensor, or with ``cuts=True`` ``(out, jb, kb)``: the int32 ``(G+1,)``
    co-ranks the kernel found, which equal ``co_rank_batch``'s.
    """
    _on_cpu(a, b)  # devices are checked before the op's dispatch
    if _direct(a, b):
        out = _merge_tile_impl(a, b, cuts)
    else:
        out = torch.ops.repro_torch.merge_tile(a, b, cuts)
    return out if cuts else out[0]


@torch.library.custom_op("repro_torch::merge_tile", mutates_args=())
def _merge_tile_op(a: torch.Tensor, b: torch.Tensor,
                   cuts: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Three outputs always: the cuts are empty without ``cuts``."""
    return _merge_tile_impl(a, b, cuts)


@_merge_tile_op.register_fake
def _(a, b, cuts):
    total = a.shape[0] + b.shape[0]
    g = -(-total // MERGE_TILE) + 1 if cuts else 0
    return (a.new_empty((total,)), a.new_empty((g,), dtype=torch.int32),
            a.new_empty((g,), dtype=torch.int32))


def _merge_tile_impl(a, b, cuts: bool = False):
    op = "merge_tile"
    on_cpu = _on_cpu(a, b)
    _check(a.dtype == b.dtype and a.dtype in _MERGE_DTYPES, op,
           f"keys must share one of {list(_MERGE_DTYPES)}, got {a.dtype}/{b.dtype}")
    _check(a.dim() == b.dim() == 1, op, "both inputs must be 1-D")
    _check(a.is_contiguous() and b.is_contiguous(), op, "inputs must be contiguous")
    m, n = a.shape[0], b.shape[0]
    total = m + n
    _check(total < 1 << 31, op, f"{total} outputs: the cuts are int32")
    g = -(-total // MERGE_TILE)
    if on_cpu:  # the plain version: phase 1 in torch ops, then the tiles
        cr = co_rank_batch(tile_bounds(total, MERGE_TILE, a.device), a, b)
        out = merge_tile_plain(a, b, cr.j, cr.k, tile=MERGE_TILE)
        jb, kb = cr.j, cr.k
    else:
        out = torch.empty((total,), dtype=a.dtype, device=a.device)
        jb = kb = None
        if cuts:  # the kernel writes every boundary's (none without a tile)
            jb, kb = (torch.zeros((g + 1,), dtype=torch.int32, device=a.device)
                      for _ in range(2))
        if g > 0:
            with torch.cuda.device(a.device):
                err = _merge_tile_fn()(
                    _MERGE_DTYPES[a.dtype], MERGE_TILE, a.data_ptr(),
                    b.data_ptr(), out.data_ptr(), m, n, g,
                    None if jb is None else jb.data_ptr(),
                    None if kb is None else kb.data_ptr(),
                    torch.cuda.current_stream().cuda_stream,
                )
            _raise_on_error(op, err)
            merge_tile.launches += 1
    if not cuts:
        jb, kb = (a.new_empty((0,), dtype=torch.int32) for _ in range(2))
    return out, jb, kb


merge_tile.launches = 0


def merge_tiled(a, b) -> torch.Tensor:
    """Stable merge of two sorted 1-D tensors (``merge_pallas``): one
    :func:`merge_tile` launch, which co-ranks its own tiles."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return merge_tile(a.to(dtype).contiguous(), b.to(dtype).contiguous())


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
    _on_cpu(runs, cb, vals)
    if _direct(runs, cb, vals):
        return _merge_kway_tile_impl(runs, cb, vals=vals, out_len=out_len)
    out_k, out_v = torch.ops.repro_torch.merge_kway_tile(runs, cb, vals,
                                                         out_len)
    return out_k if vals is None else (out_k, out_v)


@torch.library.custom_op("repro_torch::merge_kway_tile", mutates_args=())
def _merge_kway_tile_op(runs: torch.Tensor, cb: torch.Tensor,
                        vals: torch.Tensor | None,
                        out_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Both outputs always: the payload is empty without ``vals``."""
    out = _merge_kway_tile_impl(runs, cb, vals=vals, out_len=out_len)
    return (out, runs.new_empty((0,))) if vals is None else out


@_merge_kway_tile_op.register_fake
def _(runs, cb, vals, out_len):
    return (runs.new_empty((out_len,)),
            runs.new_empty((0,)) if vals is None else vals.new_empty((out_len,)))


def _merge_kway_tile_impl(runs, cb, *, vals=None, out_len: int):
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

    ``k <= WIDE_MAX_RUNS``: one wide launch with ``g = 1``
    (:func:`merge_kway_groups_wide`), whose blocks co-rank their own tiles,
    clamped at ``lengths`` so padding is never merged.  More runs: phase 1
    cuts every tile boundary into every run at once in torch ops
    (``co_rank_kway_batch``, clamped alike), then :func:`merge_kway_tile`.
    Rows must stay sorted over their full width.  Returns the first
    ``out_len`` (default ``k*w``) merged keys (and payload); with
    ``lengths``, positions ``>= sum(lengths)`` are unspecified.
    """
    k, w = runs.shape
    total = k * w if out_len is None else out_len
    runs = runs.contiguous()
    vals = None if vals is None else vals.contiguous()
    if k <= WIDE_MAX_RUNS:
        lens = None if lengths is None else torch.as_tensor(
            lengths, dtype=torch.int32, device=runs.device).reshape(1, k)
        out_k, out_v = merge_kway_groups_wide(
            runs[None], None if vals is None else vals[None], lens,
            out_len=total)
        return out_k[0] if vals is None else (out_k[0], out_v[0])
    bounds = tile_bounds(total, KWAY_TILE, runs.device)
    cb = co_rank_kway_batch(bounds, runs, lengths)  # (G+1, k)
    return merge_kway_tile(runs, cb, vals=vals, out_len=total)


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
    tile (``k*w <= GROUPS_TILE``), so there is no phase 1; a tile holds
    ``GROUPS_TILE // P`` whole groups, each padded to ``P``, the next power
    of two of ``k*w``.  Wider groups: :func:`merge_kway_groups_wide`.
    """
    _on_cpu(keys, vals)
    if _direct(keys, vals):
        return _merge_kway_groups_impl(keys, vals)
    out_k, out_v = torch.ops.repro_torch.merge_kway_groups(keys, vals)
    return out_k, (None if vals is None else out_v)


@torch.library.custom_op("repro_torch::merge_kway_groups", mutates_args=())
def _merge_kway_groups_op(
        keys: torch.Tensor,
        vals: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Both outputs always: the payload is empty without ``vals``."""
    out_k, out_v = _merge_kway_groups_impl(keys, vals)
    return out_k, keys.new_empty((0,)) if out_v is None else out_v


@_merge_kway_groups_op.register_fake
def _(keys, vals):
    g, k, w = keys.shape
    return (keys.new_empty((g, k * w)),
            keys.new_empty((0,)) if vals is None else vals.new_empty((g, k * w)))


def _merge_kway_groups_impl(keys, vals=None):
    op = "merge_kway_tile_groups"
    on_cpu = _on_cpu(keys, vals)
    _check(keys.dim() == 3, op, f"keys must be (g, k, w), got {tuple(keys.shape)}")
    g, k, w = keys.shape
    _check(keys.dtype in _KWAY_DTYPES, op,
           f"keys must be one of {list(_KWAY_DTYPES)}, got {keys.dtype}")
    _check(k >= 1 and w >= 1 and k * w <= GROUPS_TILE, op,
           f"a group of k*w = {k}*{w} must fit one tile of {GROUPS_TILE}")
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
    if g == 0:
        return out_k, out_v
    with torch.cuda.device(keys.device):
        err = _merge_kway_groups_fn()(
            _KWAY_DTYPES[keys.dtype], 0 if vals is None else vals.element_size(),
            GROUPS_TILE, k, w, g, keys.data_ptr(),
            None if vals is None else vals.data_ptr(), out_k.data_ptr(),
            None if out_v is None else out_v.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(op, err)
    merge_kway_tile_groups.launches += 1
    return out_k, out_v


merge_kway_tile_groups.launches = 0


# ---------------------------------------------------------------------------
# k-way, grouped and wide: merge_kway_groups_wide
# ---------------------------------------------------------------------------


def _run_lengths(keys, lengths) -> torch.Tensor:
    """``lengths`` as int32 ``(g, k)`` clamped to ``[0, w]`` (``w`` each
    without it), as the wide kernel reads them."""
    g, k, w = keys.shape
    if lengths is None:
        return torch.full((g, k), w, dtype=torch.int32, device=keys.device)
    return torch.clamp(lengths.to(torch.int32), 0, w)


def _wide_positions(keys, lengths) -> torch.Tensor:
    """Every element's rank in its group's stable merge ``(g, k, w)``,
    int64, counted as ``engine.lemma1_counts`` does (each other run's count
    clamped at its real length); padding ranks past every real one."""
    w = keys.shape[2]
    pos = kway_positions(keys, lengths).long()
    pad = torch.arange(w, device=keys.device) >= lengths[..., None]
    return torch.where(pad, torch.iinfo(torch.int64).max, pos)


def wide_tile_cuts(keys, lengths=None, *, out_len: int | None = None,
                   tile: int = WIDE_TILE) -> torch.Tensor:
    """Cut vectors of every output tile boundary ``min(r*tile, out_len)``
    of every group, in torch ops: ``keys`` ``(g, k, w)`` -> int32 ``(g,
    ceil(out_len/tile) + 1, k)`` (``out_len`` defaults to ``k*w``); row
    ``r`` of group ``i`` is ``co_rank_kway_batch`` of that boundary over
    the runs ``keys[i]`` and their ``lengths[i]`` (the run-index tie-break:
    ``cut_q(b) = |{t < len_q : rank(q, t) < b}|``, counted from every real
    element's merged rank; a row sums to ``min(b, sum(lengths[i]))``)."""
    g, k, w = keys.shape
    lengths = _run_lengths(keys, lengths)
    bounds = tile_bounds(k * w if out_len is None else out_len, tile,
                         keys.device)  # (tiles + 1,)
    pos = _wide_positions(keys, lengths).contiguous()  # rising in each run
    cuts = torch.searchsorted(
        pos, bounds.long().expand(g, k, -1).contiguous(), side="left",
        out_int32=True)
    return cuts.transpose(1, 2).contiguous()


def merge_kway_groups_wide_plain(keys, vals=None, lengths=None, *,
                                 out_len: int | None = None,
                                 tile: int = WIDE_TILE):
    """Plain version of :func:`merge_kway_groups_wide`: the kernel's
    function in torch ops.  Every tile's cuts (:func:`wide_tile_cuts`),
    then each real element's tile ``r`` (the one whose cuts bracket it in
    its run; elements past the last cut are not emitted) and its place
    there: ``r*tile`` plus its index past the tile's cut in its own run
    plus, for every other run, that run's real elements of the same tile
    before it (strict for later runs, ties for earlier ones: the lower run
    wins), as :func:`merge_tile_plain` counts inside its windows.  Output
    positions nothing lands on (those past the real total) are zero."""
    g, k, w = keys.shape
    total = k * w if out_len is None else out_len
    dev = keys.device
    lens = _run_lengths(keys, lengths).long()
    cuts = wide_tile_cuts(keys, lens, out_len=total, tile=tile).long()
    tiles = cuts.shape[1] - 1
    out_k = torch.zeros((g * total,), dtype=keys.dtype, device=dev)
    out_v = None if vals is None else torch.zeros(
        (g * total,), dtype=vals.dtype, device=dev)
    if tiles == 0:
        return out_k.reshape(g, total), (
            None if vals is None else out_v.reshape(g, total))
    t = torch.arange(w, device=dev)
    base = (torch.arange(g, device=dev) * total)[:, None]
    for q in range(k):
        own = cuts[:, :, q].contiguous()  # (g, tiles + 1)
        r = torch.searchsorted(own, t.expand(g, w).contiguous(),
                               side="right") - 1  # (g, w)
        keep = t < own[:, -1:]  # before the last cut: emitted
        r = torch.clamp(r, max=tiles - 1)
        place = t - torch.gather(own, 1, r)
        for qq in range(k):
            if qq == q:
                continue
            side = SIDE_TIES if qq < q else SIDE_STRICT
            cnt = torch.searchsorted(keys[:, qq].contiguous(),
                                     keys[:, q].contiguous(), side=side)
            cnt = torch.minimum(cnt, lens[:, qq:qq + 1])
            lo = torch.gather(cuts[:, :, qq], 1, r)
            hi = torch.gather(cuts[:, :, qq], 1, r + 1)
            place = place + torch.minimum(torch.maximum(cnt, lo), hi) - lo
        dest = (base + r * tile + place)[keep]
        out_k[dest] = keys[:, q][keep]
        if vals is not None:
            out_v[dest] = vals[:, q][keep]
    return out_k.reshape(g, total), (
        None if vals is None else out_v.reshape(g, total))


def merge_kway_groups_wide(keys, vals=None, lengths=None, *,
                           out_len: int | None = None):
    """Merge ``g`` independent groups of ``k`` sorted runs in one launch,
    for groups of any width: ``keys`` ``(g, k, w)`` -> ``(g, out_len)``
    stably merged (lower run wins ties), ``vals`` (same shape, any 4- or
    8-byte dtype) carried along.  Returns ``(keys, vals)``, ``vals``
    ``None`` without a payload.  ``1 <= k <= WIDE_MAX_RUNS``; keys of the
    k-way kernel's six dtypes.

    The ragged form: ``lengths`` int32 ``(g, k)`` real run lengths (rows
    stay sorted over their full width; the padding is never read), and
    ``out_len <= k*w`` (default ``k*w``) outputs a group: the first
    ``out_len`` ranks of its merge; positions at or past the group's real
    total are unspecified (not written).

    The wide grouped launch of ``csrc/merge_kway_tile.cu``: a CUDA block
    takes a few consecutive output tiles of ``WIDE_TILE`` elements of one
    group.  It co-ranks their boundaries across the group's runs itself (no
    phase-1 launch, no host read), then stages exactly each tile's segments
    and merges them with ``merge_kway_tile``'s merge tree.
    """
    _on_cpu(keys, vals, lengths)
    if out_len is None:
        out_len = keys.shape[1] * keys.shape[2] if keys.dim() == 3 else 0
    if _direct(keys, vals, lengths):
        return _merge_kway_groups_wide_impl(keys, vals, lengths, out_len)
    out_k, out_v = torch.ops.repro_torch.merge_kway_groups_wide(
        keys, vals, lengths, out_len)
    return out_k, (None if vals is None else out_v)


@torch.library.custom_op("repro_torch::merge_kway_groups_wide", mutates_args=())
def _merge_kway_groups_wide_op(
        keys: torch.Tensor, vals: torch.Tensor | None,
        lengths: torch.Tensor | None,
        out_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Both outputs always: the payload is empty without ``vals``."""
    out_k, out_v = _merge_kway_groups_wide_impl(keys, vals, lengths, out_len)
    return out_k, keys.new_empty((0,)) if out_v is None else out_v


@_merge_kway_groups_wide_op.register_fake
def _(keys, vals, lengths, out_len):
    g = keys.shape[0]
    return (keys.new_empty((g, out_len)),
            keys.new_empty((0,)) if vals is None else vals.new_empty((g, out_len)))


def _merge_kway_groups_wide_impl(keys, vals, lengths, out_len: int):
    op = "merge_kway_groups_wide"
    on_cpu = _on_cpu(keys, vals, lengths)
    _check(keys.dim() == 3, op, f"keys must be (g, k, w), got {tuple(keys.shape)}")
    g, k, w = keys.shape
    _check(keys.dtype in _KWAY_DTYPES, op,
           f"keys must be one of {list(_KWAY_DTYPES)}, got {keys.dtype}")
    _check(1 <= k <= WIDE_MAX_RUNS, op,
           f"k must be in [1, {WIDE_MAX_RUNS}] runs a group, got {k}")
    _check(k * w < 1 << 31, op,
           f"a group of k*w = {k}*{w} elements must be under 2^31")
    _check(0 <= out_len <= k * w, op,
           f"out_len must be in [0, k*w = {k * w}], got {out_len}")
    _check(keys.is_contiguous(), op, "keys must be contiguous")
    if vals is not None:
        _check(vals.shape == keys.shape and vals.is_contiguous()
               and vals.element_size() in (4, 8), op,
               "payload must be a contiguous 4- or 8-byte tensor shaped like keys")
    if lengths is not None:
        _check(lengths.shape == (g, k) and lengths.dtype == torch.int32
               and lengths.is_contiguous(), op,
               f"lengths must be a contiguous int32 ({g}, {k}) tensor")
    if on_cpu:
        return merge_kway_groups_wide_plain(keys, vals, lengths,
                                            out_len=out_len)
    out_k = torch.empty((g, out_len), dtype=keys.dtype, device=keys.device)
    out_v = None if vals is None else torch.empty(
        (g, out_len), dtype=vals.dtype, device=vals.device)
    if g == 0 or out_len == 0:
        return out_k, out_v
    with torch.cuda.device(keys.device):
        err = _merge_kway_groups_wide_fn()(
            _KWAY_DTYPES[keys.dtype], 0 if vals is None else vals.element_size(),
            WIDE_TILE, k, w, g, keys.data_ptr(),
            None if vals is None else vals.data_ptr(),
            None if lengths is None else lengths.data_ptr(), out_len,
            out_k.data_ptr(), None if out_v is None else out_v.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(op, err)
    merge_kway_groups_wide.launches += 1
    return out_k, out_v


merge_kway_groups_wide.launches = 0


@functools.cache
def register_dtensor_rules() -> None:
    """DTensor shardings of the four ops: ``merge_kway_groups`` and
    ``merge_kway_groups_wide`` take their groups (dim 0) sharded or
    replicated, payload alike; ``merge_tile`` and ``merge_kway_tile`` cut
    along co-ranks that span the whole input, so they replicate.  Also ``aten.detach_`` (placements kept) where the
    installed DTensor lacks it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    detach_ = torch.ops.aten.detach_.default
    if detach_ not in DTensor._op_dispatcher.sharding_propagator.op_strategy_funcs:
        # some torch releases have none, and autograd calls it on DTensors
        @register_sharding(detach_)
        def _detach(x):
            return [([p], [p]) for p in
                    [Replicate(), Partial(), *map(Shard, range(x.ndim))]]

    def _groups(keys, vals, lengths=None, out_len=None):
        """Each tensor argument replicated, or sharded on its groups."""
        rules = []
        for p in (Replicate(), Shard(0)):
            outs = [p, p if vals is not None else Replicate()]
            ins = [p, None if vals is None else p]
            if lengths is not None or out_len is not None:
                ins += [None if lengths is None else p, None]
            rules.append((outs, ins))
        return rules

    for op in (torch.ops.repro_torch.merge_kway_groups.default,
               torch.ops.repro_torch.merge_kway_groups_wide.default):
        register_sharding(op)(_groups)

    @register_sharding(torch.ops.repro_torch.merge_tile.default)
    def _tile(a, b, cuts):
        return [([Replicate()] * 3, [Replicate(), Replicate(), None])]

    @register_sharding(torch.ops.repro_torch.merge_kway_tile.default)
    def _kway(runs, cb, vals, out_len):
        pv = None if vals is None else Replicate()
        return [([Replicate(), Replicate()], [Replicate(), Replicate(), pv, None])]
