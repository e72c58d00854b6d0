#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds both CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all at once), then drives the port's main path at
full data size through the entry points a user calls:

1. build         — compile the kernels, report ptxas' registers and spills;
2. merge         — ``ops.stable_merge`` of m = n = 2^27 int32 and float32
                   keys and m = n = 2^26 bfloat16 keys (``merge_tile``);
3. merge_kway    — ``ops.stable_merge_kway`` of (4, 2^24) and (16, 2^23)
                   int32 and float32 runs (``merge_kway_tile``);
4. merge_window  — ``ops.merge_window`` of an (8, 2^22) window with ragged
                   lengths (one row empty) and real dtype-max keys among the
                   dtype-max padding: int32 keys with an int32 payload, then
                   int64 keys with an int64 payload (the window
                   ``external_sort`` and ``external_argsort`` past 2^31 keys
                   launch);
5. external      — ``external_argsort`` of 2^27 duplicate-heavy int32 keys
                   (chunk 2^24, fanout 4, window 2^22: 8 runs, two merge
                   passes, 64 windows through ``merge_kway_tile``), then
                   ``external_sort`` of 11 * 2^21 int64 keys with an int64
                   payload (chunk 2^21, fanout 8, window 2^20: 11 runs, a
                   tail group of 3, 44 windows); the spill sort of one
                   chunk timed on the ``cuda`` and ``torch`` merge
                   backends (its first passes run the grouped launch);
6. serve         — the merge top-k of (16, 151936) float32 and bfloat16
                   logits (``batched_topk``, k 50, fanout 4: ten grouped
                   launches of ``merge_kway_tile``), then ``DecodeEngine``
                   on qwen3-0.6b at full width (28 layers, d 1024, vocab
                   151936, bf16, 16 slots, max_len 1024, random weights from
                   a seeded generator): 32 requests with staggered arrivals,
                   served with the ``topk`` sampler on the ``cuda`` merge
                   backend (the main path), again on ``torch`` (every token
                   stream must be equal), and with ``greedy``.

Every phase sets the kernels' launch counters to 0 just before its main
path and reads them just after; it holds each kernel's output against the
kernel's plain PyTorch version on the same inputs on the card (bit for
bit: these are permutations, no arithmetic touches the values) and
against ``torch.sort(stable=True)``.  A mismatch, a launch count of 0 or
any exception fails the run.  Times are CUDA-event medians after a
warm-up, except for the grouped launches of the top-k: a launch takes a
few microseconds, less than the host needs to issue it, so their ``ms`` is
the device time ``torch.profiler`` reports (``call_ms`` keeps the event
time of a call).  ``bound_ms`` is the larger of the bytes the function must move
(each input read once, each output written once) over the H100's
3.35 TB/s, and the comparisons a merge needs (``log2(k)`` per element)
over its 67 T/s of 32-bit operations outside the tensor cores.

Each timed case's line also shows ``pr11_ms``, the time of the kernels'
first design (tiles 1024 and 2048, one block per tile) for the same case,
read from the "PR 11 ms" column of ``PERF.md``'s per-shape table where it
has one; it was not measured by this run and stays out of the JSON lines.

The serve phase checks the top-k bit for bit: the kernel path against
the plain path and both against ``torch.sort(-(x.float() + 0.0),
stable=True)`` cut to k (``+ 0.0`` folds ``-0.0`` into ``+0.0``, which the
card's radix sort would order apart).  It reports steps, tokens per second
and the median and p90 step time with the sampler's share, from CUDA
events, and holds one bf16 decode step's logits against a float32 one of
the same weights (relative L2 error under 0.1: bf16 keeps about three
digits through 28 residual layers).

Output: one line per phase, the card's name and power limit, one
``{"kernels": [...]}`` JSON line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result, when
CUDA is not available, when the port's sources are missing, or when any
phase fails.  ``--quick`` divides every phase's element count by 64 (and
says so), for a fast check that the kernels build and agree.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
MERGE_SRC = "src/repro_torch/kernels/csrc/merge_tile.cu"
KWAY_SRC = "src/repro_torch/kernels/csrc/merge_kway_tile.cu"
MERGE_TPU = "src/repro/kernels/merge.py:57"
KWAY_TPU = "src/repro/kernels/merge.py:235"
KERNELS = ("merge_tile", "merge_kway_tile", "merge_kway_tile_groups")


def log(msg: str) -> None:
    print(msg, flush=True)


def recorded_ms(column: str) -> dict:
    """{(kernel, case): ms} from the ``column`` of PERF.md's tables whose
    first two cells are a kernel's name and a case as this script names
    it; empty when there is no such file or column."""
    try:
        lines = (ROOT / "PERF.md").read_text().splitlines()
    except OSError:
        return {}
    found, col = {}, None
    for line in lines:
        cells = [c.strip().strip("`") for c in line.strip().strip("|").split("|")]
        if not line.startswith("|"):
            col = None
        elif column in cells:
            col = cells.index(column)
        elif col is not None and col < len(cells):
            try:
                found[(cells[0], cells[1])] = float(cells[col])
            except ValueError:
                pass
    return found


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable ({exc})"


class Smoke:
    """State of one run: the device, the modules under test, the random
    generator and the per-kernel records."""

    def __init__(self, torch, quick: bool):
        from repro_torch.core.corank import co_rank_batch
        from repro_torch.core.kway import co_rank_kway_batch, merge_kway_ranked
        from repro_torch.core.mergesort import sort_key_val
        from repro_torch.external.api import external_argsort, external_sort
        from repro_torch.kernels import _build, merge as km, ops

        self.torch = torch
        self.dev = torch.device("cuda", 0)
        self.cut = 6 if quick else 0  # log2 of the element-count divisor
        self.gen = torch.Generator(device=self.dev).manual_seed(20131303)
        self.km, self.ops, self.build_mod = km, ops, _build
        self.co_rank_batch = co_rank_batch
        self.co_rank_kway_batch = co_rank_kway_batch
        self.merge_kway_ranked = merge_kway_ranked
        self.external_argsort = external_argsort
        self.external_sort = external_sort
        self.sort_key_val = sort_key_val
        self.cases = {name: [] for name in KERNELS}
        self.launches = {name: 0 for name in KERNELS}
        self.failed = []
        self.pr11_ms = recorded_ms("PR 11 ms")

    # -- helpers ------------------------------------------------------------

    def count(self, log2n: int, what: str) -> int:
        if self.cut:
            log(f"cut: {what} 2^{log2n} -> 2^{log2n - self.cut} elements (--quick)")
        return 1 << (log2n - self.cut)

    def sorted_keys(self, kind: str, shape) -> "torch.Tensor":
        """Rows sorted ascending: duplicate-heavy int32 in [0, 2^20),
        normal float32 with +-inf and +-0.0 mixed in, or integer-valued
        bfloat16 (exact)."""
        torch, g, dev = self.torch, self.gen, self.dev
        if kind == "int32":
            x = torch.randint(0, 1 << 20, shape, generator=g, device=dev,
                              dtype=torch.int32)
        elif kind == "float32":
            x = torch.randn(shape, generator=g, device=dev)
            u = torch.rand(shape, generator=g, device=dev)
            for lo, v in ((0.00, float("inf")), (0.01, float("-inf")),
                          (0.02, 0.0), (0.03, -0.0)):
                x[(u >= lo) & (u < lo + 0.01)] = v
        else:
            x = torch.randint(-250, 250, shape, generator=g, device=dev,
                              dtype=torch.int32).to(torch.bfloat16)
        return torch.sort(x, dim=-1).values

    def timed_ms(self, fn, min_reps: int = 1) -> float:
        """Median CUDA-event time of ``fn`` after one warm-up call: at
        least ``min_reps`` runs, 10 when a run takes under 0.1 s."""
        torch = self.torch
        times = []

        def once():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)

        warm = once()
        reps = max(min_reps, 10 if warm < 100 else 3 if warm < 1000 else 1)
        for _ in range(reps):
            times.append(once())
        return statistics.median(times)

    def mismatch(self, got, want):
        """(elements whose bits differ, max |got - want|) over equal shapes."""
        torch = self.torch
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(
                f"shape/dtype {tuple(got.shape)}/{got.dtype} vs "
                f"{tuple(want.shape)}/{want.dtype}"
            )
        bits = {8: torch.int64, 4: torch.int32, 2: torch.int16}[got.element_size()]
        diff = got.view(bits) != want.view(bits)
        n = int(diff.sum())
        if n == 0:
            return 0, 0.0
        d = (got[diff].double() - want[diff].double()).abs()
        return n, float(torch.nan_to_num(d, nan=float("inf")).max())

    def device_profile(self, fn):
        """Run ``fn`` once under ``torch.profiler``: ``(wall ms, device ms,
        {kernel name: (launches, device ms)})``.  The device time is the
        sum of the kernels' own times (one stream: they do not overlap);
        ``None`` when the profiler saw no device time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = {}
        for e in prof.key_averages():
            dev = getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
            if dev > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                kernels[e.key] = (e.count, dev / 1e3)
        busy = sum(ms for _, ms in kernels.values())
        return wall, (busy if busy > 0 else None), kernels

    def kernel_device_ms(self, fn, reps: int = 20):
        """Mean device time of the one CUDA kernel ``fn`` launches, over
        ``reps`` calls under the profiler (None if it saw none)."""
        def run():
            for _ in range(reps):
                fn()
        _, busy, kernels = self.device_profile(run)
        return None if busy is None else busy / max(1, sum(c for c, _ in kernels.values()))

    def reset(self) -> None:
        for name in KERNELS:
            getattr(self.km, name).launches = 0

    def read_launches(self) -> dict:
        self.torch.cuda.synchronize()
        got = {name: getattr(self.km, name).launches for name in KERNELS}
        for name, n in got.items():
            self.launches[name] += n
        return got

    def record(self, kernel: str, case: str, *, mismatches: int,
               max_abs_err: float, ms: float, plain_ms: float,
               library_ms: float, nbytes: int, ops: int, **extra) -> None:
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        row = {
            "case": case, "max_mismatch": mismatches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops, **extra,
        }
        self.cases[kernel].append(row)
        log(f"  {kernel} {case}: mismatches={mismatches} ms={ms:.4f} "
            f"pr11_ms={self.pr11_ms.get((kernel, case), 'n/a')} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"bound_ms={bound_ms:.4f} "
            + " ".join(f"{k}={v}" for k, v in extra.items()))
        if mismatches:
            raise AssertionError(f"{kernel} {case}: {mismatches} mismatches")

    # -- phases ---------------------------------------------------------------

    def phase_build(self) -> None:
        t0 = time.perf_counter()
        built = self.build_mod.build()
        secs = time.perf_counter() - t0
        log(f"phase build: {secs:.1f} s, compiled {built or 'nothing (cached)'}")
        for name in self.build_mod.SOURCES:
            lib = self.build_mod.lib_path(name)
            text = lib.with_name(lib.name + ".log").read_text(errors="replace")
            regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
            spilled, entry = [], None
            for line in text.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                entry = m.group(1) if m else entry
                m = re.search(r"(\d+) bytes spill stores", line)
                if m and int(m.group(1)):
                    spilled.append(f"{_demangle(entry)} ({m.group(1)} bytes)")
            log(f"  ptxas {name}: {len(regs)} kernels, max {max(regs, default=0)} "
                f"registers, {len(spilled)} with spill stores"
                + "".join(f"\n    spills: {s}" for s in spilled))
            self.build_mod.load(name)

    def phase_merge(self) -> None:
        torch, km, ops = self.torch, self.km, self.ops
        tile = km.MERGE_TILE
        log(f"phase merge: ops.stable_merge -> merge_tile (tile {tile})")
        for kind, log2n in (("int32", 27), ("float32", 27), ("bfloat16", 26)):
            n = self.count(log2n, f"merge {kind} m = n")
            a = self.sorted_keys(kind, (n,))
            b = self.sorted_keys(kind, (n,))
            self.reset()
            out = ops.stable_merge(a, b)
            launched = self.read_launches()["merge_tile"]
            if launched != 1:
                raise AssertionError(f"merge_tile launched {launched} times")
            bounds = km.tile_bounds(2 * n, tile, self.dev)
            cr = self.co_rank_batch(bounds, a, b)
            plain = km.merge_tile_plain(a, b, cr.j, cr.k)
            ab = torch.cat([a, b])
            lib = torch.sort(ab, stable=True).values
            mm, err = self.mismatch(out, plain)
            mm_lib, _ = self.mismatch(out, lib)
            if mm_lib:
                raise AssertionError(f"merge {kind}: {mm_lib} differ from torch.sort")
            self.record(
                "merge_tile", f"{kind} m=n=2^{log2n - self.cut}",
                mismatches=mm, max_abs_err=err,
                ms=self.timed_ms(lambda: km.merge_tile(a, b, cr.j, cr.k), 10),
                plain_ms=self.timed_ms(lambda: km.merge_tile_plain(a, b, cr.j, cr.k)),
                library_ms=self.timed_ms(lambda: torch.sort(ab, stable=True)),
                nbytes=2 * 2 * n * a.element_size(), ops=2 * n,
                entry_ms=self.timed_ms(lambda: ops.stable_merge(a, b)),
                phase1_ms=self.timed_ms(lambda: self.co_rank_batch(bounds, a, b)),
            )
            del a, b, ab, out, plain, lib, cr

    def phase_merge_kway(self) -> None:
        torch, km, ops = self.torch, self.km, self.ops
        tile = km.KWAY_TILE
        log(f"phase merge_kway: ops.stable_merge_kway -> merge_kway_tile (tile {tile})")
        for k, log2w in ((4, 24), (16, 23)):
            for kind in ("int32", "float32"):
                w = self.count(log2w, f"merge_kway k={k} {kind} w")
                runs = self.sorted_keys(kind, (k, w))
                self.reset()
                out = ops.stable_merge_kway(runs)
                launched = self.read_launches()["merge_kway_tile"]
                if launched != 1:
                    raise AssertionError(f"merge_kway_tile launched {launched} times")
                bounds = km.tile_bounds(k * w, tile, self.dev)
                cb = self.co_rank_kway_batch(bounds, runs)
                plain = km.merge_kway_tile_plain(runs, cb, out_len=k * w)
                ranked = self.merge_kway_ranked(runs)
                lib = torch.sort(runs.reshape(-1), stable=True).values
                mm, err = self.mismatch(out, plain)
                for other, label in ((ranked, "merge_kway_ranked"), (lib, "torch.sort")):
                    bad, _ = self.mismatch(out, other)
                    if bad:
                        raise AssertionError(f"merge_kway k={k} {kind}: {bad} differ from {label}")
                del ranked, lib
                self.record(
                    "merge_kway_tile", f"keys {kind} k={k} w=2^{log2w - self.cut}",
                    mismatches=mm, max_abs_err=err,
                    ms=self.timed_ms(lambda: km.merge_kway_tile(runs, cb, out_len=k * w), 10),
                    plain_ms=self.timed_ms(lambda: km.merge_kway_tile_plain(runs, cb, out_len=k * w)),
                    library_ms=self.timed_ms(lambda: torch.sort(runs.reshape(-1), stable=True)),
                    nbytes=2 * k * w * runs.element_size(),
                    ops=k * w * (k.bit_length() - 1),
                    entry_ms=self.timed_ms(lambda: ops.stable_merge_kway(runs)),
                    phase1_ms=self.timed_ms(lambda: self.co_rank_kway_batch(bounds, runs)),
                )
                del runs, out, plain, cb

    def phase_merge_window(self) -> None:
        torch = self.torch
        log(f"phase merge_window: ops.merge_window -> merge_kway_tile "
            f"(k 8, tile {self.km.KWAY_TILE})")
        self.window_case(torch.int32, torch.int32, 1 << 20)
        # Keys above the int32 range, as the external sort's int64 keys.
        self.window_case(torch.int64, torch.int64, 1 << 40)

    def window_case(self, key_dtype, val_dtype, spread: int) -> None:
        """One (8, 2^22) window: ragged lengths summing to the window with
        row 3 empty, keys in [0, spread) with real dtype-max keys among the
        dtype-max padding, and the payload numbering the real elements."""
        torch, km, ops, g, dev = self.torch, self.km, self.ops, self.gen, self.dev
        k = 8
        win = self.count(22, f"merge_window {key_dtype} window")
        kmax = torch.iinfo(key_dtype).max
        cuts = torch.sort(torch.randint(0, win + 1, (k - 2,), generator=g, device=dev)).values
        edges = torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), win)])
        lengths = torch.diff(edges)
        lengths = torch.cat([lengths[:3], lengths.new_zeros(1), lengths[3:]]).to(torch.int32)
        col = torch.arange(win, device=dev)
        real = col[None, :] < lengths[:, None]
        keys = torch.randint(0, 1 << 20, (k, win), generator=g, device=dev,
                             dtype=torch.int32).to(key_dtype) * (spread >> 20)
        keys[torch.rand((k, win), generator=g, device=dev) < 0.05] = kmax
        keys[~real] = kmax  # padding collides with the real dtype-max keys
        runs = torch.sort(keys, dim=1).values
        starts = torch.cumsum(lengths, 0) - lengths
        vals = torch.where(real, starts[:, None] + col[None, :], -1).to(val_dtype)
        total = int(lengths.sum())
        self.reset()
        mk, mv = ops.merge_window(runs, vals, lengths, out_len=win)
        launched = self.read_launches()["merge_kway_tile"]
        if launched != 1:
            raise AssertionError(f"merge_kway_tile launched {launched} times")
        bounds = km.tile_bounds(win, km.KWAY_TILE, dev)
        cb = self.co_rank_kway_batch(bounds, runs, lengths)
        pk, pv = km.merge_kway_tile_plain(runs, cb, vals=vals, out_len=win)
        rk, rv = self.merge_kway_ranked(runs, vals, lengths, out_len=win)
        flat = runs[real]
        lib = torch.sort(flat, stable=True)
        mm_k, err_k = self.mismatch(mk[:total], pk[:total])
        mm_v, err_v = self.mismatch(mv[:total], pv[:total])
        for (ok_k, ok_v), label in (((rk, rv), "merge_kway_ranked"),
                                    ((lib.values, lib.indices.to(val_dtype)), "torch.sort")):
            bad = self.mismatch(mk[:total], ok_k[:total])[0] + self.mismatch(mv[:total], ok_v[:total])[0]
            if bad:
                raise AssertionError(f"merge_window {key_dtype}: {bad} differ from {label}")
        kind = str(key_dtype).removeprefix("torch.")
        self.record(
            "merge_kway_tile", f"window payload+lengths {kind} k={k} w=2^{22 - self.cut}",
            mismatches=mm_k + mm_v, max_abs_err=max(err_k, err_v),
            ms=self.timed_ms(lambda: km.merge_kway_tile(runs, cb, vals=vals, out_len=win), 10),
            plain_ms=self.timed_ms(lambda: km.merge_kway_tile_plain(runs, cb, vals=vals, out_len=win)),
            library_ms=self.timed_ms(lambda: torch.sort(flat, stable=True)),
            nbytes=2 * total * (runs.element_size() + vals.element_size()),
            ops=total * (k.bit_length() - 1),
            entry_ms=self.timed_ms(lambda: ops.merge_window(runs, vals, lengths, out_len=win)),
            phase1_ms=self.timed_ms(lambda: self.co_rank_kway_batch(bounds, runs, lengths)),
            real_total=total, lengths=lengths.tolist(),
        )

    def phase_external(self) -> None:
        self.external_run(27, chunk_log2=24, fanout=4, window_log2=22,
                          wide=False)
        self.external_run(21, chunk_log2=21, fanout=8, window_log2=20,
                          wide=True, runs=11)

    def external_run(self, log2n: int, *, chunk_log2: int, fanout: int,
                     window_log2: int, wide: bool, runs: int = 0) -> None:
        """One out-of-core sort through the port's entry point.  Narrow:
        ``external_argsort`` of 2^log2n int32 keys.  Wide: ``external_sort``
        of ``runs`` chunks of int64 keys above the int32 range with an int64
        payload (the original positions), so that a tail group of fewer
        than ``fanout`` runs merges too."""
        import numpy as np

        torch = self.torch
        unit = self.count(log2n, f"external {'int64' if wide else 'int32'} n / {runs or 1}")
        n = unit * (runs or 1)
        chunk = 1 << (chunk_log2 - self.cut)
        window = 1 << (window_log2 - self.cut)
        keys_dev = torch.randint(0, 1 << 16, (n,), generator=self.gen,
                                 device=self.dev, dtype=torch.int32)
        if wide:
            keys_dev = (keys_dev.long() << 40) - (1 << 55)
        keys = keys_dev.cpu().numpy()
        expect_windows = _expected_windows(n, chunk, fanout, window)
        what = "external_sort int64 keys + int64 payload" if wide else "external_argsort int32 keys"
        log(f"phase external: {what} n={n} chunk={chunk} "
            f"fanout={fanout} window={window} ({expect_windows} windows)")
        stamps = []  # wall time at each durable window: the merge phase
        with tempfile.TemporaryDirectory(prefix="repro_torch_smoke_") as wd:
            self.reset()
            t0 = time.perf_counter()
            kw = dict(chunk=chunk, fanout=fanout, window=window, workdir=wd,
                      on_window=lambda *_: stamps.append(time.perf_counter()))
            if wide:
                out_k, out_v = self.external_sort(
                    keys, np.arange(n, dtype=np.int64), **kw)
                got_k = torch.from_numpy(np.array(out_k)).to(self.dev)
                got = torch.from_numpy(np.array(out_v)).to(self.dev)
                del out_k, out_v
            else:
                order = self.external_argsort(keys, **kw)
                got = torch.from_numpy(np.array(order)).to(self.dev)
                del order
            secs = time.perf_counter() - t0
        launched = self.read_launches()
        if launched["merge_kway_tile"] != expect_windows:
            raise AssertionError(
                f"merge_kway_tile launched {launched['merge_kway_tile']} "
                f"times, expected {expect_windows}")
        want = torch.sort(keys_dev, stable=True)
        bad, _ = self.mismatch(got, want.indices.to(got.dtype))
        if wide:
            bad += self.mismatch(got_k, want.values)[0]
        gaps = [b - a for a, b in zip(stamps, stamps[1:])]
        log(f"  {what}: {secs:.3f} s wall, "
            f"{n / secs / 1e6:.2f} Melem/s, {bad} mismatches vs torch.sort, "
            f"merge_kway_tile launches {launched['merge_kway_tile']}, "
            f"grouped launches (spill sort) "
            f"{launched['merge_kway_tile_groups']}; "
            f"spill phase + first window {stamps[0] - t0:.3f} s, "
            f"median window {statistics.median(gaps):.4f} s, "
            f"last window to return {secs - (stamps[-1] - t0):.3f} s")
        if bad:
            raise AssertionError(f"{what}: {bad} mismatches")
        if launched["merge_kway_tile_groups"] == 0:
            raise AssertionError(f"{what}: the spill sort made no grouped launch")
        # The spill sort of one chunk on each merge backend: its first
        # passes on the grouped launch (cuda) or in torch ops (torch).
        chunk_dev = keys_dev[:chunk].contiguous()
        if wide:
            pay = torch.arange(chunk, device=self.dev, dtype=torch.int64)
            sort = lambda: self.sort_key_val(chunk_dev, pay)  # noqa: E731
        else:
            sort = lambda: self.ops.stable_sort(chunk_dev)  # noqa: E731
        spill_ms = {}
        for backend in ("cuda", "torch", "torch", "cuda"):
            with backend_env(self.ops, backend):
                spill_ms.setdefault(backend, []).append(self.timed_ms(sort))
        log(f"  spill sort of one {chunk}-key chunk: grouped launch (cuda) "
            f"{spill_ms['cuda']} ms, torch ops {spill_ms['torch']} ms "
            f"(order cuda, torch, torch, cuda)")

    def phase_serve(self) -> None:
        self.serve_topk()
        self.serve_engine()

    def topk_logits(self, b: int, n: int):
        """(b, n) float32 logits: duplicate-heavy multiples of 1/4, with
        +-inf and +-0.0 mixed in."""
        torch, g, dev = self.torch, self.gen, self.dev
        x = torch.randint(-512, 512, (b, n), generator=g, device=dev,
                          dtype=torch.int32).float() / 4
        u = torch.rand((b, n), generator=g, device=dev)
        for lo, hi, v in ((0.000, 0.001, float("inf")),
                          (0.001, 0.011, float("-inf")),
                          (0.011, 0.021, 0.0), (0.021, 0.031, -0.0)):
            x[(u >= lo) & (u < hi)] = v
        return x

    def serve_topk(self) -> None:
        """The batched merge top-k at full vocab width: kernel path against
        plain path and the torch.sort oracle; entry, plain and torch.topk
        times; every grouped launch of one top-k timed at its shape."""
        from repro_torch.core.topk import candidate_blocks, tournament_rounds
        from repro_torch.serving.sampling import batched_topk

        torch, km, ops = self.torch, self.km, self.ops
        b, n, k, fanout = 16, 151936, 50, 4
        x32 = self.topk_logits(b, n)
        b, n = x32.shape
        block, nb = candidate_blocks(n, k)
        # log4(block) block-sort passes, then the tournament rounds
        expect = (block.bit_length() - 1 + 1) // 2 + len(tournament_rounds(nb, fanout))
        log(f"phase serve: batched_topk ({b}, {n}) k={k} fanout={fanout} "
            f"-> merge_kway_tile_groups (tile {km.KWAY_TILE}), {expect} "
            f"grouped launches per call")
        for x in (x32, x32.to(torch.bfloat16)):
            kind = str(x.dtype).removeprefix("torch.")
            self.reset()
            with backend_env(ops, "cuda"):
                vals, idx = batched_topk(x, k, fanout=fanout)
            launched = self.read_launches()["merge_kway_tile_groups"]
            with backend_env(ops, "torch"):
                pvals, pidx = batched_topk(x, k, fanout=fanout)
            order = torch.sort(-(x.float() + 0.0), dim=1, stable=True).indices[:, :k]
            bad = int((idx != pidx).sum()) + self.mismatch(vals, pvals)[0]
            bad_oracle = int((idx.long() != order).sum()) + self.mismatch(
                vals, torch.gather(x, 1, order))[0]
            with backend_env(ops, "cuda"):
                entry_ms = self.timed_ms(lambda: batched_topk(x, k, fanout=fanout), 20)
            with backend_env(ops, "torch"):
                plain_ms = self.timed_ms(lambda: batched_topk(x, k, fanout=fanout), 10)
            topk_ms = self.timed_ms(lambda: torch.topk(x, k), 20)
            log(f"  batched_topk {kind}: {launched} grouped launches, "
                f"{bad} differ from the plain path, {bad_oracle} from the "
                f"torch.sort oracle; entry_ms={entry_ms:.4f} "
                f"plain_ms={plain_ms:.4f} torch.topk_ms={topk_ms:.4f}")
            if launched != expect or bad or bad_oracle:
                raise AssertionError(f"batched_topk {kind}: {launched} launches, "
                                     f"{bad} + {bad_oracle} mismatches")

        # Every grouped launch of one float32 top-k, at its own shape.
        seen = []
        real = km.merge_kway_tile_groups

        def capture(keys, vals=None):
            seen.append((keys.clone(), None if vals is None else vals.clone()))
            return real(keys, vals)

        capture.launches = 0  # the wrapper counts on the name it is bound to
        km.merge_kway_tile_groups = capture
        try:
            with backend_env(ops, "cuda"):
                batched_topk(x32, k, fanout=fanout)
        finally:
            km.merge_kway_tile_groups = real
        # Device time of the grouped launches of one top-k, by the profiler:
        # the event times below include the host's launch of each call.
        with backend_env(ops, "cuda"):
            wall, busy, kernels = self.device_profile(
                lambda: batched_topk(x32, k, fanout=fanout))
        grouped = [(c, ms) for name, (c, ms) in kernels.items()
                   if "merge_kway_groups_kernel" in name]
        log(f"  profile of one batched_topk: wall {wall:.4f} ms, device "
            f"{'not measured' if busy is None else f'{busy:.4f} ms'}; "
            f"grouped kernels {sum(c for c, _ in grouped)} launches, "
            f"{sum(ms for _, ms in grouped):.4f} ms on the device")
        for name, (c, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]:
            log(f"    {ms:.4f} ms in {c} launches: {name[:90]}")
        for step, (keys, vals) in enumerate(seen):
            g, kk, w = keys.shape
            got = real(keys, vals)
            want = km.merge_kway_groups_plain(keys, vals)
            mm_k, err_k = self.mismatch(got[0], want[0])
            mm_v, _ = self.mismatch(got[1], want[1])
            flat = keys.reshape(g, kk * w)
            elems = g * kk * w
            # A launch takes microseconds, less than the host takes to issue
            # it: its time is the profiler's device time; the CUDA-event
            # time of a call (call_ms) measures the host too.
            call_ms = self.timed_ms(lambda: real(keys, vals), 50)
            device_ms = self.kernel_device_ms(lambda: real(keys, vals))
            self.record(
                "merge_kway_tile_groups",
                f"topk {'round' if w == k else 'block sort'} ({g},{kk},{w}) float32+int32",
                mismatches=mm_k + mm_v, max_abs_err=err_k,
                ms=call_ms if device_ms is None else device_ms,
                plain_ms=self.timed_ms(lambda: km.merge_kway_groups_plain(keys, vals), 10),
                library_ms=self.timed_ms(lambda: torch.sort(flat, dim=1, stable=True), 20),
                nbytes=2 * elems * (keys.element_size() + vals.element_size()),
                ops=elems * max(1, (kk - 1).bit_length()),
                call_ms=call_ms,
                device_ms=device_ms,
            )

    def serve_engine(self) -> None:
        """DecodeEngine on qwen3-0.6b at full width: topk on the cuda and
        torch merge backends (equal streams), then greedy."""
        import dataclasses

        import numpy as np
        from repro_torch.configs.registry import ARCHS
        from repro_torch.models import transformer as tm
        from repro_torch.serving import DecodeEngine, Request

        torch, ops = self.torch, self.ops
        cfg = ARCHS["qwen3-0.6b"]
        gen = torch.Generator(device=self.dev).manual_seed(20131303)
        params = tm.init_params(cfg, gen, device=self.dev)
        n_params = sum(t.numel() for t in _leaves(params))
        rng = np.random.default_rng(20131303)
        n_req, every = 32 >> min(self.cut, 4), 2
        reqs = [(i * every, i, rng.integers(1, cfg.vocab, int(rng.integers(32, 129)),
                                            dtype=np.int32),
                 int(rng.integers(32, 65))) for i in range(n_req)]
        log(f"phase serve: DecodeEngine {cfg.name} ({n_params / 1e9:.3f} B params, "
            f"{cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}, "
            f"{cfg.dtype}), {cfg.max_batch} slots, max_len 1024, {n_req} "
            f"requests arriving every {every} steps")

        class Timed(DecodeEngine):
            """Records CUDA events around the two device stages of a step."""

            def _decode(self, tokens, active):
                self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                self.ev[0].record()
                out = super()._decode(tokens, active)
                self.ev[1].record()
                return out

            def _sample(self, keys, logits):
                out = super()._sample(keys, logits)
                self.ev[2].record()
                self.events.append(self.ev)
                return out

        def serve(sampler: str, backend: str, reqs=reqs):
            eng = Timed(cfg, params, max_len=1024, sampler=sampler, top_k=50,
                        seed=7, device=self.dev)
            eng.events = []
            arrivals = [(t, Request(rid, prompt, new)) for t, rid, prompt, new in reqs]
            with backend_env(ops, backend):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = eng.run(arrivals=arrivals)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            eng.scheduler.check_invariants()
            eng.pool.check_invariants()
            steps = [(e0.elapsed_time(e1), e1.elapsed_time(e2)) for e0, e1, e2 in eng.events]
            return out, eng.steps, secs, steps

        serve("topk", "cuda", reqs[:2])  # warm-up: cuBLAS, allocator
        self.reset()
        got, steps, secs, times = serve("topk", "cuda")
        launched = self.read_launches()
        plain, *_ = serve("topk", "torch")
        greedy, g_steps, g_secs, g_times = serve("greedy", "cuda")
        tokens = sum(len(t) for t in got.values())
        differ = [rid for rid in got if got[rid] != plain.get(rid)]
        for label, res, st, sec, tm_ in (("topk", got, steps, secs, times),
                                         ("greedy", greedy, g_steps, g_secs, g_times)):
            step_ms = [a + b for a, b in tm_]
            q = statistics.quantiles(step_ms, n=10)
            log(f"  serve {label}: {len(res)} requests, "
                f"{sum(len(t) for t in res.values())} tokens, {st} steps, "
                f"{sec:.3f} s wall, {sum(len(t) for t in res.values()) / sec:.1f} tok/s; "
                f"step median {statistics.median(step_ms):.3f} ms, "
                f"p90 {q[-1]:.3f} ms (CUDA events: decode + sample); "
                f"sampler share {sum(b for _, b in tm_) / sum(step_ms):.3f}, "
                f"sampler median {statistics.median(b for _, b in tm_):.3f} ms")
        log(f"  serve topk main path: merge_kway_tile_groups launches "
            f"{launched['merge_kway_tile_groups']}; {len(differ)} of {len(got)} "
            f"token streams differ between the cuda and torch merge backends")
        bad_tok = [rid for res in (got, greedy) for rid, t in res.items()
                   if not all(0 <= v < cfg.vocab for v in t)]
        if launched["merge_kway_tile_groups"] == 0 or differ or bad_tok \
                or len(got) != n_req or tokens != sum(r[3] for r in reqs):
            raise AssertionError(
                f"serve: launches {launched}, streams differ {differ}, "
                f"tokens out of range {bad_tok}, {len(got)} requests served")

        # Device busy share of five steady steps with every slot decoding.
        eng = DecodeEngine(cfg, params, max_len=1024, sampler="topk", top_k=50,
                           seed=7, device=self.dev)
        for rid, (_, _, prompt, _) in enumerate(reqs[:cfg.max_batch]):
            eng.submit(Request(rid, prompt[:32], 64))
        with backend_env(ops, "cuda"):
            for _ in range(40):
                eng.step()
            wall, busy, kernels = self.device_profile(
                lambda: [eng.step() for _ in range(5)])
        launches = sum(c for c, _ in kernels.values())
        log(f"  profile of 5 decode steps ({cfg.max_batch} slots busy): wall {wall:.3f} ms, "
            f"device {'not measured' if busy is None else f'{busy:.3f} ms'}"
            + ("" if busy is None else f", busy share {busy / wall:.3f}, "
               f"idle share {1 - busy / wall:.3f}")
            + f", {launches / 5:.0f} kernel launches per step")
        for name, (c, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
            log(f"    {ms / 5:.4f} ms/step in {c // 5} launches/step: {name[:90]}")
        del eng

        # One bf16 decode step against a float32 one of the same weights.
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        b, steps_ = cfg.max_batch, 4
        toks = torch.randint(0, cfg.vocab, (steps_, b, 1), generator=self.gen,
                             device=self.dev)
        logits = {}
        for c, cache_dtype in ((cfg, torch.bfloat16), (cfg32, torch.float32)):
            p = tm.compute_params(c, params)
            cache = tm.init_cache(c, b, 1024, dtype=cache_dtype, device=self.dev)
            lengths = torch.arange(b, device=self.dev, dtype=torch.int32) * 7
            for s in range(steps_):
                out, cache = tm.decode_step_ragged(c, p, cache, toks[s], lengths)
                lengths = cache.length
            logits[c.dtype] = out
            del p, cache
        lo, hi = logits["bfloat16"], logits["float32"]
        rel = float((lo - hi).norm() / hi.norm())
        finite = bool(torch.isfinite(lo).all() and torch.isfinite(hi).all())
        log(f"  decode_step_ragged bf16 vs float32 logits ({b}, {cfg.vocab}) "
            f"after {steps_} steps: relative L2 error {rel:.5f} (limit 0.1), "
            f"finite {finite}, argmax agreement "
            f"{float((lo.argmax(1) == hi.argmax(1)).float().mean()):.3f}")
        if not finite or not rel < 0.1 or lo.shape != (b, cfg.vocab):
            raise AssertionError(f"decode logits: relative error {rel}, finite {finite}")

    # -- report -------------------------------------------------------------

    def kernels_line(self) -> dict:
        entries = []
        for name, source, replaces in (
            ("merge_tile", MERGE_SRC, MERGE_TPU),
            ("merge_kway_tile", KWAY_SRC, KWAY_TPU),
            ("merge_kway_tile_groups", KWAY_SRC, KWAY_TPU),
        ):
            cases = self.cases[name]
            head = cases[0] if cases else {}
            entries.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": self.launches[name],
                "max_abs_err": max((c["max_abs_err"] for c in cases), default=None),
                "max_mismatch": sum(c["max_mismatch"] for c in cases),
                "ms": head.get("ms"), "kernel_ms": head.get("ms"),
                "plain_ms": head.get("plain_ms"),
                "bound_ms": head.get("bound_ms"),
                "bound_by": head.get("bound_by"),
                "library_ms": head.get("library_ms"),
                "case": head.get("case"), "cases": cases,
            })
        return {"kernels": entries}


class backend_env:
    """Set the port's merge backend variable for a block, then restore it."""

    def __init__(self, ops, backend: str):
        self.var, self.backend = ops.BACKEND_ENV_VAR, backend

    def __enter__(self):
        self.old = os.environ.get(self.var)
        os.environ[self.var] = self.backend

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(self.var, None)
        else:
            os.environ[self.var] = self.old


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _demangle(symbol: str | None) -> str:
    """``symbol`` through ``c++filt`` when it is installed, else as is."""
    try:
        res = subprocess.run(["c++filt", symbol or "?"], capture_output=True,
                             text=True, timeout=30, check=True)
        return res.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol or "?"


def _expected_windows(n: int, chunk: int, fanout: int, window: int) -> int:
    """Output windows the external merge streams for these parameters."""
    runs = [min(chunk, n - lo) for lo in range(0, n, chunk)] or [0]
    windows = 0
    while len(runs) > 1:
        groups = [runs[i : i + fanout] for i in range(0, len(runs), fanout)]
        windows += sum(-(-sum(g) // window) for g in groups if len(g) > 1)
        runs = [sum(g) for g in groups]
    return windows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help="divide every phase's element count by 64")
    args = parser.parse_args()

    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("error: src/repro_torch not found beside chip_smoke.py; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("error: CUDA is not available; chip_smoke.py needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    smoke = Smoke(torch, args.quick)
    t_start = time.perf_counter()
    for phase in (smoke.phase_build, smoke.phase_merge, smoke.phase_merge_kway,
                  smoke.phase_merge_window, smoke.phase_external,
                  smoke.phase_serve):
        t0 = time.perf_counter()
        try:
            phase()
        except Exception:  # a failed phase fails the run, after the others
            traceback.print_exc()
            smoke.failed.append(phase.__name__)
        torch.cuda.empty_cache()
        log(f"  ({phase.__name__} took {time.perf_counter() - t0:.1f} s)")
    for name, n in smoke.launches.items():
        if n == 0:
            smoke.failed.append(f"{name} never launched")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if smoke.failed:
        print(f"FAILED: {smoke.failed}", file=sys.stderr)
        return 1
    log(f"card: {card}")
    log(json.dumps(smoke.kernels_line()))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
