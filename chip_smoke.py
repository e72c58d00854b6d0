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
                   tail group of 3, 44 windows).

Every phase sets the kernels' launch counters to 0 just before its main
path and reads them just after; it holds each kernel's output against the
kernel's plain PyTorch version on the same inputs on the card (bit for
bit: these are permutations, no arithmetic touches the values) and
against ``torch.sort(stable=True)``.  A mismatch, a launch count of 0 or
any exception fails the run.  Times are CUDA-event medians after a
warm-up.  ``bound_ms`` is the larger of the bytes the function must move
(each input read once, each output written once) over the H100's
3.35 TB/s, and the comparisons a merge needs (``log2(k)`` per element)
over its 67 T/s of 32-bit operations outside the tensor cores.

Each timed case's line also shows ``pr11_ms``, the time of the kernels'
first design (tiles 1024 and 2048, one block per tile) for the same case,
read from the "PR 11 ms" column of ``PERF.md``'s per-shape table where it
has one; it was not measured by this run and stays out of the JSON lines.

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
        self.cases = {"merge_tile": [], "merge_kway_tile": []}
        self.launches = {"merge_tile": 0, "merge_kway_tile": 0}
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

    def reset(self) -> None:
        self.km.merge_tile.launches = 0
        self.km.merge_kway_tile.launches = 0

    def read_launches(self) -> dict:
        self.torch.cuda.synchronize()
        got = {"merge_tile": self.km.merge_tile.launches,
               "merge_kway_tile": self.km.merge_kway_tile.launches}
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
            f"merge_kway_tile launches {launched['merge_kway_tile']}; "
            f"spill phase + first window {stamps[0] - t0:.3f} s, "
            f"median window {statistics.median(gaps):.4f} s, "
            f"last window to return {secs - (stamps[-1] - t0):.3f} s")
        if bad:
            raise AssertionError(f"{what}: {bad} mismatches")

    # -- report -------------------------------------------------------------

    def kernels_line(self) -> dict:
        entries = []
        for name, source, replaces in (
            ("merge_tile", MERGE_SRC, MERGE_TPU),
            ("merge_kway_tile", KWAY_SRC, KWAY_TPU),
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
                  smoke.phase_merge_window, smoke.phase_external):
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
