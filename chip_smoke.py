#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds both CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all at once), then drives the port's main path at
full data size through the entry points a user calls:

1. build         — compile the kernels, report ptxas' registers and spills;
2. merge         — ``ops.stable_merge`` of m = n = 2^27 int32 and float32
                   keys and m = n = 2^26 bfloat16 keys: one ``merge_tile``
                   launch, whose blocks co-rank their own tiles (its cuts
                   held bit for bit against ``co_rank_batch``'s);
3. merge_kway    — ``ops.stable_merge_kway`` of (4, 2^24) and (16, 2^23)
                   int32 and float32 runs: one wide launch
                   (``merge_kway_groups_wide``, g = 1), beside
                   ``merge_kway_tile`` given phase-1 cuts of the same runs;
4. merge_window  — ``ops.merge_window`` of an (8, 2^22) window with ragged
                   lengths (one row empty) and real dtype-max keys among the
                   dtype-max padding: int32 keys with an int32 payload, then
                   int64 keys with an int64 payload (the window
                   ``external_sort`` and ``external_argsort`` past 2^31 keys
                   launch), each one wide launch in the ragged form; then a
                   (128, 2^20) window, past the wide launch's 64 runs:
                   phase 1 in torch ops and ``merge_kway_tile``;
5. external      — ``external_argsort`` of 2^27 duplicate-heavy int32 keys
                   (chunk 2^24, fanout 4, window 2^22: 8 runs, two merge
                   passes, 64 windows, each one wide launch), then
                   ``external_sort`` of 11 * 2^21 int64 keys with an int64
                   payload (chunk 2^21, fanout 8, window 2^20: 11 runs, a
                   tail group of 3, 44 windows); every chunk's spill sort
                   is its plan's launches exactly (``sort_plan``: a leaf on
                   the grouped launch, the passes above it on the wide
                   grouped launch), and the spill sort of one chunk is
                   timed on the ``cuda`` and ``torch`` merge backends and
                   against ``torch.sort``, each of its launches held
                   against its kernel's plain version; then
                   ``sort_key_val`` of 2^22 + 3 keys at fan-out 128 (groups
                   of 128 runs: sub-groups of 64 and their merge);
6. serve         — the merge top-k of (16, 151936) float32 and bfloat16
                   logits (``batched_topk``, k 50, fanout 4: seven grouped
                   launches, the block sort in one), then ``DecodeEngine``
                   on qwen3-0.6b at full width (28 layers, d 1024, vocab
                   151936, bf16, 16 slots, max_len 1024, random weights from
                   a seeded generator): 32 requests with staggered arrivals,
                   served with the ``topk`` sampler on the ``cuda`` merge
                   backend (the main path), again on ``torch`` (every token
                   stream must be equal), and with ``greedy``;
7. moe           — ``moe_dispatch_dropless`` of 32,768 assignments (dbrx:
                   8192 tokens x top-4 of 16 experts; deepseek-v3: 4096 x
                   top-8 of 256), uniform and one-hot-skewed, bit for bit
                   against the ``torch`` backend and ``torch.sort(stable=
                   True)``, its launches exactly the sort plan's (a leaf
                   and two wide passes), with every launch of the dispatch
                   sort
                   and of the router's top-k held against its plain
                   version; then dbrx-132b (4 layers, bf16 storage) and
                   deepseek-v3-671b (5 layers: the 3 dense ones and 2 MoE)
                   at full width, random weights: one MoE layer on 64
                   bf16 tokens (dropless against the dense reference,
                   capacity at factor E/k against dropless, relative L2
                   error at most 1e-2), dbrx served by ``DecodeEngine`` (8
                   slots, 16 requests, dropless) and deepseek-v3 by the
                   lock-step loop (batch 4, 32-token prompt, 32 new
                   tokens), each with ``topk`` on both merge backends
                   (equal streams) and ``greedy``, whose grouped launches
                   come from the MoE layers alone and must be above 0;
8. ssm           — mamba2-2.7b (64 layers, ssm cache) and zamba2-1.2b (38
                   layers, hybrid cache: a shared attention block after
                   every sixth layer) at their published widths and
                   depths, float32 storage, random weights: the lock-step
                   loop (batch 8, 32-token prompt, 32 new tokens) with
                   ``topk`` on both merge backends (equal streams) and
                   ``greedy``, the SSD kernel's launches in the ``topk``
                   run (one a layer a decode), a profile of five steady
                   steps, every grouped launch and every SSD launch of one
                   more held against its plain version (the SSD state bit
                   for bit, ``y`` within float32 summation or one bf16
                   step), the SSD kernel at the cells' 256 rows held and
                   timed the same way, the step's byte bound (bf16 weights read once,
                   the conv and SSM states read and written) beside its
                   time, eight bf16 decode steps against eight float32
                   ones (relative L2 error of the logits under 0.1, every
                   logit and SSM state finite) and, on zamba2, the launches
                   of a generate with obs off and on; then the launcher
                   ``python -m repro_torch.launch.serve --arch zamba2-1.2b
                   --metrics-dir <tmp> --profile-steps 2`` in a subprocess,
                   whose JSONL must hold ``serve.*`` and
                   ``kernels.dispatch_calls`` records with step labels and
                   whose ``<tmp>/profile`` must hold a trace;
9. train         — ``repro_torch.launch.train.main`` on granite-3-2b at its
                   published widths and depth (40 layers, d 2048, vocab
                   49155, float32 params and moments, bf16 compute, full
                   remat), random weights from a seeded generator: batch
                   8, seq 2048, one warm-up step and four timed (CUDA
                   events), every loss and gnorm finite and the first loss
                   within 5% of ln(vocab), peak memory, the grouped
                   launches a step of the length bucketing (above 0); each
                   timed step's bucket order on the ``cuda`` backend
                   against the ``torch`` backend and ``torch.sort(stable=
                   True)``; a profile of one step (launches, busy share);
                   one step with ``--external-threshold 32`` (the window
                   of 64 documents spills runs and merges them through
                   ``merge_kway_tile``: its packed batch must equal the
                   in-memory one); a restart at a cut depth (2 layers,
                   batch 2, seq 256: train to step 3, launch again to 6,
                   the step-6 checkpoint bit for bit against an
                   uninterrupted run's under deterministic algorithms,
                   and restored into the port on the CPU); then one train
                   step of dbrx (dropless and capacity), deepseek-v3,
                   mamba2 and zamba2 at smoke widths on both merge
                   backends (equal losses and router gradients, a
                   non-zero router gradient, grouped launches on the MoE
                   archs);
10. distributed  — ``repro_torch.distributed`` on 4 gloo ranks that share
                   the card (``cuda:0``; NCCL refuses two ranks on one
                   GPU), spawned after the build phase so that they
                   compile nothing: the k-way and pairwise splitters
                   against one process's co-ranks; ``sharded_sort`` of
                   2^24 keys a rank (uniform and duplicate-heavy int32, an
                   already sorted array, float32 with +-inf, +-0.0 and
                   float32 max) on the exchange and allgather strategies,
                   with the permutation through a second exchange, against
                   ``torch.sort(stable=True)``, and the sorted input at
                   half the capacity (accounted drops, zero tail);
                   ``sharded_sort_host`` of 2^26 + 3 keys;
                   ``distributed_merge`` (allgather, corank) of m = n =
                   2^25 against ``ops.stable_merge``; ``dropless_moe_ffn``
                   in dbrx-132b's and deepseek-v3-671b's MoE shapes at full
                   width (bf16, uniform and one-hot routing) against one
                   process's dropless layer, the plan on both merge
                   backends, then a truncating capacity;
                   ``compressed_psum`` within its quantisation bound; each
                   rank's times, wire bytes and launches, every launch held
                   against its plain version as it happens; then an NCCL
                   group of world size 1 (the card count) in this process.

11. dryrun       — the mesh layer and the dry-run: (a) ``python -m
                   repro_torch.launch.dryrun`` in subprocesses for one
                   ``decode_32k`` cell of every arch on the 16x16 mesh and
                   one on 2x16x16 (fake CUDA tensors on ``"fake"`` groups
                   of 256 and 512 ranks; every MoE arch's top-k and
                   dispatch sort go through the kernels' custom ops), each
                   ``ok`` or ``skipped``; the dispatcher's cost a call of
                   the grouped launch's custom op against the direct call;
                   (b) three calibration cells (granite-3-2b train at
                   batch 8, seq 2048; qwen3-0.6b decode at batch 16,
                   max_len 1024; dbrx-132b, 4 layers, bf16 storage, decode
                   at batch 8), each dry-run on a mesh of one and then run
                   for real: equal argument bytes and dot FLOPs, granite's
                   FLOPs within 5% of ``train_step_flops``, the predicted
                   peak within 15% of ``max_memory_allocated``, and the
                   real dbrx step's grouped launches held against their
                   plain version; (c) qwen3-0.6b at full width and depth
                   on a (2, 2) mesh of 4 gloo ranks sharing the card:
                   every rank's dot FLOPs and collective bytes equal a
                   fake group's prediction, the float32 logits equal one
                   process's (relative L2 at most 1e-5), a checkpoint
                   saved on (2, 2) restores on (4, 1) and whole, bit for
                   bit.

Every phase sets the kernels' launch counters to 0 just before its main
path and reads them just after; where the path sorts, the grouped
launches must be exactly what the sort plan (``core.mergesort.sort_plan``)
gives for its sizes.  A guard counts every call of the torch-ops merge
(``core.mergesort.merge_runs_plain``) on a CUDA tensor under the ``cuda``
backend, in this process and in the distributed ranks: a phase with one
fails.  A second guard counts the torch-ops phase 1 (``co_rank_batch``,
``co_rank_kway_batch``) that the kernels' wrappers run on CUDA tensors:
``merge_tile`` and the k-way merges of up to 64 runs co-rank inside the
kernel, so a phase with one fails (the k = 128 window's route is the one
that may, and is counted apart).  Each merge entry is one launch.  The
script holds each kernel's output against the
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
and ``pr20_entry_ms``, the entry's time before the kernels co-ranked their
own tiles, read from the "PR 11 ms" and "PR 20 entry ms" columns of
``PERF.md``'s per-shape table where it has them; they were not measured by
this run and stay out of the JSON lines.  A merge case also records the
kernel's device time (``device_ms``, ``torch.profiler``) and the entry's
(``entry_ms``, CUDA events).

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
import contextlib
import dataclasses
import io
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
KERNELS = ("merge_tile", "merge_kway_tile", "merge_kway_tile_groups",
           "merge_kway_groups_wide")
# The SSD decode step's kernel (kernels/ssd.py), counted and reported apart
# from the merge kernels above: only the ssm phase launches it.
SSD_SRC = "src/repro_torch/kernels/csrc/ssd_step.cu"
SSD_TPU = ("none: the reference runs the step as ssd_chunked at s = chunk "
           "= 1 in XLA ops (src/repro/models/ssm.py)")
GROUPED = ("merge_kway_tile_groups", "merge_kway_groups_wide")
# Phase moe: each model at its published widths, depth cut to fit one 80 GB
# card beside the phase's other tensors (PERF.md, section 4).
MOE_MODELS = (("dbrx-132b", {"n_layers": 4, "param_dtype": "bfloat16"}),
              ("deepseek-v3-671b", {"n_layers": 5}))
# Phase ssm: both models at their published widths and depths, float32
# storage as published (PERF.md, section 4).
SSM_MODELS = ("mamba2-2.7b", "zamba2-1.2b")
# Phase train: the reference launcher's default arch at its published widths
# and depth; batch and sequence of one 80 GB card (PERF.md, section 4).
TRAIN_ARCH = "granite-3-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 5  # one warm-up, four timed
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
# Phase train, part (d): one step of each other family at smoke width.
TRAIN_FAMILIES = (("dbrx-132b", "dropless"), ("dbrx-132b", "capacity"),
                  ("deepseek-v3-671b", None), ("mamba2-2.7b", None),
                  ("zamba2-1.2b", None))
# (name, tokens, top-k, experts, router scoring): 32,768 assignments each
MOE_DISPATCH = (("dbrx", 8192, 4, 16, "softmax"),
                ("deepseek-v3", 4096, 8, 256, "sigmoid"))


# Phase distributed: ranks of one gloo group sharing the card, keys a rank,
# m = n of the pairwise merge, and the MoE layers at full width
# (name, experts, top-k, d, ff, tokens a rank, router scoring).
DIST_RANKS = 4
DIST_KEYS_LOG2 = 24
DIST_MERGE_LOG2 = 25
DIST_MOE = (("dbrx-132b", 16, 4, 6144, 10752, 2048),
            ("deepseek-v3-671b", 256, 8, 7168, 2048, 1024))
DIST_TIMEOUT_S = 600
# Phase dryrun: (a) one cell of every arch on the 16x16 mesh and one on
# 2x16x16, fake CUDA tensors, in subprocesses; (b) calibration cells, each
# dry-run on a mesh of one and then run for real (arch, kind, seq, batch,
# config overrides); (c) one decode cell on a (2, 2) mesh of gloo ranks
# that share the card (arch, seq, batch).
DRYRUN_CELLS = [(arch, "decode_32k", False) for arch in (
    "dbrx-132b", "deepseek-67b", "deepseek-v3-671b", "granite-3-2b",
    "internvl2-26b", "mamba2-2.7b", "musicgen-medium", "qwen1.5-110b",
    "qwen3-0.6b", "zamba2-1.2b")] + [("qwen3-0.6b", "decode_32k", True)]
DRYRUN_WORKERS = 4
DRYRUN_CALIBRATION = (
    ("granite-3-2b", "train", TRAIN_SEQ, TRAIN_BATCH, {}),
    ("qwen3-0.6b", "decode", 1024, 16, {}),
    ("dbrx-132b", "decode", 1024, 8, {"n_layers": 4, "param_dtype": "bfloat16"}),
)
DRYRUN_SHARDED = ("qwen3-0.6b", 1024, 8)
DRYRUN_PEAK_TOLERANCE = 0.15  # predicted peak memory against the allocator's
DRYRUN_FLOPS_TOLERANCE = 0.05  # granite's FLOPs against train_step_flops
DRYRUN_LOGITS_L2 = 1e-5  # sharded against one process, float32


def log(msg: str) -> None:
    print(msg, flush=True)


def recorded_ms(column: str) -> dict:
    """{case: ms} from the ``column`` of PERF.md's tables whose first two
    cells are a kernel's name and a case as this script names it; empty
    when there is no such file or column."""
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
                found[cells[1]] = float(cells[col])
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


def pass_launches(g: int, k: int, w: int) -> dict:
    """Launches of each grouped kernel that ``merge_runs_ranked`` makes on
    the card for ``(g, k, w)`` groups: one grouped launch when a group fits
    its tile, one wide launch up to ``WIDE_MAX_RUNS`` runs, and past that
    the sub-groups and their merge of ``core.mergesort.merge_runs_split``."""
    from repro_torch.kernels.merge import GROUPS_TILE, WIDE_MAX_RUNS

    if k * w <= GROUPS_TILE:
        return {"merge_kway_tile_groups": 1, "merge_kway_groups_wide": 0}
    if k <= WIDE_MAX_RUNS:
        return {"merge_kway_tile_groups": 0, "merge_kway_groups_wide": 1}
    s = -(-k // WIDE_MAX_RUNS)
    p = -(-k // s)
    return add_launches(pass_launches(g * s, p, w), pass_launches(g, s, p * w))


def plan_launches(n: int, fanout: int = 0) -> dict:
    """Launches of each grouped kernel that a sort of ``n`` keys makes on
    the card: those of every pass of its plan (``core.mergesort.sort_plan``)."""
    from repro_torch.core.mergesort import sort_plan

    return add_launches(*(pass_launches(*shape) for shape in sort_plan(n, fanout)))


def add_launches(*counts) -> dict:
    return {name: sum(c.get(name, 0) for c in counts) for name in GROUPED}


def wide_launches(n: int = 1) -> dict:
    """``n`` wide launches: a merge entry or external window of up to
    ``WIDE_MAX_RUNS`` runs is one."""
    return {"merge_kway_tile_groups": 0, "merge_kway_groups_wide": n}


class PlainGuard:
    """Counts the calls of the torch-ops merge (``core.mergesort.
    merge_runs_plain``) on CUDA tensors while the merge backend resolves to
    ``cuda``: the main path must make none.  Comparisons with the plain
    versions go through ``kernels.merge``'s own names for them, and runs on
    the ``torch`` backend are not counted."""

    def __init__(self):
        from repro_torch.backend import default_backend
        from repro_torch.core import mergesort

        self.calls = 0
        real = mergesort.merge_runs_plain

        def guarded(keys, vals=None):
            if keys.is_cuda and default_backend(keys.device) == "cuda":
                self.calls += 1
            return real(keys, vals)

        mergesort.merge_runs_plain = guarded


class PhaseOneGuard:
    """Counts the calls of the torch-ops phase 1 (``co_rank_batch``,
    ``co_rank_kway_batch``) that the kernels' wrappers make on CUDA tensors:
    ``merge_tile`` and the k-way merges of up to ``WIDE_MAX_RUNS`` runs
    co-rank inside the kernel, so only the route of more runs may make
    them (``expected`` counts those; the script's own comparisons call the
    functions by their ``core`` names, which are not counted)."""

    def __init__(self, km):
        self.calls = 0
        self.allowed = False  # inside a case that takes the k > 64 route
        self.expected = 0
        for name in ("co_rank_batch", "co_rank_kway_batch"):
            real = getattr(km, name)

            def guarded(i, *args, _real=real, **kw):
                if args[0].is_cuda:
                    if self.allowed:
                        self.expected += 1
                    else:
                        self.calls += 1
                return _real(i, *args, **kw)

            setattr(km, name, guarded)


class Smoke:
    """State of one run: the device, the modules under test, the random
    generator and the per-kernel records."""

    def __init__(self, torch, quick: bool):
        from repro_torch.core.corank import co_rank_batch
        from repro_torch.core.kway import co_rank_kway_batch, merge_kway_ranked
        from repro_torch.core.mergesort import sort_key_val, sort_plan
        from repro_torch.external.api import external_argsort, external_sort
        from repro_torch.kernels import _build, merge as km, ops, ssd as kssd

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
        self.sort_plan = sort_plan
        self.kssd = kssd
        self.cases = {name: [] for name in (*KERNELS, "ssd_step")}
        self.launches = {name: 0 for name in (*KERNELS, "ssd_step")}
        self.failed = []
        self.pr11_ms = recorded_ms("PR 11 ms")
        self.parent_entry_ms = recorded_ms("PR 20 entry ms")
        self.guard = PlainGuard()
        self.phase1 = PhaseOneGuard(km)

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
        kernels, self.host_calls = {}, {}
        for e in prof.key_averages():
            dev = getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
            if getattr(e, "is_user_annotation", False):
                continue  # a span's device-side row covers kernels counted below
            if dev > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                kernels[e.key] = (e.count, dev / 1e3)
            elif e.key.startswith("cuda") and e.count:
                # the host's CUDA runtime calls: launches, copies, syncs
                self.host_calls[e.key] = (e.count, e.self_cpu_time_total / 1e3)
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
        self.kssd.ssd_step_update.launches = 0

    def read_launches(self) -> dict:
        self.torch.cuda.synchronize()
        got = {name: getattr(self.km, name).launches for name in KERNELS}
        for name, n in got.items():
            self.launches[name] += n
        return got

    def expect_launches(self, what: str, launched: dict, expect: dict) -> None:
        """Fail unless each grouped kernel launched exactly as the plan says."""
        got = {name: launched[name] for name in GROUPED}
        log(f"  {what}: grouped launches {got}, the plan's {expect}")
        if got != expect:
            raise AssertionError(f"{what}: launches {got}, the plan says {expect}")

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
            f"pr11_ms={self.pr11_ms.get(case, 'n/a')} "
            f"pr20_entry_ms={self.parent_entry_ms.get(case, 'n/a')} "
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

    def expect_one(self, name: str, what: str) -> None:
        """Fail unless the call just made launched ``name`` once and no
        other kernel."""
        got = self.read_launches()
        want = {k: int(k == name) for k in KERNELS}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")

    def phase_merge(self) -> None:
        torch, km, ops = self.torch, self.km, self.ops
        tile = km.MERGE_TILE
        log(f"phase merge: ops.stable_merge -> merge_tile (tile {tile}; the "
            f"kernel co-ranks its own tiles)")
        for kind, log2n in (("int32", 27), ("float32", 27), ("bfloat16", 26)):
            n = self.count(log2n, f"merge {kind} m = n")
            a = self.sorted_keys(kind, (n,))
            b = self.sorted_keys(kind, (n,))
            self.reset()
            out = ops.stable_merge(a, b)
            self.expect_one("merge_tile", f"merge {kind}")
            # the kernel's own cuts against phase 1 in torch ops, bit for bit
            bounds = km.tile_bounds(2 * n, tile, self.dev)
            cr = self.co_rank_batch(bounds, a, b)
            again, jb, kb = km.merge_tile(a, b, cuts=True)
            cut_mm = self.mismatch(jb, cr.j)[0] + self.mismatch(kb, cr.k)[0]
            plain = km.merge_tile_plain(a, b, cr.j, cr.k)
            ab = torch.cat([a, b])
            lib = torch.sort(ab, stable=True).values
            mm, err = self.mismatch(out, plain)
            mm += self.mismatch(again, out)[0]
            mm_lib, _ = self.mismatch(out, lib)
            if mm_lib or cut_mm:
                raise AssertionError(f"merge {kind}: {mm_lib} differ from "
                                     f"torch.sort, {cut_mm} cuts from co_rank_batch")
            self.record(
                "merge_tile", f"{kind} m=n=2^{log2n - self.cut}",
                mismatches=mm, max_abs_err=err,
                ms=self.timed_ms(lambda: km.merge_tile(a, b), 10),
                plain_ms=self.timed_ms(lambda: (
                    km.merge_tile_plain(a, b, *self.co_rank_batch(bounds, a, b)[:2]))),
                library_ms=self.timed_ms(lambda: torch.sort(ab, stable=True)),
                nbytes=2 * 2 * n * a.element_size(), ops=2 * n,
                entry_ms=self.timed_ms(lambda: ops.stable_merge(a, b)),
                device_ms=self.kernel_device_ms(lambda: km.merge_tile(a, b)),
                cut_mismatches=cut_mm, tiles=bounds.numel() - 1,
            )
            del a, b, ab, out, again, plain, lib, cr, jb, kb

    def phase_merge_kway(self) -> None:
        torch, km, ops = self.torch, self.km, self.ops
        tile = km.WIDE_TILE
        log(f"phase merge_kway: ops.stable_merge_kway -> merge_kway_groups_wide "
            f"(g = 1, tile {tile}; the kernel co-ranks its own tiles)")
        for k, log2w in ((4, 24), (16, 23)):
            for kind in ("int32", "float32"):
                w = self.count(log2w, f"merge_kway k={k} {kind} w")
                runs = self.sorted_keys(kind, (k, w))
                self.reset()
                out = ops.stable_merge_kway(runs)
                self.expect_one("merge_kway_groups_wide", f"merge_kway k={k} {kind}")
                plain = km.merge_kway_groups_wide_plain(runs[None])[0][0]
                ranked = self.merge_kway_ranked(runs)
                lib = torch.sort(runs.reshape(-1), stable=True).values
                mm, err = self.mismatch(out, plain)
                for other, label in ((ranked, "merge_kway_ranked"), (lib, "torch.sort")):
                    bad, _ = self.mismatch(out, other)
                    if bad:
                        raise AssertionError(f"merge_kway k={k} {kind}: {bad} differ from {label}")
                del ranked, lib, plain
                # the same merge by merge_kway_tile from phase-1 cuts (the
                # route of more than 64 runs): its kernel time
                cb = self.co_rank_kway_batch(km.tile_bounds(k * w, km.KWAY_TILE, self.dev), runs)
                self.record(
                    "merge_kway_groups_wide", f"keys {kind} k={k} w=2^{log2w - self.cut}",
                    mismatches=mm, max_abs_err=err,
                    ms=self.timed_ms(lambda: km.merge_kway_groups_wide(runs[None]), 10),
                    plain_ms=self.timed_ms(lambda: km.merge_kway_groups_wide_plain(runs[None])),
                    library_ms=self.timed_ms(lambda: torch.sort(runs.reshape(-1), stable=True)),
                    nbytes=2 * k * w * runs.element_size(),
                    ops=k * w * (k.bit_length() - 1),
                    entry_ms=self.timed_ms(lambda: ops.stable_merge_kway(runs)),
                    device_ms=self.kernel_device_ms(lambda: km.merge_kway_groups_wide(runs[None])),
                    given_cuts_ms=self.timed_ms(
                        lambda: km.merge_kway_tile(runs, cb, out_len=k * w), 10),
                )
                del runs, out, cb

    def phase_merge_window(self) -> None:
        torch = self.torch
        log(f"phase merge_window: ops.merge_window -> merge_kway_groups_wide "
            f"(k 8, ragged lengths) and, at k 128, phase 1 + merge_kway_tile "
            f"(tile {self.km.KWAY_TILE})")
        self.window_case(torch.int32, torch.int32, 1 << 20)
        # Keys above the int32 range, as the external sort's int64 keys.
        self.window_case(torch.int64, torch.int64, 1 << 40)
        # More runs than the wide launch takes: phase 1 in torch ops, then
        # merge_kway_tile given the cuts.
        self.window_case(torch.int32, torch.int32, 1 << 20, k=128, log2w=20)

    def window_case(self, key_dtype, val_dtype, spread: int, *, k: int = 8,
                    log2w: int = 22) -> None:
        """One (k, 2^log2w) window, as the external sort stages it: ragged
        lengths summing to the window with row 3 empty, keys in [0, spread)
        with real dtype-max keys among the dtype-max padding, and the
        payload numbering the real elements."""
        torch, km, ops, g, dev = self.torch, self.km, self.ops, self.gen, self.dev
        win = self.count(log2w, f"merge_window {key_dtype} k={k} window")
        out_len = win
        kmax = torch.iinfo(key_dtype).max
        cuts = torch.sort(torch.randint(0, win + 1, (k - 2,), generator=g,
                                        device=dev)).values
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
        wide = k <= km.WIDE_MAX_RUNS
        kernel = "merge_kway_groups_wide" if wide else "merge_kway_tile"
        self.phase1.allowed = not wide
        try:
            self.reset()
            mk, mv = ops.merge_window(runs, vals, lengths, out_len=out_len)
            self.expect_one(kernel, f"merge_window {key_dtype} k={k}")
            expected_phase1 = self.phase1.expected
            bounds = km.tile_bounds(out_len, km.KWAY_TILE, dev)
            cb = self.co_rank_kway_batch(bounds, runs, lengths)
            if wide:
                pk, pv = (x[0] for x in km.merge_kway_groups_wide_plain(
                    runs[None], vals[None], lengths[None], out_len=out_len))
                kernel_fn = lambda: km.merge_kway_groups_wide(  # noqa: E731
                    runs[None], vals[None], lengths[None], out_len=out_len)
                plain_fn = lambda: km.merge_kway_groups_wide_plain(  # noqa: E731
                    runs[None], vals[None], lengths[None], out_len=out_len)
            else:
                pk, pv = km.merge_kway_tile_plain(runs, cb, vals=vals, out_len=out_len)
                kernel_fn = lambda: km.merge_kway_tile(  # noqa: E731
                    runs, cb, vals=vals, out_len=out_len)
                plain_fn = lambda: km.merge_kway_tile_plain(  # noqa: E731
                    runs, cb, vals=vals, out_len=out_len)
            flat = runs[real]
            lib = torch.sort(flat, stable=True)
            mm_k, err_k = self.mismatch(mk[:total], pk[:total])
            mm_v, err_v = self.mismatch(mv[:total], pv[:total])
            others = [((lib.values, lib.indices.to(val_dtype)), "torch.sort")]
            if wide:  # the rank merge's k^2 searches: up to 64 runs
                others.append((self.merge_kway_ranked(runs, vals, lengths, out_len=out_len),
                               "merge_kway_ranked"))
            for (ok_k, ok_v), label in others:
                bad = self.mismatch(mk[:total], ok_k[:total])[0] + self.mismatch(mv[:total], ok_v[:total])[0]
                if bad:
                    raise AssertionError(f"merge_window {key_dtype} k={k}: {bad} differ from {label}")
            del pk, pv, others
            kind = str(key_dtype).removeprefix("torch.")
            extra = {} if wide else {"phase1_calls": expected_phase1, "phase1_ms": self.timed_ms(
                lambda: self.co_rank_kway_batch(bounds, runs, lengths))}
            self.record(
                kernel, f"window payload+lengths {kind} k={k} w=2^{log2w - self.cut}",
                mismatches=mm_k + mm_v, max_abs_err=max(err_k, err_v),
                ms=self.timed_ms(kernel_fn, 10),
                plain_ms=self.timed_ms(plain_fn),
                library_ms=self.timed_ms(lambda: torch.sort(flat, stable=True)),
                nbytes=2 * total * (runs.element_size() + vals.element_size()),
                ops=total * (k.bit_length() - 1),
                entry_ms=self.timed_ms(lambda: ops.merge_window(runs, vals, lengths, out_len=out_len)),
                device_ms=self.kernel_device_ms(kernel_fn),
                real_total=total, lengths=lengths.tolist()[:16], **extra,
            )
        finally:
            self.phase1.allowed = False
        if not wide:
            log(f"  merge_window k={k}: the route of more than {km.WIDE_MAX_RUNS} "
                f"runs ran phase 1 in torch ops {expected_phase1} time(s) a call, "
                f"as it should (not counted by the phase-1 guard)")

    def phase_external(self) -> None:
        self.external_run(27, chunk_log2=24, fanout=4, window_log2=22,
                          wide=False)
        self.external_run(21, chunk_log2=21, fanout=8, window_log2=20,
                          wide=True, runs=11)
        self.sort_fanout_128()

    def sort_fanout_128(self) -> None:
        """``sort_key_val`` of 2^22 + 3 int32 keys (real int32 max among
        them) with an int32 payload at fan-out 128: its fan-out pass merges
        groups of 128 runs of 4096, past the wide launch's 64 runs, as two
        sub-groups and their merge; launches exactly the plan's, every one
        held against its plain version, the result against ``torch.sort``."""
        torch = self.torch
        n = self.count(22, "sort fanout 128 n") + 3
        x = torch.randint(0, 1 << 20, (n,), generator=self.gen, device=self.dev,
                          dtype=torch.int32)
        x[x >= (1 << 20) - 64] = torch.iinfo(torch.int32).max
        idx = torch.arange(n, device=self.dev, dtype=torch.int32)
        plan = self.sort_plan(n, 128)
        log(f"phase external: sort_key_val at fan-out 128, n={n}, plan {plan}")
        with _CheckedKernels(torch, self.km) as ck:
            got_k, got_v = self.sort_key_val(x, idx, fanout=128)
            launched = ck.launches()
        for name, c in launched.items():
            self.launches[name] += c
        self.expect_launches("sort_key_val fanout 128", launched, plan_launches(n, 128))
        want = torch.sort(x, stable=True)
        bad = self.mismatch(got_k, want.values)[0] + self.mismatch(
            got_v, want.indices.to(torch.int32))[0]
        log(f"  sort_key_val fanout 128: {bad} differ from torch.sort; "
            f"launches held against their plain versions {ck.checked}, "
            f"mismatches {ck.mismatches}; call "
            f"{self.timed_ms(lambda: self.sort_key_val(x, idx, fanout=128)):.4f} ms, "
            f"torch.sort {self.timed_ms(lambda: torch.sort(x, stable=True)):.4f} ms")
        if bad or any(ck.mismatches.values()):
            raise AssertionError(f"sort fanout 128: {bad} differ, {ck.mismatches}")

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
        if launched["merge_kway_tile"] or launched["merge_tile"]:
            raise AssertionError(f"external: launches {launched}: every window "
                                 f"is a wide launch")
        want = torch.sort(keys_dev, stable=True)
        bad, _ = self.mismatch(got, want.indices.to(got.dtype))
        if wide:
            bad += self.mismatch(got_k, want.values)[0]
        gaps = [b - a for a, b in zip(stamps, stamps[1:])]
        log(f"  {what}: {secs:.3f} s wall, "
            f"{n / secs / 1e6:.2f} Melem/s, {bad} mismatches vs torch.sort, "
            f"wide launches (windows and spill sorts) "
            f"{launched['merge_kway_groups_wide']}, grouped launches (spill "
            f"sort) {launched['merge_kway_tile_groups']}; "
            f"spill phase + first window {stamps[0] - t0:.3f} s, "
            f"median window {statistics.median(gaps):.4f} s, "
            f"last window to return {secs - (stamps[-1] - t0):.3f} s")
        if bad:
            raise AssertionError(f"{what}: {bad} mismatches")
        # Every chunk's spill sort (its plan's leaf and wide passes) and one
        # wide launch a window.
        self.expect_launches(f"{what} spill sorts and {expect_windows} windows",
                             launched, add_launches(
            *(plan_launches(min(chunk, n - lo)) for lo in range(0, n, chunk)),
            wide_launches(expect_windows)))
        # The spill sort of one chunk on each merge backend: every pass a
        # kernel (cuda) or in torch ops (torch); torch.sort of the same keys;
        # its bound, one read and one write of the chunk's keys (and payload).
        chunk_dev = keys_dev[:chunk].contiguous()
        if wide:
            pay = torch.arange(chunk, device=self.dev, dtype=torch.int64)
            sort = lambda: self.sort_key_val(chunk_dev, pay)  # noqa: E731
            nbytes = 2 * chunk * 16
        else:
            sort = lambda: self.ops.stable_sort(chunk_dev)  # noqa: E731
            nbytes = 2 * chunk * 4
        spill_ms = {}
        for backend in ("cuda", "torch", "torch", "cuda"):
            with backend_env(self.ops, backend):
                spill_ms.setdefault(backend, []).append(self.timed_ms(sort))
        with backend_env(self.ops, "cuda"):
            _, busy, kernels = self.device_profile(sort)
        sort_ms = self.timed_ms(lambda: torch.sort(chunk_dev, stable=True))
        log(f"  spill sort of one {chunk}-key chunk ({len(self.sort_plan(chunk))} "
            f"passes): kernels (cuda) {spill_ms['cuda']} ms, torch ops "
            f"{spill_ms['torch']} ms (order cuda, torch, torch, cuda); device "
            f"{'not measured' if busy is None else f'{busy:.4f} ms'}; "
            f"torch.sort(stable=True) {sort_ms:.4f} ms; bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (one read and one write)")
        for name, (c, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:4]:
            log(f"    {ms:.4f} ms in {c} launches: {name[:90]}")
        self.record_grouped(sort, lambda g, kk, w: f"spill sort ({g},{kk},{w})")

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
        # the block sort's plan (one leaf launch when a block fits the
        # leaf), then one merge of `group` lists of k a tournament round
        expect = add_launches(plan_launches(block), *(
            {"merge_kway_tile_groups" if min(fanout, r) * k <= km.GROUPS_TILE
             else "merge_kway_groups_wide": 1}
            for r in tournament_rounds(nb, fanout)))
        log(f"phase serve: batched_topk ({b}, {n}) k={k} fanout={fanout} "
            f"-> grouped launches (tile {km.GROUPS_TILE}) {expect} per call")
        for x in (x32, x32.to(torch.bfloat16)):
            kind = str(x.dtype).removeprefix("torch.")
            self.reset()
            with backend_env(ops, "cuda"):
                vals, idx = batched_topk(x, k, fanout=fanout)
            launched = self.read_launches()
            self.expect_launches(f"batched_topk {kind}", launched, expect)
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
            log(f"  batched_topk {kind}: "
                f"{bad} differ from the plain path, {bad_oracle} from the "
                f"torch.sort oracle; entry_ms={entry_ms:.4f} "
                f"plain_ms={plain_ms:.4f} torch.topk_ms={topk_ms:.4f}")
            if bad or bad_oracle:
                raise AssertionError(f"batched_topk {kind}: {launched} launches, "
                                     f"{bad} + {bad_oracle} mismatches")

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
        # Every grouped launch of one float32 top-k, at its own shape.
        self.record_grouped(
            lambda: batched_topk(x32, k, fanout=fanout),
            lambda g, kk, w: f"topk {'round' if w == k else 'block sort'} "
                             f"({g},{kk},{w})")

    def record_grouped(self, fn, case) -> None:
        """Run ``fn`` once on the ``cuda`` backend, capturing the inputs of
        each launch of both grouped kernels it makes; then hold every launch
        against that kernel's plain version on the same inputs.  The
        launches of one kernel, shape and dtype make one record, named
        ``case(g, k, w)`` and the dtypes, with their summed mismatches
        (``checked`` launches) and the first one's device time (profiler),
        call time (events), plain time and ``torch.sort`` time of the same
        groups."""
        torch, km, ops = self.torch, self.km, self.ops
        plains = {"merge_kway_tile_groups": km.merge_kway_groups_plain,
                  "merge_kway_groups_wide": km.merge_kway_groups_wide_plain}
        real = {name: getattr(km, name) for name in GROUPED}
        seen = []

        def local(t):  # a DTensor launch's inputs are its local shards
            return t.to_local() if hasattr(t, "to_local") else t

        def capture(name):
            def launch(keys, vals=None):
                seen.append((name, local(keys).clone(),
                             None if vals is None else local(vals).clone()))
                return real[name](keys, vals)
            launch.launches = 0  # the wrapper counts on the name it is bound to
            return launch

        for name in GROUPED:
            setattr(km, name, capture(name))
        try:
            with backend_env(ops, "cuda"):
                fn()
        finally:
            for name in GROUPED:
                setattr(km, name, real[name])
        by_case = {}
        for name, keys, vals in seen:
            label = (f"{case(*keys.shape)} {str(keys.dtype)[6:]}+"
                     f"{'none' if vals is None else str(vals.dtype)[6:]}")
            by_case.setdefault((name, label), []).append((keys, vals))
        for (name, label), launches in by_case.items():
            kernel, plain = real[name], plains[name]
            mismatches, err = 0, 0.0
            for keys, vals in launches:
                got = kernel(keys, vals)
                want = plain(keys, vals)
                for x, y in zip(got, want):
                    if x is not None:
                        mm, e = self.mismatch(x, y)
                        mismatches, err = mismatches + mm, max(err, e)
            keys, vals = launches[0]
            g, kk, w = keys.shape
            flat = keys.reshape(g, kk * w)
            elems = g * kk * w
            # A launch may take microseconds, less than the host takes to
            # issue it: its time is the profiler's device time; the
            # CUDA-event time of a call (call_ms) measures the host too.
            call_ms = self.timed_ms(lambda: kernel(keys, vals), 50)
            device_ms = self.kernel_device_ms(lambda: kernel(keys, vals))
            self.record(
                name, label,
                mismatches=mismatches, max_abs_err=err,
                ms=call_ms if device_ms is None else device_ms,
                plain_ms=self.timed_ms(lambda: plain(keys, vals), 10),
                library_ms=self.timed_ms(lambda: torch.sort(flat, dim=1, stable=True), 20),
                nbytes=2 * elems * (keys.element_size()
                                    + (0 if vals is None else vals.element_size())),
                ops=elems * max(1, (kk - 1).bit_length()),
                call_ms=call_ms,
                device_ms=device_ms,
                checked=len(launches),
            )

    def serve_engine(self) -> None:
        """DecodeEngine on qwen3-0.6b at full width: topk on the cuda and
        torch merge backends (equal streams), then greedy."""
        import dataclasses

        from repro_torch.configs.registry import ARCHS
        from repro_torch.models import transformer as tm

        torch = self.torch
        cfg = ARCHS["qwen3-0.6b"]
        gen = torch.Generator(device=self.dev).manual_seed(20131303)
        params = tm.init_params(cfg, gen, device=self.dev)
        self.serve_runs(cfg, params, 32 >> min(self.cut, 4), "serve")

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

    def serve_runs(self, cfg, params, n_req: int, phase: str, *,
                   greedy_launches: bool = False) -> None:
        """``DecodeEngine`` on ``cfg``: ``n_req`` requests (prompts 32-128
        tokens, 32-64 new, one arrival every 2 steps) into
        ``cfg.max_batch`` slots of max_len 1024, served with ``topk`` on the
        ``cuda`` merge backend (the main path: its grouped launches counted)
        and on ``torch`` (every stream must be equal), then with ``greedy``
        (its launches counted too, and required when ``greedy_launches``);
        then a profile of five steady steps with every slot busy.  Any
        non-finite logit fails."""
        import numpy as np
        from repro_torch.serving import DecodeEngine, Request

        torch, ops = self.torch, self.ops
        n_params = sum(t.numel() for t in _leaves(params))
        rng = np.random.default_rng(20131303)
        every = 2
        reqs = [(i * every, i, rng.integers(1, cfg.vocab, int(rng.integers(32, 129)),
                                            dtype=np.int32),
                 int(rng.integers(32, 65))) for i in range(n_req)]
        log(f"phase {phase}: DecodeEngine {cfg.name} ({n_params / 1e9:.3f} B params, "
            f"{cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}, "
            f"{cfg.dtype}), {cfg.max_batch} slots, max_len 1024, {n_req} "
            f"requests arriving every {every} steps")

        class Timed(DecodeEngine):
            """Records CUDA events around the two device stages of a step
            and whether every logit stayed finite."""

            def _decode(self, tokens, active):
                self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                self.ev[0].record()
                out = super()._decode(tokens, active)
                self.ev[1].record()
                self.finite &= torch.isfinite(out).all()
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
            eng.finite = torch.ones((), dtype=torch.bool, device=self.dev)
            arrivals = [(t, Request(rid, prompt, new)) for t, rid, prompt, new in reqs]
            with backend_env(ops, backend):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = eng.run(arrivals=arrivals)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            eng.scheduler.check_invariants()
            eng.pool.check_invariants()
            if not bool(eng.finite):
                raise AssertionError(f"{phase} {sampler}/{backend}: non-finite logits")
            steps = [(e0.elapsed_time(e1), e1.elapsed_time(e2)) for e0, e1, e2 in eng.events]
            return out, eng.steps, secs, steps

        serve("topk", "cuda", reqs[:2])  # warm-up: cuBLAS, allocator
        self.reset()
        got, steps, secs, times = serve("topk", "cuda")
        launched = self.read_launches()
        plain, *_ = serve("topk", "torch")
        self.reset()
        greedy, g_steps, g_secs, g_times = serve("greedy", "cuda")
        g_launched = self.read_launches()
        tokens = sum(len(t) for t in got.values())
        differ = [rid for rid in got if got[rid] != plain.get(rid)]
        for label, res, st, sec, tm_ in (("topk", got, steps, secs, times),
                                         ("greedy", greedy, g_steps, g_secs, g_times)):
            log_steps(f"{phase} {label}", res, st, sec, tm_)
        log(f"  {phase} topk main path: merge_kway_tile_groups launches "
            f"{launched['merge_kway_tile_groups']}; greedy run "
            f"{g_launched['merge_kway_tile_groups']}; {len(differ)} of {len(got)} "
            f"token streams differ between the cuda and torch merge backends")
        bad_tok = [rid for res in (got, greedy) for rid, t in res.items()
                   if not all(0 <= v < cfg.vocab for v in t)]
        if launched["merge_kway_tile_groups"] == 0 or differ or bad_tok \
                or (greedy_launches and g_launched["merge_kway_tile_groups"] == 0) \
                or len(got) != n_req or tokens != sum(r[3] for r in reqs):
            raise AssertionError(
                f"{phase}: launches {launched} (greedy {g_launched}), streams "
                f"differ {differ}, tokens out of range {bad_tok}, {len(got)} "
                f"requests served")

        # Device busy share of five steady steps with every slot decoding.
        eng = DecodeEngine(cfg, params, max_len=1024, sampler="topk", top_k=50,
                           seed=7, device=self.dev)
        for rid, (_, _, prompt, _) in enumerate(reqs[:cfg.max_batch]):
            eng.submit(Request(rid, prompt[:32], 64))
        with backend_env(ops, "cuda"):
            for _ in range(40):
                eng.step()
            self.log_profile(f"{cfg.max_batch} slots busy",
                             lambda: [eng.step() for _ in range(5)])
        # Every grouped launch of one steady step, at the main path's shapes.
        self.record_grouped(eng.step,
                            lambda g, kk, w: f"{cfg.name} step ({g},{kk},{w})")
        del eng

    def log_profile(self, what: str, fn, steps: int = 5) -> None:
        """Profile ``fn`` (``steps`` decode steps): wall and device time, the
        busy share, launches a step, the top kernels and the host's CUDA
        runtime calls (device-to-host copies and syncs among them)."""
        wall, busy, kernels = self.device_profile(fn)
        launches = sum(c for c, _ in kernels.values())
        log(f"  profile of {steps} decode steps ({what}): wall {wall:.3f} ms, "
            f"device {'not measured' if busy is None else f'{busy:.3f} ms'}"
            + ("" if busy is None else f", busy share {busy / wall:.3f}, "
               f"idle share {1 - busy / wall:.3f}")
            + f", {launches / steps:.0f} kernel launches per step")
        for name, (c, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
            log(f"    {ms / steps:.4f} ms/step in {c / steps:.0f} launches/step: {name[:90]}")
        for name, (c, ms) in sorted(self.host_calls.items(), key=lambda kv: -kv[1][1])[:4]:
            log(f"    host: {ms / steps:.4f} ms/step in {c / steps:.0f} calls/step: {name[:60]}")

    # -- phase 7: the MoE family ------------------------------------------------

    def phase_moe(self) -> None:
        import gc

        self.moe_dispatch()
        for name, over in MOE_MODELS:
            self.moe_model(name, over)  # its weights are freed on return
            gc.collect()
            self.torch.cuda.empty_cache()

    def moe_dispatch(self) -> None:
        """``moe_dispatch_dropless`` on 32,768 assignments in dbrx's and
        deepseek-v3's shapes, uniform and one-hot-skewed: bit for bit
        against the ``torch`` backend and ``torch.sort(stable=True)``;
        then every grouped launch of the dispatch sort and of the router's
        top-k at those token counts, each against its plain version."""
        from repro_torch.core.mergesort import sort_plan
        from repro_torch.models.moe import moe_dispatch_dropless, route_topk

        torch, km, ops, dev = self.torch, self.km, self.ops, self.dev
        for name, t, k, n_exp, scoring in MOE_DISPATCH:
            t >>= self.cut
            n = t * k
            passes = sort_plan(n)
            expect = plan_launches(n)
            # one read and one write of every int32 key and int32 index
            bound_ms = 2 * n * 8 / HBM_BYTES_PER_S * 1e3
            for routing in ("uniform", "one-hot"):
                experts = torch.randint(0, n_exp, (t, k), generator=self.gen,
                                        device=dev, dtype=torch.int32)
                if routing == "one-hot":  # every token picks expert 3 first
                    experts[:, 0] = 3
                self.reset()
                with backend_env(ops, "cuda"):
                    got = moe_dispatch_dropless(experts, n_exp)
                launched = self.read_launches()
                self.expect_launches(f"moe dispatch {name} {routing}", launched, expect)
                with backend_env(ops, "torch"):
                    plain = moe_dispatch_dropless(experts, n_exp)
                flat = experts.reshape(-1)
                order = torch.sort(flat, stable=True)
                oracle = (order.values, order.indices.int(),
                          torch.bincount(flat.long(), minlength=n_exp).int())
                bad = sum(self.mismatch(a, b)[0] for a, b in zip(got, plain))
                bad_oracle = sum(self.mismatch(a, b)[0] for a, b in zip(got, oracle))
                with backend_env(ops, "cuda"):
                    entry_ms = self.timed_ms(lambda: moe_dispatch_dropless(experts, n_exp), 20)
                with backend_env(ops, "torch"):
                    plain_ms = self.timed_ms(lambda: moe_dispatch_dropless(experts, n_exp), 10)
                sort_ms = self.timed_ms(lambda: torch.sort(flat, stable=True), 20)
                log(f"  moe dispatch {name} ({t} tokens x top-{k} of {n_exp}, {routing}): "
                    f"{n} assignments, passes {passes}; {bad} differ from the "
                    f"torch backend, {bad_oracle} "
                    f"from torch.sort(stable=True); entry_ms={entry_ms:.4f} "
                    f"plain_ms={plain_ms:.4f} torch.sort_ms={sort_ms:.4f} "
                    f"bound_ms={bound_ms:.4f} (one read and one write)")
                if bad or bad_oracle:
                    raise AssertionError(
                        f"moe dispatch {name} {routing}: {bad} + {bad_oracle} "
                        f"mismatches")
            self.record_grouped(
                lambda: moe_dispatch_dropless(experts, n_exp),
                lambda g, kk, w, name=name: f"moe dispatch {name} ({g},{kk},{w})")
            logits = torch.randn((t, n_exp), generator=self.gen, device=dev)
            self.record_grouped(
                lambda: route_topk(logits, k, scoring=scoring),
                lambda g, kk, w, name=name: f"moe router top-{k} {name} ({g},{kk},{w})")

    def moe_model(self, name: str, over: dict) -> None:
        """One model of the MoE family at full width, depth cut to fit the
        card: a full-width MoE layer held against the dense reference, then
        the serve path its cache takes (continuous or lock-step)."""
        import dataclasses

        from repro_torch.configs.registry import ARCHS
        from repro_torch.models import transformer as tm

        torch = self.torch
        cfg = dataclasses.replace(ARCHS[name], **over)
        gen = torch.Generator(device=self.dev).manual_seed(20131303)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = tm.init_params(cfg, gen, device=self.dev)
        torch.cuda.synchronize()
        log(f"phase moe: {name} at full width, cut to {over} "
            f"({sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B params, "
            f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated, drawn in "
            f"{time.perf_counter() - t0:.1f} s)")
        self.moe_layer(cfg, params)
        if tm.cache_kind(cfg) == "gqa":
            self.serve_runs(cfg, params, 16 >> min(self.cut, 3), f"moe serve {name}",
                            greedy_launches=True)
        else:
            self.serve_lockstep(cfg, params, "moe serve")

    def moe_layer(self, cfg, params) -> None:
        """The first MoE layer's FFN on 64 bfloat16 tokens: dropless against
        the dense all-experts reference, and capacity with capacity_factor
        E/k (no drops) against dropless; relative L2 error <= 1e-2 each."""
        from repro_torch.models.moe import moe_apply, moe_dense_reference

        torch, ops = self.torch, self.ops
        layer = _index(params["layers"]["mlp"], 0)
        x = torch.randn((1, 64, cfg.d_model), generator=self.gen, device=self.dev
                        ).to(torch.bfloat16)
        kw = dict(n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
                  scoring=cfg.router_scoring)
        runs = {
            "dropless": lambda: moe_apply(layer, x, capacity_factor=cfg.capacity_factor,
                                          dispatch="dropless", **kw),
            "capacity": lambda: moe_apply(layer, x, dispatch="capacity",
                                          capacity_factor=cfg.n_experts / cfg.moe_top_k, **kw),
            "dense": lambda: moe_dense_reference(layer, x, **kw),
        }
        self.reset()
        with backend_env(ops, "cuda"):
            out = {k: fn() for k, fn in runs.items()}
            launched = self.read_launches()["merge_kway_tile_groups"]
            ms = {k: self.timed_ms(fn, 5) for k, fn in runs.items()}

        def rel(a, b):
            return float((a.float() - b.float()).norm() / b.float().norm())

        err_dense = rel(out["dropless"], out["dense"])
        err_cap = rel(out["capacity"], out["dropless"])
        finite = all(bool(torch.isfinite(v).all()) for v in out.values())
        log(f"  moe layer {cfg.name} (64 bf16 tokens, {cfg.n_experts} experts, "
            f"top-{cfg.moe_top_k} {cfg.router_scoring}"
            f"{', shared expert' if 'shared' in layer else ''}): dropless vs dense "
            f"reference rel L2 {err_dense:.2e}, capacity (factor E/k) vs dropless "
            f"{err_cap:.2e} (limit 1e-2), finite {finite}, {launched} grouped "
            f"launches; dropless {ms['dropless']:.3f} ms, capacity "
            f"{ms['capacity']:.3f} ms, dense reference {ms['dense']:.3f} ms")
        if not (err_dense <= 1e-2 and err_cap <= 1e-2 and finite and launched):
            raise AssertionError(f"moe layer {cfg.name}: errors {err_dense}, "
                                 f"{err_cap}, finite {finite}, launches {launched}")

    def serve_lockstep(self, cfg, params, phase: str, *,
                       greedy_launches: bool = True) -> None:
        """The launcher's lock-step loop (``LockstepDecoder``) on
        ``cfg.max_batch`` rows, a 32-token prompt and 32 new tokens:
        ``topk`` on the ``cuda`` and ``torch`` merge backends (every row's
        stream must be equal), then ``greedy``; both count their grouped
        launches, which must be above 0 (the greedy run's only when
        ``greedy_launches``: its MoE layers launch them).  Every logit, and
        an SSM cache's float32 state, must stay finite.  Then a profile of
        five steady steps (sample + decode) and every grouped launch of one
        more held against its plain version."""
        import numpy as np
        from repro_torch.launch.serve import LockstepDecoder
        from repro_torch.models.transformer import cache_kind
        from repro_torch.serving.sampling import request_keys

        torch, ops = self.torch, self.ops
        batch, prompt_len, n_new = cfg.max_batch, 32, 32
        prompts = np.random.default_rng(20131303).integers(
            1, cfg.vocab, (batch, prompt_len))
        log(f"phase {phase} {cfg.name}: lock-step decode ({cfg.n_layers} layers, "
            f"{cache_kind(cfg)} cache), batch {batch}, prompt {prompt_len}, "
            f"{n_new} new tokens")

        def events():
            return [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        class Timed(LockstepDecoder):
            """Records CUDA events around each decode and each sample, and
            whether every logit stayed finite."""

            def _decode(self, tokens):
                ev = events()
                ev[0].record()
                out = super()._decode(tokens)
                ev[1].record()
                self.finite &= torch.isfinite(out).all()
                self.decodes.append(ev)
                return out

            def _sample(self, keys, logits):
                ev = events()
                ev[0].record()
                out = super()._sample(keys, logits)
                ev[1].record()
                self.samples.append(ev)
                return out

        def run(sampler: str, backend: str, p=prompts, new=n_new):
            dec = Timed(cfg, params, batch=batch, max_len=p.shape[1] + new,
                        sampler=sampler, top_k=50, seed=7, device=self.dev)
            dec.decodes, dec.samples = [], []
            dec.finite = torch.ones((), dtype=torch.bool, device=self.dev)
            with backend_env(ops, backend):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = dec.generate(p, new)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            state_finite = dec.cache.kind not in ("ssm", "hybrid") or bool(
                torch.isfinite(dec.cache.data[1]).all())
            if not (bool(dec.finite) and state_finite) \
                    or int(dec.cache.length) != p.shape[1] + new:
                raise AssertionError(f"lock-step {sampler}/{backend}: finite "
                                     f"{bool(dec.finite)}, state finite {state_finite}, "
                                     f"length {int(dec.cache.length)}")
            # a generated step: its sample, then the decode of the sampled token
            times = [(d[0].elapsed_time(d[1]), s[0].elapsed_time(s[1]))
                     for d, s in zip(dec.decodes[p.shape[1]:], dec.samples)]
            return ({b: out[b].tolist() for b in range(batch)}, len(dec.decodes),
                    secs, times, dec.graph_replays)

        run("topk", "cuda", prompts[:, :2], 2)  # warm-up
        self.reset()
        # The main-path run under the profiler: a graph replay launches its
        # kernels without the Python wrappers that count launches, so the
        # SSD kernel's launches are its device records (one a graph node).
        main = []
        _, _, kernels = self.device_profile(lambda: main.append(run("topk", "cuda")))
        got, steps, secs, times, replays = main[0]
        launched = self.read_launches()["merge_kway_tile_groups"]
        ssm_layers = cfg.n_layers if cache_kind(cfg) in ("ssm", "hybrid") else 0
        ssd_launched = sum(c for name, (c, _) in kernels.items()
                           if "ssd_step_kernel" in name)
        self.launches["ssd_step"] += ssd_launched
        plain, *_ = run("topk", "torch")
        self.reset()
        greedy, g_steps, g_secs, g_times, _ = run("greedy", "cuda")
        g_launched = self.read_launches()["merge_kway_tile_groups"]
        differ = [b for b in got if got[b] != plain[b]]
        for label, res, st, sec, tm_ in (("topk", got, steps, secs, times),
                                         ("greedy", greedy, g_steps, g_secs, g_times)):
            log_steps(f"{phase} {cfg.name} lock-step {label}", res, st, sec, tm_)
        log(f"  {phase} {cfg.name} lock-step: merge_kway_tile_groups launches "
            f"{launched} (topk), {g_launched} (greedy); ssd_step launches "
            f"{ssd_launched} on the device in the topk run's {steps} decodes, "
            f"{replays} of them graph replays ({ssm_layers} a decode "
            f"expected); {len(differ)} of {batch} "
            f"token streams differ between the cuda and torch merge backends")
        bad_tok = [b for res in (got, greedy) for b, t in res.items()
                   if len(t) != n_new or not all(0 <= v < cfg.vocab for v in t)]
        # an ssm or hybrid step is captured after one eager step and replayed
        too_few = ssm_layers and replays < steps - 2
        if not launched or (greedy_launches and not g_launched) or differ or bad_tok \
                or ssd_launched != ssm_layers * steps or too_few:
            raise AssertionError(f"lock-step {cfg.name}: launches {launched}/"
                                 f"{g_launched}, ssd_step {ssd_launched}, graph "
                                 f"replays {replays} of {steps} decodes, streams "
                                 f"differ {differ}, bad rows {bad_tok}")

        # Five steady steps (sample, then decode) after the prompt, then one
        # more, its decode run eagerly, with every grouped launch and every
        # SSD launch held against its plain version.
        dec = LockstepDecoder(cfg, params, batch=batch, max_len=prompt_len + 8,
                              top_k=50, seed=7, device=self.dev)
        rows = torch.arange(batch, device=self.dev)
        with backend_env(ops, "cuda"):
            toks = torch.from_numpy(prompts).to(self.dev)
            logits = [dec._decode(toks[:, t:t + 1]) for t in range(prompt_len)][-1:]
            done = [0]

            def step(decode=dec._decode):
                keys = request_keys(7, rows, torch.full_like(rows, done[0]))
                nxt = dec._sample(keys, logits[0])
                logits[0] = decode(nxt[:, None].long())
                done[0] += 1

            self.log_profile(f"lock-step batch {batch} ({dec.graph_captures} "
                             f"graph captures)", lambda: [step() for _ in range(5)])
        with self.checked_ssd() as ssd_calls:
            self.record_grouped(lambda: step(dec._step),
                                lambda g, kk, w: f"{cfg.name} step ({g},{kk},{w})")
        if ssm_layers:
            self.record_ssd(f"{cfg.name} step", ssd_calls)
        if len(ssd_calls) != ssm_layers:
            raise AssertionError(f"lock-step {cfg.name}: a step made "
                                 f"{len(ssd_calls)} ssd_step calls, {ssm_layers} "
                                 f"expected")
        return times

    # -- the SSD decode step's kernel ---------------------------------------------

    @contextlib.contextmanager
    def checked_ssd(self):
        """While open, every launch of the SSD kernel on the decode path
        (``models.ssm.ssd_step_update``) is held against ``ssd_step`` plus
        ``copy_`` on the same inputs as it happens (:meth:`check_ssd`); the
        list it yields gathers ``(mismatches, y outside, max |y error|,
        inputs)`` a call, the inputs of the first call kept for timing."""
        from repro_torch.models import ssm

        real, calls = ssm.ssd_step_update, []

        def checked(*args):
            state = args[-1]
            keep = None if calls else tuple(t.clone() for t in args)
            y, result = self.check_ssd(real, args[:-1], state)
            calls.append((*result, keep))
            return y

        ssm.ssd_step_update = checked
        try:
            yield calls
        finally:
            ssm.ssd_step_update = real

    def check_ssd(self, kernel, args, state):
        """``kernel(*args, state)`` against ``ssd_step`` on a copy of the
        state taken before: ``(y, (state mismatches, y outside its bound,
        max |y error|))``.  The state must match bit for bit; ``y`` sums in
        another order than the plain einsum, so with float32 inputs it
        must lie within 1e-5 of the sum of its terms' magnitudes, and with
        bf16 inputs the value before the D skip must be the plain one or a
        bf16 step beside it, the skip then added as the plain path adds it
        (``tests/test_torch_kernels_cuda.py`` holds the same bounds)."""
        from repro_torch.models import ssm

        torch = self.torch
        before = state.clone()
        y = kernel(*args, state)
        want_y, want_h = ssm.ssd_step(*args, before)
        del before
        mismatches = self.mismatch(state, want_h)[0]
        x, c, d_skip = args[0], args[3], args[5]
        h = x.shape[1]
        c_heads = c.float().repeat_interleave(h // c.shape[1], dim=1)
        if x.dtype == torch.float32:
            terms = torch.einsum("bhpn,bhn->bhp", want_h.abs(), c_heads.abs())
            outside = int(((y - want_y).abs() > 1e-5 * terms).sum())
        else:
            pre = torch.einsum("bhpn,bhn->bhp", want_h, c_heads).to(x.dtype)
            skip = (d_skip[:, None] * x.float()).to(x.dtype)
            ok = torch.zeros_like(y, dtype=torch.bool)
            for y_pre in (pre, _bf16_step(torch, pre, True),
                          _bf16_step(torch, pre, False)):
                ok |= (y_pre + skip) == y
            outside = int((~ok).sum())
        err = float((y.float() - want_y.float()).abs().max()) if y.numel() else 0.0
        return y, (mismatches, outside, err)

    def record_ssd(self, case: str, calls) -> None:
        """One ``ssd_step`` record from the checked calls of
        :meth:`checked_ssd` or :meth:`ssd_cell_case`: their state
        mismatches and ``y`` outside its bound (both must be 0), the device
        time of one call on the first call's inputs (profiler) beside the
        plain ``ssd_step`` plus ``copy_`` and a device copy of the state
        (events), and the bound: the state read and written once over
        3.35 TB/s."""
        from repro_torch.models import ssm

        torch = self.torch
        args = calls[0][3]
        *inputs, state = args
        kernel = self.kssd.ssd_step_update
        other = torch.empty_like(state)
        bt, h, p = inputs[0].shape
        n = state.shape[-1]
        outside = sum(c[1] for c in calls)
        label = (f"{case} ({bt},{h},{p},{n}) g{inputs[2].shape[1]} "
                 f"{str(inputs[0].dtype)[6:]}")
        call_ms = self.timed_ms(lambda: kernel(*inputs, state), 20)
        device_ms = self.kernel_device_ms(lambda: kernel(*inputs, state))
        self.record(
            "ssd_step", label,
            mismatches=sum(c[0] for c in calls),
            max_abs_err=max(c[2] for c in calls),
            ms=call_ms if device_ms is None else device_ms,
            plain_ms=self.timed_ms(
                lambda: state.copy_(ssm.ssd_step(*inputs, state)[1]), 10),
            library_ms=self.timed_ms(lambda: other.copy_(state), 10),
            nbytes=2 * state.numel() * state.element_size(),
            ops=5 * state.numel(),  # two products, the add, C's product and sum
            call_ms=call_ms, device_ms=device_ms, checked=len(calls),
            y_outside=outside,
        )
        if outside:
            raise AssertionError(f"ssd_step {label}: {outside} values of y "
                                 f"outside their bound")

    def ssd_cell_case(self, cfg, rows: int = 256) -> None:
        """The SSD kernel at the benchmark cells' batch: one layer of
        ``cfg``'s widths at ``rows`` rows, inputs shaped as the decode step
        makes them (x, B and C strided slices of one bf16 conv output row),
        held and timed as :meth:`record_ssd` says."""
        from repro_torch.models.transformer import mamba_meta

        torch, g = self.torch, self.gen
        meta = mamba_meta(cfg)
        h, p = meta["nheads"], meta["headdim"]
        grp, n = meta["ngroups"], meta["d_state"]
        d_inner = h * p
        conv = torch.randn((rows, 1, d_inner + 2 * grp * n), generator=g,
                           device=self.dev).to(getattr(torch, cfg.dtype))
        args = (conv[..., :d_inner].reshape(rows, h, p),
                torch.nn.functional.softplus(torch.randn(
                    (rows, 1, h), generator=g, device=self.dev) - 2.0)[:, 0],
                conv[..., d_inner:d_inner + grp * n].reshape(rows, grp, n),
                conv[..., d_inner + grp * n:].reshape(rows, grp, n),
                torch.log(torch.linspace(1.0, 16.0, h, device=self.dev)),
                torch.randn((h,), generator=g, device=self.dev))
        state = torch.randn((rows, h, p, n), generator=g, device=self.dev)
        keep = tuple(t.clone() for t in (*args, state))
        _, result = self.check_ssd(self.kssd.ssd_step_update, args, state)
        self.launches["ssd_step"] += 1
        self.record_ssd(f"{cfg.name} cell", [(*result, keep)])

    # -- phase 8: the SSM and hybrid families -------------------------------------

    def phase_ssm(self) -> None:
        import gc

        for name in SSM_MODELS:
            self.ssm_model(name)  # its weights are freed on return
            gc.collect()
            self.torch.cuda.empty_cache()
        self.ssm_launcher_obs()

    def ssm_model(self, name: str) -> None:
        """One model of the SSM family at its published widths and depth,
        float32 storage as published, random weights: the SSD kernel at
        the cells' 256 rows, the launcher's lock-step loop (the SSD
        kernel's launches counted, one step's held), the step's byte bound
        beside its time, a bf16
        decode step's logits against a float32 one, and (zamba2) the
        launches a step with obs on and off."""
        import dataclasses

        from repro_torch.configs.registry import ARCHS
        from repro_torch.models import transformer as tm

        torch = self.torch
        cfg = ARCHS[name]
        gen = torch.Generator(device=self.dev).manual_seed(20131303)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = tm.init_params(cfg, gen, device=self.dev)
        torch.cuda.synchronize()
        log(f"phase ssm: {name} at full width and depth, no cut "
            f"({sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B params, "
            f"{cfg.n_layers} layers, d {cfg.d_model}, {tm.cache_kind(cfg)} cache, "
            f"{cfg.param_dtype} storage, {torch.cuda.memory_allocated() / 1e9:.1f} GB "
            f"allocated, drawn in {time.perf_counter() - t0:.1f} s)")
        self.ssd_cell_case(cfg)
        times = self.serve_lockstep(cfg, params, "ssm serve", greedy_launches=False)

        # Byte bound of a steady step at batch max_batch: the compute copy of
        # the weights read once, the conv and SSM states read and written.
        cp = tm.compute_params(cfg, params)
        cache = tm.init_cache(cfg, cfg.max_batch, 64, device=self.dev)
        weights = sum(t.numel() * t.element_size() for t in _leaves(cp))
        state = sum(t.numel() * t.element_size() for t in cache.data[:2])
        bound_ms = (weights + 2 * state) / HBM_BYTES_PER_S * 1e3
        step_ms = statistics.median(a + b for a, b in times)
        log(f"  ssm {name} step bound: {weights / 1e9:.3f} GB of weights + 2 x "
            f"{state / 1e9:.3f} GB of states = {bound_ms:.3f} ms at 3.35 TB/s; "
            f"measured step median {step_ms:.3f} ms ({bound_ms / step_ms:.3f} of "
            f"the bound's rate)")
        del cp, cache
        self.ssm_logits(cfg, params)
        if tm.cache_kind(cfg) == "hybrid":
            self.obs_launches(cfg, params)

    def ssm_logits(self, cfg, params) -> None:
        """Eight bf16 ``decode_step``s against eight float32 ones of the same
        weights and tokens: the last logits' relative L2 error under 0.1,
        every logit and the float32 SSM state finite."""
        import dataclasses

        from repro_torch.models import transformer as tm

        torch = self.torch
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        b, steps = cfg.max_batch, 8
        toks = torch.randint(0, cfg.vocab, (steps, b, 1), generator=self.gen,
                             device=self.dev)
        logits, finite = {}, True
        for c, cache_dtype in ((cfg, torch.bfloat16), (cfg32, torch.float32)):
            p = tm.compute_params(c, params)
            cache = tm.init_cache(c, b, steps, dtype=cache_dtype, device=self.dev)
            for s in range(steps):
                out, cache = tm.decode_step(c, p, cache, toks[s])
                finite &= bool(torch.isfinite(out).all())
            finite &= bool(torch.isfinite(cache.data[1]).all())
            logits[c.dtype] = out
            del p, cache
        lo, hi = logits["bfloat16"], logits["float32"]
        rel = float((lo - hi).norm() / hi.norm())
        log(f"  decode_step {cfg.name} bf16 vs float32 logits ({b}, {cfg.vocab}) "
            f"after {steps} steps: relative L2 error {rel:.5f} (limit 0.1), "
            f"finite {finite}, argmax agreement "
            f"{float((lo.argmax(1) == hi.argmax(1)).float().mean()):.3f}")
        if not finite or not rel < 0.1 or lo.shape != (b, cfg.vocab):
            raise AssertionError(f"{cfg.name} logits: relative error {rel}, "
                                 f"finite {finite}")

    def obs_launches(self, cfg, params) -> None:
        """Kernel launches of a lock-step generate (one prompt token, five
        new) with obs off and on (JSONL into a temporary directory)."""
        import numpy as np
        from repro_torch import obs
        from repro_torch.launch.serve import LockstepDecoder

        prompts = np.random.default_rng(1).integers(1, cfg.vocab, (cfg.max_batch, 1))
        counts = {}
        with backend_env(self.ops, "cuda"), tempfile.TemporaryDirectory() as tmp:
            for label in ("off", "on"):
                dec = LockstepDecoder(cfg, params, batch=cfg.max_batch, max_len=6,
                                      top_k=50, seed=7, device=self.dev)
                dec.generate(prompts, 5)  # warm-up of this decoder
                dec.cache.length.zero_()
                if label == "on":
                    obs.enable(metrics_dir=tmp)
                try:
                    _, _, kernels = self.device_profile(lambda: dec.generate(prompts, 5))
                finally:
                    obs.disable()
                counts[label] = sum(c for c, _ in kernels.values())
                del dec
        log(f"  obs {cfg.name}: a generate of 6 decodes and 5 samples launches "
            f"{counts['off']} kernels with obs off ({counts['off'] / 6:.0f} a "
            f"step), {counts['on']} with obs on ({counts['on'] / 6:.0f} a step: "
            f"a token snapshot and the flush's copy to the host a step)")

    def ssm_launcher_obs(self) -> None:
        """``python -m repro_torch.launch.serve --arch zamba2-1.2b
        --metrics-dir <tmp> --profile-steps 2`` in a subprocess on the card:
        the JSONL must hold ``serve.*`` and ``kernels.dispatch_calls``
        records with step labels, and ``<tmp>/profile`` a trace."""
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                   "zamba2-1.2b", "--metrics-dir", tmp, "--profile-steps", "2"]
            env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                                 env=env, cwd=ROOT)
            secs = time.perf_counter() - t0
            if res.returncode:
                raise AssertionError(f"launcher exited {res.returncode}:\n"
                                     f"{res.stderr[-3000:]}")
            recs = [json.loads(line) for line in
                    Path(tmp, "metrics.jsonl").read_text().splitlines()]
            serve = [r for r in recs if r["metric"].startswith("serve.") and "step" in r]
            calls = [r for r in recs if r["metric"] == "kernels.dispatch_calls"
                     and "step" in r]
            traces = sorted(Path(tmp, "profile").glob("*.pt.trace.json"))
            trace_mb = sum(t.stat().st_size for t in traces) / 1e6
            out = [line for line in res.stdout.splitlines() if "generated" in line]
            log(f"  launcher obs check: {' '.join(cmd[1:4])} ... in {secs:.1f} s: "
                f"{out[0].strip() if out else 'no result line'}; {len(recs)} records, "
                f"{len(serve)} serve.* with a step label (steps "
                f"{sorted({r['step'] for r in serve})[:3]}...), {len(calls)} "
                f"kernels.dispatch_calls with a step label, {len(traces)} trace "
                f"file(s) of {trace_mb:.1f} MB under profile/")
            if not (serve and calls and traces and out):
                raise AssertionError("launcher obs check: missing records or trace")

    # -- phase 9: training ---------------------------------------------------------

    def phase_train(self) -> None:
        import gc

        gc.collect()
        self.torch.cuda.empty_cache()
        first_loss = self.train_main()
        self.train_profile()
        self.train_attention()
        self.train_external(first_loss)
        self.train_restart()
        self.train_families()

    def train_argv(self, *extra) -> list:
        return ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
                str(TRAIN_SEQ), "--log-every", "1", *extra]

    def train_step_flops(self, cfg) -> float:
        """Operations of one train step under full remat: the layers' and
        the tied unembedding's products forward, again in the recompute and
        twice over in the backward (8 per weight per token), but each
        layer's MLP down projection, whose output the backward does not
        read, so the recompute stops before it (``torch.utils.checkpoint``'s
        early stop: 6 per weight per token); and the attention's two score
        products (no causal skip: every KV chunk is computed) four times
        over."""
        tokens = TRAIN_BATCH * TRAIN_SEQ
        layer = cfg._attn_params() + cfg._ffn_params()
        attn = 4 * TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ ** 2 * cfg.resolved_head_dim
        down = cfg.d_ff * cfg.d_model
        return (8 * tokens * (cfg.n_layers * layer + cfg.vocab * cfg.d_model)
                - 2 * tokens * cfg.n_layers * down + 4 * cfg.n_layers * attn)

    def train_main(self) -> float:
        """(a) The launcher at full width and depth; (b) each timed step's
        bucket order on both backends and against ``torch.sort``, and every
        grouped launch of one bucketing held against its plain version."""
        import math

        from repro_torch.configs.registry import ARCHS
        from repro_torch.data import pipeline
        from repro_torch.launch import train as launcher

        torch = self.torch
        cfg = ARCHS[TRAIN_ARCH]
        argv = self.train_argv("--steps", str(TRAIN_STEPS))
        log(f"phase train: repro_torch.launch.train.main({' '.join(argv)}): "
            f"{cfg.name} at full width and depth ({cfg.param_count() / 1e9:.3f} B "
            f"params, {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
            f"{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
            f"{cfg.param_dtype} params and {cfg.adam_dtype} moments, "
            f"{cfg.dtype} compute, remat {cfg.remat})")
        torch.cuda.reset_peak_memory_stats()
        self.reset()
        t0 = time.perf_counter()
        with backend_env(self.ops, "cuda"):
            res = launcher.main(argv)
        wall = time.perf_counter() - t0
        launched = self.read_launches()
        peak = torch.cuda.max_memory_allocated()
        timed = res["step_ms"][1:]
        tokens = TRAIN_BATCH * TRAIN_SEQ
        median = statistics.median(timed)
        p90 = statistics.quantiles(timed, n=10)[-1]
        flops = self.train_step_flops(cfg)
        per_step = launched["merge_kway_tile_groups"] / TRAIN_STEPS
        # one bucketing of each step's window of documents
        dc = pipeline.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                 batch=TRAIN_BATCH)
        self.expect_launches("train bucketing", launched, add_launches(*(
            plan_launches(len(pipeline.window_documents(dc, step)))
            for step in range(TRAIN_STEPS))))
        log(f"  train {cfg.name}: {TRAIN_STEPS} steps ({tokens} tokens each) in "
            f"{wall:.1f} s wall; timed steps {[round(t, 1) for t in timed]} ms, "
            f"median {median:.1f} ms, p90 {p90:.1f} ms (CUDA events), "
            f"{tokens * len(timed) / (sum(timed) / 1e3):,.0f} tokens/s; peak "
            f"memory {peak / 1e9:.2f} GB (max_memory_allocated); "
            f"merge_kway_tile_groups launches {launched['merge_kway_tile_groups']} "
            f"({per_step:.1f} a step); {flops / 1e12:.1f} TFLOP a step, bound "
            f"{flops / BF16_OPS_PER_S * 1e3:.1f} ms at 989 TFLOP/s bf16 "
            f"({flops / BF16_OPS_PER_S * 1e3 / median:.3f} of the bound's rate)")
        for i, (loss, gn, ms) in enumerate(zip(res["losses"], res["gnorms"],
                                               res["step_ms"])):
            log(f"    step {i}: loss {loss:.5f} gnorm {gn:.5f} ({ms:.1f} ms)")
        ln_v = math.log(cfg.vocab)
        finite = all(math.isfinite(x) for x in res["losses"] + res["gnorms"])
        if not (finite and abs(res["losses"][0] - ln_v) <= 0.05 * ln_v
                and per_step > 0 and len(res["losses"]) == TRAIN_STEPS):
            raise AssertionError(
                f"train: losses {res['losses']}, gnorms {res['gnorms']} (ln V "
                f"{ln_v:.4f}), grouped launches a step {per_step}")

        bad = 0
        for step in range(1, TRAIN_STEPS):
            lengths = [len(d) for d in pipeline.window_documents(dc, step)]
            orders = {}
            for backend in ("cuda", "torch"):
                with backend_env(self.ops, backend):
                    orders[backend] = pipeline.bucket_by_length(lengths,
                                                                device=self.dev)
            oracle = torch.sort(torch.tensor(lengths, device=self.dev),
                                stable=True).indices.cpu().numpy()
            bad += int((orders["cuda"] != orders["torch"]).sum()
                       + (orders["cuda"] != oracle).sum())
        log(f"  train bucket orders of the {TRAIN_STEPS - 1} timed steps "
            f"({len(lengths)} documents a window): {bad} positions differ "
            f"between the cuda backend, the torch backend and "
            f"torch.sort(stable=True)")
        if bad:
            raise AssertionError(f"train bucket orders: {bad} differ")
        self.record_grouped(
            lambda: pipeline.bucket_by_length(lengths, device=self.dev),
            lambda g, kk, w: f"train bucket ({g},{kk},{w})")
        return res["losses"][0]

    def train_profile(self) -> None:
        """One train step of the same model under ``torch.profiler`` (after
        a warm-up step): launches, device time, busy share, top kernels,
        and the grouped launches' device time."""
        from repro_torch.configs.registry import ARCHS
        from repro_torch.data import pipeline
        from repro_torch.models import transformer as tm
        from repro_torch.train.optimizer import adamw_init
        from repro_torch.train.train_step import build_train_step

        torch = self.torch
        cfg = ARCHS[TRAIN_ARCH]
        params = tm.init_params(cfg, torch.Generator(device=self.dev).manual_seed(0),
                                device=self.dev)
        opt = adamw_init(params)
        step_fn = build_train_step(cfg, total_steps=TRAIN_STEPS, warmup=10)
        stream = pipeline.batches(pipeline.DataConfig(
            vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH), device=self.dev)
        keys = ("tokens", "labels", "mask")
        with backend_env(self.ops, "cuda"):
            batch = next(stream)
            step_fn(params, opt, {k: batch[k] for k in keys}, 0)
            batch = next(stream)
            wall, busy, kernels = self.device_profile(
                lambda: float(step_fn(params, opt, {k: batch[k] for k in keys},
                                      1)[2]["loss"]))
        launches = sum(c for c, _ in kernels.values())
        log(f"  profile of one train step: wall {wall:.1f} ms, device "
            f"{'not measured' if busy is None else f'{busy:.1f} ms'}"
            + ("" if busy is None else f", busy share {busy / wall:.3f}")
            + f", {launches} kernel launches")
        for name, (c, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
            log(f"    {ms:.2f} ms in {c} launches: {name[:90]}")
        for name, (c, ms) in sorted(self.host_calls.items(), key=lambda kv: -kv[1][1])[:3]:
            log(f"    host: {ms:.2f} ms in {c} calls: {name[:60]}")

    def train_attention(self) -> None:
        """One layer's attention at the phase's shape (bf16 q (8, 2048, 32,
        64), k and v with 8 heads, causal): the port's chunked
        ``flash_attention`` forward, and forward with backward, beside
        ``F.scaled_dot_product_attention`` (a yardstick the port never
        calls); the outputs agree within bf16 rounding."""
        import torch.nn.functional as F
        from repro_torch.configs.registry import ARCHS
        from repro_torch.models.attention import flash_attention

        torch = self.torch
        cfg = ARCHS[TRAIN_ARCH]
        hd = cfg.resolved_head_dim

        def draw(heads):
            return torch.randn((TRAIN_BATCH, TRAIN_SEQ, heads, hd), generator=self.gen,
                               device=self.dev).to(torch.bfloat16).requires_grad_(True)

        q, k, v = draw(cfg.n_heads), draw(cfg.n_kv_heads), draw(cfg.n_kv_heads)
        dout = torch.randn(q.shape, generator=self.gen, device=self.dev).to(torch.bfloat16)

        def port():
            return flash_attention(q, k, v, q_chunk=min(cfg.q_chunk, TRAIN_SEQ),
                                   kv_chunk=min(cfg.kv_chunk, TRAIN_SEQ))

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True).transpose(1, 2)

        times = {}
        for name, fn in (("port", port), ("sdpa", library)):
            with torch.no_grad():
                times[name] = self.timed_ms(fn, 3)
            times[name + "_bwd"] = self.timed_ms(
                lambda: torch.autograd.grad(fn(), (q, k, v), dout), 3)
        with torch.no_grad():
            got, want = port().float(), library().float()
        rel = float((got - want).norm() / want.norm())
        log(f"  train attention of one layer ({TRAIN_BATCH}, {TRAIN_SEQ}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {hd}) bf16 causal: port "
            f"flash_attention forward {times['port']:.2f} ms, forward+backward "
            f"{times['port_bwd']:.2f} ms; scaled_dot_product_attention (yardstick) "
            f"{times['sdpa']:.2f} ms, {times['sdpa_bwd']:.2f} ms; relative L2 "
            f"difference {rel:.5f} (limit 1e-2)")
        if not rel < 1e-2:
            raise AssertionError(f"train attention: relative difference {rel}")

    def train_external(self, first_loss: float) -> None:
        """(b) The out-of-core bucketing: a window of 64 documents past
        ``--external-threshold 32`` spills two runs and merges them in
        windows through the wide launch; the packed batch equals the
        in-memory one bit for bit, and the launcher's first step on it
        gives the in-memory run's first loss."""
        from repro_torch.configs.registry import ARCHS
        from repro_torch.data import pipeline
        from repro_torch.launch import train as launcher

        cfg = ARCHS[TRAIN_ARCH]
        with tempfile.TemporaryDirectory() as tmp, backend_env(self.ops, "cuda"):
            dc = pipeline.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                     batch=TRAIN_BATCH)
            self.reset()
            ext = next(pipeline.batches(
                dataclasses.replace(dc, external_threshold=32,
                                    external_workdir=tmp), device=self.dev))
            launched = self.read_launches()
            mem = next(pipeline.batches(dc, device=self.dev))
            bad = sum(self.mismatch(ext[k], mem[k])[0]
                      for k in ("tokens", "labels", "mask"))
            res = launcher.main(self.train_argv(
                "--steps", "1", "--external-threshold", "32",
                "--external-workdir", tmp))
        log(f"  train --external-threshold 32: {launched['merge_kway_groups_wide']} "
            f"wide and {launched['merge_kway_tile_groups']} grouped "
            f"launches for one window; packed batch differs from the in-memory "
            f"one in {bad} elements; launcher step loss "
            f"{res['losses'][0]:.6f} (in-memory run {first_loss:.6f})")
        if bad or launched["merge_kway_groups_wide"] == 0 or not \
                abs(res["losses"][0] - first_loss) <= 1e-5 * first_loss:
            raise AssertionError(f"train external: {bad} differ, launches "
                                 f"{launched}, losses {res['losses']}")

    def train_restart(self) -> None:
        """(c) The launcher at a cut depth (2 layers, batch 2, seq 256,
        checkpoints every 3 steps): to step 3, again to step 6 (it must
        resume from 3), and an uninterrupted run to 6; the two step-6
        checkpoints bit for bit under deterministic algorithms; the card's
        checkpoint restored into the port on the CPU."""
        import numpy as np
        from repro_torch.checkpoint import checkpointer as ck
        from repro_torch.configs.registry import ARCHS
        from repro_torch.launch import train as launcher
        from repro_torch.models import transformer as tm
        from repro_torch.train.optimizer import adamw_init

        torch = self.torch
        full = ARCHS[TRAIN_ARCH]
        cut = dataclasses.replace(full, n_layers=2)

        def run(ckpt_dir, steps):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                launcher.main(["--arch", TRAIN_ARCH, "--batch", "2", "--seq", "256",
                               "--steps", str(steps), "--ckpt-dir", ckpt_dir,
                               "--ckpt-every", "3", "--log-every", "3"])
            return out.getvalue()

        def load(path):
            entries = json.loads(Path(path, "manifest.json").read_text())["leaves"]
            return {e["name"]: np.load(Path(path, e["file"])) for e in entries}

        with tempfile.TemporaryDirectory() as tmp, backend_env(self.ops, "cuda"):
            ARCHS[TRAIN_ARCH] = cut  # the launcher reads the registry
            torch.use_deterministic_algorithms(True)
            try:
                run(f"{tmp}/cut", 3)
                resumed = run(f"{tmp}/cut", 6)
                straight = run(f"{tmp}/straight", 6)
            finally:
                torch.use_deterministic_algorithms(False)
                ARCHS[TRAIN_ARCH] = full
            a, b = load(f"{tmp}/cut/step_00000006"), load(f"{tmp}/straight/step_00000006")
            differ = [n for n in a if a[n].tobytes() != b[n].tobytes()]
            like = {"params": tm.init_params(cut, torch.Generator().manual_seed(1),
                                             device="cpu")}
            like["opt"] = adamw_init(like["params"])
            ck.restore_checkpoint(f"{tmp}/cut", 6, like)
            on_cpu = {n: t for n, t in ck._flatten_with_paths(like)}
            cpu_differ = [n for n in a if on_cpu[n].numpy().tobytes() != a[n].tobytes()]
        ok = "resumed from step 3" in resumed and "resumed" not in straight
        log(f"  train restart ({cut.n_layers} layers, batch 2, seq 256): second "
            f"launch {'resumed from step 3' if ok else 'did NOT resume'}; step-6 "
            f"checkpoints: {len(differ)} of {len(a)} leaves differ from the "
            f"uninterrupted run's (bit for bit, deterministic algorithms); "
            f"restored on the CPU: {len(cpu_differ)} leaves differ, step "
            f"{int(like['opt'].step)}")
        if not ok or differ or cpu_differ or int(like["opt"].step) != 6:
            raise AssertionError(f"train restart: resumed {ok}, differ {differ}, "
                                 f"cpu {cpu_differ}")

    def train_families(self) -> None:
        """(d) One train step of each other family at smoke width, on the
        ``cuda`` and ``torch`` merge backends from the same weights and
        batch, under deterministic algorithms: equal losses and router
        gradients, a non-zero router gradient, grouped launches on the
        MoE archs."""
        from repro_torch.configs.registry import ARCHS, smoke_config
        from repro_torch.data import pipeline
        from repro_torch.models import transformer as tm
        from repro_torch.train.optimizer import adamw_init, adamw_update
        from repro_torch.train.train_step import loss_and_grads

        torch = self.torch
        for arch, dispatch in TRAIN_FAMILIES:
            cfg = smoke_config(ARCHS[arch])
            if dispatch:
                cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
            batch = next(pipeline.batches(pipeline.DataConfig(
                vocab=cfg.vocab, seq_len=64, batch=4, mean_doc_len=16),
                device=self.dev))
            batch = {k: batch[k] for k in ("tokens", "labels", "mask")}
            out = {}
            torch.use_deterministic_algorithms(True)
            try:
                for backend in ("cuda", "torch"):
                    params = tm.init_params(
                        cfg, torch.Generator(device=self.dev).manual_seed(0),
                        device=self.dev)
                    opt = adamw_init(params, dtype=getattr(torch, cfg.adam_dtype))
                    self.reset()
                    with backend_env(self.ops, backend):
                        loss, grads = loss_and_grads(cfg, params, batch)
                    launched = self.read_launches()["merge_kway_tile_groups"]
                    router = [lp["mlp"]["router"] for lp in grads["layers"]
                              if "router" in lp.get("mlp", {})]
                    _, _, gnorm = adamw_update(grads, opt, params, lr=1e-3)
                    out[backend] = (loss, router, gnorm, launched)
            finally:
                torch.use_deterministic_algorithms(False)
            (lc, rc, gc_, n_c), (lt, rt, gt, _) = out["cuda"], out["torch"]
            router_differ = sum(self.mismatch(a, b)[0] for a, b in zip(rc, rt))
            router_max = max((float(g.abs().max()) for g in rc), default=0.0)
            log(f"  train {cfg.name}{f' {dispatch}' if dispatch else ''} (smoke "
                f"width): loss {float(lc):.6f} (torch backend {float(lt):.6f}), "
                f"gnorm {float(gc_):.6f} ({float(gt):.6f}), {len(rc)} router "
                f"gradients, {router_differ} elements differ between the "
                f"backends, max |grad| {router_max:.3e}; grouped launches {n_c}")
            if self.mismatch(lc, lt)[0] or router_differ or \
                    self.mismatch(gc_, gt)[0] or (cfg.moe and (router_max == 0 or n_c == 0)):
                raise AssertionError(f"train {cfg.name}: backends differ or the "
                                     f"router learns nothing")

    # -- phase 10: the distributed layer ---------------------------------------

    def phase_distributed(self) -> None:
        """``repro_torch.distributed`` on DIST_RANKS gloo ranks that share
        the card (``cuda:0``; spawned after the build phase, so they load
        its libraries and compile nothing), then an NCCL group of one rank
        (the card count) in this process."""
        import multiprocessing
        import socket

        p = DIST_RANKS
        log(f"phase distributed: {p} gloo ranks share one card (cuda:0) -- "
            f"not a multi-GPU measurement; collectives staged through the "
            f"host by the port: none (gloo takes the CUDA tensors)")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        ctx = multiprocessing.get_context("spawn")
        queue = ctx.Queue()
        procs = [ctx.Process(target=distributed_rank, args=(r, p, port, self.cut, queue))
                 for r in range(p)]
        for proc in procs:
            proc.start()
        reports, deadline = {}, time.monotonic() + DIST_TIMEOUT_S
        try:
            while len(reports) < p and time.monotonic() < deadline:
                try:
                    rep = queue.get(timeout=5)
                except Exception:  # queue.Empty: see whether a rank died
                    if any(proc.exitcode not in (None, 0) for proc in procs):
                        break
                    continue
                reports[rep["rank"]] = rep
        finally:
            for proc in procs:
                proc.join(timeout=30)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        codes = [proc.exitcode for proc in procs]
        errors = {r: rep["error"] for r, rep in reports.items() if "error" in rep}
        for r, text in errors.items():
            log(f"  rank {r} failed:\n{text}")
        if len(reports) < p or errors or any(codes):
            raise AssertionError(f"distributed: reports from {sorted(reports)}, "
                                 f"exit codes {codes}")
        self.distributed_report([reports[r] for r in range(p)])
        self.nccl_world_one()

    def distributed_report(self, reps) -> None:
        """Print every case's per-rank numbers; fail on any difference, a
        compile in a rank, a missing launch or an accounting error."""
        bad = []
        compiled = [rep["compiled"] for rep in reps]
        log(f"  libraries compiled by the ranks: {compiled} (must be empty); "
            f"seconds per case (rank 0): "
            + ", ".join(f"{k} {v:.1f}" for k, v in reps[0]["seconds"].items()))
        if any(compiled):
            bad.append("a rank compiled a kernel")
        totals = {name: [0, 0, 0] for name in KERNELS}  # launches, checked, mismatches
        uses = {"sort": ("merge_kway_groups_wide", "merge_kway_tile_groups"),
                "truncation": ("merge_kway_groups_wide",),
                "sharded_sort_host": ("merge_kway_groups_wide", "merge_kway_tile_groups"),
                "merge": ("merge_tile",),
                "moe": ("merge_kway_groups_wide", "merge_kway_tile_groups")}
        plain_calls = [rep["plain_calls"] for rep in reps]
        phase1_calls = [rep["phase1_calls"] for rep in reps]
        log(f"  guard: merge_runs_plain ran {plain_calls} times on CUDA tensors "
            f"under the cuda backend in the ranks (must be 0)")
        log(f"  guard: torch-ops phase 1 ran {phase1_calls} times on CUDA "
            f"tensors in the kernels' wrappers in the ranks (must be 0)")
        if any(plain_calls):
            bad.append("merge_runs_plain ran on the card in a rank")
        if any(phase1_calls):
            bad.append("phase 1 ran in torch ops on the card in a rank")
        for case in reps[0]["cases"]:
            rows = [rep["cases"][case] for rep in reps]
            per = {key: [_rounded(row.get(key)) for row in rows] for key in rows[0]}
            text = " ".join(f"{key}={vals}" for key, vals in per.items()
                            if key not in ("launches", "checked", "mismatches", "wire",
                                           "ms", "expect"))
            if "ms" in per:
                text += f" ms(per rank; {len(rows)} gloo ranks share one card)={per['ms']}"
            if "wire" in per:
                text += f" wire bytes(per rank)={per['wire']}"
            if "launches" in per:
                text += f" launches(per rank)={per['launches']}"
                for row in rows:
                    for name in KERNELS:
                        totals[name][0] += row["launches"][name]
                        totals[name][1] += row["checked"][name]
                        totals[name][2] += row["mismatches"][name]
                    used = uses.get(case.split()[0], ())
                    if any(row["launches"][name] == 0 for name in used) or \
                            any(row["mismatches"].values()) or any(
                                row["launches"][name] != n
                                for name, n in row["expect"].items()):
                        bad.append(f"{case}: launches {row['launches']}, the "
                                   f"plan's {row['expect']}, mismatches "
                                   f"{row['mismatches']}")
            log(f"  distributed {case}: {text}")
            for row in rows:
                for key in ("differ", "perm_differ", "plan_differ", "overflow",
                            "tail_nonzero"):
                    if row.get(key):
                        bad.append(f"{case}: {key}={row[key]}")
                if "dropped" in row and not (row["dropped"] == row["expected_dropped"] > 0
                                             and row["clipped"]):
                    bad.append(f"{case}: dropped {row['dropped']}")
                if "capacity_overflow" in row and not (
                        row["capacity_overflow"] == row["capacity_planned_minus_received"]
                        and row["capacity_clipped"]):
                    bad.append(f"{case}: capacity accounting {row}")
                if "rel_l2" in row and not (row["rel_l2"] <= 1e-2 and row["finite"]):
                    bad.append(f"{case}: rel L2 {row['rel_l2']}")
                if row.get("max_err_over_bound", 0) > 1:
                    bad.append(f"{case}: error over its bound")
            if "capacity_overflow" in per and sum(per["capacity_overflow"]) == 0:
                bad.append(f"{case}: the small capacity dropped nothing")
        peaks = [max(rep["cases"][c].get("peak_gb", 0) for c in rep["cases"]) for rep in reps]
        log(f"  distributed peak memory per rank {[round(x, 2) for x in peaks]} GB, "
            f"{sum(peaks):.2f} GB for the {len(reps)} ranks (rank 0's one-process "
            f"layer: {max(reps[0]['cases'][c].get('single_peak_gb', 0) for c in reps[0]['cases']):.2f} GB); "
            f"one process's torch.sort(stable=True) of the {len(reps)} ranks' keys: "
            f"{reps[0]['torch_sort_ms']:.4f} ms")
        for name, (launched, checked, mm) in totals.items():
            log(f"  distributed {name}: {launched} launches on {len(reps)} ranks, "
                f"{checked} held against the plain version, {mm} mismatches")
            self.launches[name] += launched
            self.cases[name].append({
                "case": f"distributed phase, {len(reps)} gloo ranks on one card",
                "max_mismatch": mm, "max_abs_err": 0.0, "launches": launched,
                "checked": checked})
        if bad:
            raise AssertionError("distributed: " + "; ".join(bad[:20]))

    # -- phase 11: the mesh layer and the dry-run ----------------------------------

    def phase_dryrun(self) -> None:
        """(a) in subprocesses while (b) and (c) run here: the dry-run CLI
        for one cell of every arch; (b) calibration cells; (c) a sharded
        decode on gloo ranks sharing the card."""
        procs = self.dryrun_start()
        parts = [self.dryrun_dispatch_cost, self.dryrun_sharded]
        parts += [lambda cell=cell: self.dryrun_calibrate(*cell)
                  for cell in DRYRUN_CALIBRATION]
        parts += [lambda: self.dryrun_finish(procs)]
        failed = []
        for part in parts:  # every part runs; any failure fails the phase
            try:
                part()
            except Exception:
                traceback.print_exc()
                failed.append(traceback.format_exc(limit=1).splitlines()[-1])
        if failed:
            raise AssertionError(f"dryrun: {failed}")

    def dryrun_start(self) -> list:
        """Start ``python -m repro_torch.launch.dryrun`` for every cell of
        DRYRUN_CELLS, DRYRUN_WORKERS at a time (fake CUDA tensors: CPU only;
        the queue is drained by :meth:`dryrun_finish`)."""
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "OMP_NUM_THREADS": "1"}
        self.dryrun_out = Path(tempfile.mkdtemp(prefix="dryrun_torch_"))
        cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--multi-pod" if multi else
                 "--single-pod", "--force", "--out", str(self.dryrun_out)]
                for arch, shape, multi in DRYRUN_CELLS]
        log(f"phase dryrun: (a) {len(cmds)} cells of repro_torch.launch.dryrun "
            f"({DRYRUN_WORKERS} subprocesses at a time, fake CUDA tensors on "
            f"'fake' groups of 256 and 512 ranks) while (b) and (c) run")
        self.dryrun_queue = list(reversed(cmds))
        self.dryrun_t0 = time.perf_counter()
        return [self.dryrun_next(env) for _ in range(DRYRUN_WORKERS)]

    def dryrun_next(self, env):
        if not self.dryrun_queue:
            return None
        cmd = self.dryrun_queue.pop()
        return (cmd, time.perf_counter(), subprocess.Popen(
            cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))

    def dryrun_finish(self, procs) -> None:
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "OMP_NUM_THREADS": "1"}
        bad = []
        while any(procs):
            for i, item in enumerate(procs):
                if item is None:
                    continue
                cmd, t0, proc = item
                try:
                    text, _ = proc.communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    text, _ = proc.communicate()
                    bad.append(f"{cmd[4]} {cmd[6]}: timed out")
                if proc.returncode:
                    bad.append(f"{cmd[4]} {cmd[6]} {cmd[7]}: exit {proc.returncode}:"
                               f" {text[-1500:]}")
                procs[i] = self.dryrun_next(env)
        wall = time.perf_counter() - self.dryrun_t0
        for f in sorted(self.dryrun_out.glob("*.json")):
            rec = json.loads(f.read_text())
            if rec["status"] == "ok":
                log(f"  dryrun {f.stem}: ok trace_s {rec['trace_s']} args "
                    f"{rec['memory']['argument_size_in_bytes']} temp "
                    f"{rec['memory']['temp_size_in_bytes']} flops "
                    f"{rec['cost']['flops']:.6g} collectives "
                    f"{rec['collectives']['per_op_bytes']} repairs {rec['repairs']}")
            else:
                log(f"  dryrun {f.stem}: {rec['status']} "
                    f"{rec.get('reason') or rec.get('error')}")
                if rec["status"] != "skipped":
                    bad.append(f"{f.stem}: {rec.get('error')}\n{rec.get('trace', '')}")
        log(f"  dryrun (a): {len(DRYRUN_CELLS)} cells in {wall:.1f} s wall")
        if bad or len(list(self.dryrun_out.glob("*.json"))) != len(DRYRUN_CELLS):
            raise AssertionError(f"dryrun (a): {bad}")

    def dryrun_dispatch_cost(self) -> None:
        """The dispatcher's cost of the grouped launch's custom op: host
        time a call, direct (how real CUDA tensors call it) and through
        ``torch.ops.repro_torch.merge_kway_groups`` (fake tensors and
        DTensors), at a decode top-k shape."""
        torch, km = self.torch, self.km
        keys = self.sorted_keys("float32", (1216, 4, 32))
        vals = torch.arange(keys.numel(), dtype=torch.int32,
                            device=self.dev).reshape(keys.shape)
        us = {}
        for name, fn in (("direct", lambda: km.merge_kway_tile_groups(keys, vals)),
                         ("custom op", lambda: torch.ops.repro_torch.merge_kway_groups(
                             keys, vals))):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            us[name] = ((t1 - t0) / 2000 * 1e6, (time.perf_counter() - t0) / 2000 * 1e6)
        got = torch.ops.repro_torch.merge_kway_groups(keys, vals)
        want = km.merge_kway_groups_plain(keys, vals)
        mm = self.mismatch(got[0], want[0])[0] + self.mismatch(got[1], want[1])[0]
        log("  dryrun dispatcher: merge_kway_groups (1216, 4, 32) float32+int32 "
            + ", ".join(f"{k} {h:.2f} us host / {w:.2f} us wall a call"
                        for k, (h, w) in us.items())
            + f"; the op's result against the plain version: {mm} mismatches")
        if mm:
            raise AssertionError(f"dryrun dispatcher: {mm} mismatches")

    def dryrun_calibrate(self, arch, kind, seq, batch, over) -> None:
        """(b) The dry-run of one cell on a mesh of one (a ``"fake"`` group
        of 1, fake CUDA tensors), then the same step for real on the card,
        on a mesh of one of an NCCL group of one rank: equal argument bytes
        and dot FLOPs, and the predicted peak within
        DRYRUN_PEAK_TOLERANCE of ``max_memory_allocated``."""
        import datetime
        import gc
        import socket

        import torch.distributed as dist
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro_torch.configs.base import ShapeConfig
        from repro_torch.kernels.merge import register_dtensor_rules
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.hlo_stats import TraceStats
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.sharding import Partitioner
        from repro_torch.models import layers as L

        torch = self.torch
        shape = ShapeConfig(f"{kind}_calibration", seq, batch, kind)
        D.SHAPES[shape.name] = shape
        D.fake_process_group(1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            fake = FakeTensorMode()
            _, cfg, fn, args = D.build_cell(arch, shape.name, False, over,
                                            device="cuda", fake_mode=fake, mesh=mesh)
            pred_args = D.local_bytes(args)
            stats, part, peak, trace_s = D.trace_cell(mesh, fn, args, fake,
                                                      by_op=True)
        finally:
            L.set_batch_axes(None)
            dist.destroy_process_group()
        del args
        gc.collect()
        torch.cuda.empty_cache()
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300))
        try:
            register_dtensor_rules()
            mesh = make_mesh((1, 1), ("data", "model"))
            real = D.place_cell(cfg, shape, mesh,
                                D.real_inputs(cfg, shape, device=self.dev, seed=0))
            real_args = D.local_bytes(real)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counted = TraceStats(by_op=True)
            self.reset()
            t0 = time.perf_counter()
            with counted, Partitioner(counted):
                fn(*real)
            torch.cuda.synchronize()
            real_s = time.perf_counter() - t0
            launched = self.read_launches()
            real_peak = torch.cuda.max_memory_allocated()
            if cfg.moe:  # every grouped launch of the step against the plain one
                def again():
                    with Partitioner():
                        fn(*real)
                self.record_grouped(again, lambda g, kk, w: (
                    f"dryrun {arch} decode step ({g},{kk},{w})"))
        finally:
            L.set_batch_axes(None)
            dist.destroy_process_group()
        pred_peak = max(peak, pred_args)
        line = (f"  dryrun calibrate {arch} {kind} (batch {batch}, seq {seq}"
                f"{', ' + str(over) if over else ''}): arguments predicted "
                f"{pred_args} real {real_args}; dot FLOPs predicted {stats.flops} "
                f"counted on the real step {counted.flops}")
        bad = []
        if pred_args != real_args:
            bad.append("arguments differ")
        if stats.flops != counted.flops or not stats.flops:
            bad.append("FLOPs differ")
            diff = {k: stats.by_op.get(k, 0) - counted.by_op.get(k, 0)
                    for k in set(stats.by_op) | set(counted.by_op)}
            top = sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:8]
            line += "; products that differ (predicted - counted): " + "; ".join(
                f"{k}: {v:+d}" for k, v in top if v)
        if kind == "train":
            formula = self.train_step_flops(cfg)
            line += f", train_step_flops {formula:.6g} (ratio {stats.flops / formula:.4f})"
            if abs(stats.flops / formula - 1) > DRYRUN_FLOPS_TOLERANCE:
                bad.append("FLOPs off the formula")
        ratio = pred_peak / real_peak
        line += (f"; peak predicted {pred_peak} real {real_peak} "
                 f"(max_memory_allocated; ratio {ratio:.4f}); trace {trace_s:.1f} s, "
                 f"real step {real_s:.2f} s; repairs {part.repairs}; "
                 f"launches {launched}")
        log(line)
        if abs(ratio - 1) > DRYRUN_PEAK_TOLERANCE:
            bad.append("peak off")
        if cfg.moe and launched["merge_kway_tile_groups"] == 0:
            bad.append("no grouped launch")
        del real
        gc.collect()
        torch.cuda.empty_cache()
        if bad:
            raise AssertionError(f"dryrun calibrate {arch} {kind}: {bad}")

    def dryrun_sharded(self) -> None:
        """(c) One decode step of DRYRUN_SHARDED on a (2, 2) mesh of 4 gloo
        ranks sharing the card, against one process and the fake group's
        prediction; a checkpoint saved on (2, 2), restored on (4, 1)."""
        import multiprocessing
        import socket

        arch, seq, batch = DRYRUN_SHARDED
        log(f"  dryrun (c): {arch} decode (batch {batch}, seq {seq}) on a (2, 2) "
            f"('data', 'model') mesh of {DIST_RANKS} gloo ranks sharing cuda:0")
        fake = subprocess.run(
            [sys.executable, "-c", DRYRUN_FAKE_SCRIPT, arch, str(seq), str(batch)],
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        if fake.returncode:
            raise AssertionError(f"dryrun (c) fake group: {fake.stdout[-2000:]}"
                                 f"{fake.stderr[-3000:]}")
        predicted = json.loads(fake.stdout.strip().splitlines()[-1])
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        ckpt = tempfile.mkdtemp(prefix="dryrun_ckpt_")
        ctx = multiprocessing.get_context("spawn")
        queue = ctx.Queue()
        procs = [ctx.Process(target=dryrun_rank,
                             args=(r, DIST_RANKS, port, ckpt, queue))
                 for r in range(DIST_RANKS)]
        for proc in procs:
            proc.start()
        reports, deadline = {}, time.monotonic() + DIST_TIMEOUT_S
        try:
            while len(reports) < DIST_RANKS and time.monotonic() < deadline:
                try:
                    rep = queue.get(timeout=5)
                except Exception:  # queue.Empty: see whether a rank died
                    if any(proc.exitcode not in (None, 0) for proc in procs):
                        break
                    continue
                reports[rep["rank"]] = rep
        finally:
            for proc in procs:
                proc.join(timeout=30)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        errors = {r: rep["error"] for r, rep in reports.items() if "error" in rep}
        for r, text in errors.items():
            log(f"  rank {r} failed:\n{text}")
        if len(reports) < DIST_RANKS or errors:
            raise AssertionError(f"dryrun (c): reports from {sorted(reports)}")
        reps = [reports[r] for r in range(DIST_RANKS)]
        log(f"  dryrun (c) gloo with CUDA tensors: {reps[0]['probe']}")
        bad = []
        for key in ("flops", "collectives"):
            got = [rep[key] for rep in reps]
            log(f"  dryrun (c) {key}: per rank {got}; fake group's prediction "
                f"{predicted[key]}")
            if any(g != predicted[key] for g in got):
                bad.append(f"{key} differ from the prediction")
        for key in ("logits_rel_l2", "restored_4x1_differ", "restored_whole_differ",
                    "seconds"):
            log(f"  dryrun (c) {key}: {[rep[key] for rep in reps]}")
        if any(rep["logits_rel_l2"] > DRYRUN_LOGITS_L2 for rep in reps):
            bad.append("logits off one process's")
        if any(rep["restored_4x1_differ"] or rep["restored_whole_differ"]
               for rep in reps):
            bad.append("restored checkpoint differs")
        if bad:
            raise AssertionError(f"dryrun (c): {bad}")

    def nccl_world_one(self) -> None:
        """(g) One ``sharded_merge_kway`` and one ``dropless_moe_ffn``
        through an NCCL group of world size 1 (one card), equal to the
        local results."""
        import datetime
        import socket

        import torch.distributed as dist

        from repro_torch import distributed as D
        from repro_torch.models.moe import _dropless_moe

        torch, dev = self.torch, self.dev
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=120))
        try:
            g = dist.group.WORLD
            w = 1 << (DIST_KEYS_LOG2 - self.cut)
            run = self.sorted_keys("int32", (w,))
            self.reset()
            out = D.sharded_merge_kway(run, g)
            merged = self.read_launches()
            name, n_exp, k, d, ff, t_loc = DIST_MOE[0]
            t = t_loc >> self.cut
            wg, wu, wd = _expert_weights(torch, dev, range(n_exp), d, ff)
            xt = torch.randn((t, d), generator=self.gen, device=dev).to(torch.bfloat16)
            wts = torch.rand((t, k), generator=self.gen, device=dev)
            experts = torch.rand((t, n_exp), generator=self.gen, device=dev
                                 ).argsort(dim=1)[:, :k].to(torch.int32)
            self.reset()
            ep, plan = D.dropless_moe_ffn(xt, experts, wts, wg, wu, wd, n_exp, g)
            moe_launches = self.read_launches()
            # the dispatch sort's plan, and the ragged merge's wide launch
            self.expect_launches("distributed nccl dropless_moe_ffn", moe_launches,
                                 add_launches(plan_launches(t * k), wide_launches()))
            params = {"w_gate": wg, "w_up": wu, "w_down": wd}
            local = _dropless_moe(params, xt, wts, experts, n_exp, k)
        finally:
            dist.destroy_process_group()
        diff_merge = self.mismatch(out, run)[0]
        diff_moe = self.mismatch(ep, local)[0]
        log(f"  distributed nccl world size 1: sharded_merge_kway of {w} int32 keys "
            f"{diff_merge} differ from the run, launches {merged}; dropless_moe_ffn "
            f"{name} ({t} tokens, {n_exp} experts on one rank) {diff_moe} differ from "
            f"the one-process layer, launches {moe_launches}, overflow "
            f"{int((plan.planned - plan.recv_lengths).sum())}")
        if diff_merge or diff_moe or not moe_launches["merge_kway_tile_groups"]:
            raise AssertionError("distributed: the NCCL world-size-1 case differs")

    # -- report -------------------------------------------------------------

    def kernels_line(self) -> dict:
        entries = []
        for name, source, replaces in (
            ("merge_tile", MERGE_SRC, MERGE_TPU),
            ("merge_kway_tile", KWAY_SRC, KWAY_TPU),
            ("merge_kway_tile_groups", KWAY_SRC, KWAY_TPU),
            ("merge_kway_groups_wide", KWAY_SRC, KWAY_TPU),
            ("ssd_step", SSD_SRC, SSD_TPU),
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


# -- phase 10: the distributed layer, p gloo ranks sharing the card ------------


def _rounded(v):
    """``v`` with its floats to four decimals, for the log."""
    if isinstance(v, float):
        return round(v, 4)
    if isinstance(v, dict):
        return {k: _rounded(x) for k, x in v.items()}
    return v


def _bit_mismatches(torch, got, want) -> int:
    """Elements whose bits differ (equal shapes and dtypes required)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    bits = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}
    view = bits[got.element_size()]
    return int((got.view(view) != want.view(view)).sum())


def _bf16_step(torch, v, up: bool):
    """The bfloat16 values one step above (``up``) or below ``v``: bf16 is
    sign and magnitude, so a step is one unit of the magnitude bits."""
    u = v.view(torch.int16).int() & 0xFFFF
    mag, neg = u & 0x7FFF, (u & 0x8000) != 0
    away = up != neg  # a step up from a positive value grows its magnitude
    mag = torch.where(away, mag + 1, mag - 1)
    neg = torch.where(mag < 0, ~neg, neg)  # a step through zero
    bits = torch.where(neg, 0x8000, 0) | mag.abs()
    return torch.where(bits >= 0x8000, bits - 0x10000, bits).short().view(
        torch.bfloat16)


class _CheckedKernels:
    """Stand-ins for the four kernel wrappers of ``kernels.merge`` that hold
    every launch against the kernel's plain version on the same inputs, as
    it happens.  A wrapper counts its launches on the name it is bound to,
    so while these stand in, ``launches`` of each counts the main path's."""

    def __init__(self, torch, km):
        self.torch, self.km = torch, km
        self.real = {name: getattr(km, name) for name in KERNELS}
        self.mismatches = dict.fromkeys(KERNELS, 0)
        self.checked = dict.fromkeys(KERNELS, 0)

    def _tally(self, name, pairs, n=None):
        self.checked[name] += 1
        self.mismatches[name] += sum(
            _bit_mismatches(self.torch, a[:n], b[:n]) for a, b in pairs)

    def __enter__(self):
        km, real = self.km, self.real

        def merge_tile(a, b, *, cuts=False):
            from repro_torch.core.corank import co_rank_batch

            out = real["merge_tile"](a, b, cuts=True)
            cr = co_rank_batch(km.tile_bounds(a.numel() + b.numel(), km.MERGE_TILE,
                                              a.device), a, b)
            self._tally("merge_tile", [(out[0], km.merge_tile_plain(a, b, cr.j, cr.k)),
                                       (out[1], cr.j), (out[2], cr.k)])
            return out if cuts else out[0]

        def merge_kway_tile(runs, cb, *, vals=None, out_len):
            out = real["merge_kway_tile"](runs, cb, vals=vals, out_len=out_len)
            want = km.merge_kway_tile_plain(runs, cb, vals=vals, out_len=out_len)
            pairs = [(out, want)] if vals is None else list(zip(out, want))
            # positions past the real total are unspecified
            self._tally("merge_kway_tile", pairs, int(cb[-1].sum()))
            return out

        def merge_kway_tile_groups(keys, vals=None):
            out = real["merge_kway_tile_groups"](keys, vals)
            want = km.merge_kway_groups_plain(keys, vals)
            self._tally("merge_kway_tile_groups",
                        [p for p in zip(out, want) if p[0] is not None])
            return out

        def merge_kway_groups_wide(keys, vals=None, lengths=None, *, out_len=None):
            out = real["merge_kway_groups_wide"](keys, vals, lengths, out_len=out_len)
            want = km.merge_kway_groups_wide_plain(keys, vals, lengths, out_len=out_len)
            pairs = [p for p in zip(out, want) if p[0] is not None]
            if lengths is not None:  # past a group's real total: unspecified
                torch = self.torch
                width = out[0].shape[1]
                keep = torch.arange(width, device=keys.device) < torch.clamp(
                    lengths.sum(dim=1, keepdim=True), max=width)
                pairs = [(torch.where(keep, a, 0), torch.where(keep, b, 0))
                         for a, b in pairs]
            self._tally("merge_kway_groups_wide", pairs)
            return out

        for fn in (merge_tile, merge_kway_tile, merge_kway_tile_groups,
                   merge_kway_groups_wide):
            fn.launches = 0
            setattr(km, fn.__name__, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.km, name, fn)

    def launches(self) -> dict:
        self.torch.cuda.synchronize()
        return {name: getattr(self.km, name).launches for name in KERNELS}


def _expert_weights(torch, dev, experts, d: int, ff: int):
    """Stacked bf16 ``(gate, up, down)`` of ``experts``, each expert drawn
    from its own seed, so a rank draws just the experts it owns and one
    process all of them, alike."""
    n = len(experts)
    gate, up = (torch.empty((n, d, ff), dtype=torch.bfloat16, device=dev)
                for _ in range(2))
    down = torch.empty((n, ff, d), dtype=torch.bfloat16, device=dev)
    for q, e in enumerate(experts):
        g = torch.Generator(device=dev).manual_seed(1000 + e)
        for out, std in ((gate, d ** -0.5), (up, d ** -0.5), (down, ff ** -0.5)):
            out[q] = torch.randn(out.shape[1:], generator=g, device=dev) * std
    return gate, up, down


class _DistRank:
    """One rank of the distributed phase: every case on ``cuda:0`` through
    ``repro_torch.distributed``, each result held against one process's
    answer on the same card.  ``report`` collects what the parent prints."""

    def __init__(self, rank: int, world: int, cut: int):
        import torch
        import torch.distributed as dist

        from repro_torch import obs
        from repro_torch import distributed as D
        from repro_torch.kernels import _build, merge as km, ops

        self.torch, self.dist, self.obs, self.D = torch, dist, obs, D
        self.km, self.ops = km, ops
        self.r, self.p, self.cut = rank, world, cut
        self.g = dist.group.WORLD
        self.dev = torch.device("cuda", 0)
        self.report = {"rank": rank, "compiled": _build.build(), "cases": {}}
        for name in _build.SOURCES:
            _build.load(name)
        self.guard = PlainGuard()
        self.phase1 = PhaseOneGuard(km)

    # -- helpers --------------------------------------------------------------

    def gen(self, seed: int):
        return self.torch.Generator(device=self.dev).manual_seed(seed)

    def keys(self, kind: str, n: int, seed: int):
        """``n`` seeded keys, the same on every rank."""
        torch, g = self.torch, self.gen(seed)
        if kind == "uniform":
            return torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=g,
                                 device=self.dev, dtype=torch.int32)
        if kind in ("duplicates", "sorted"):
            x = torch.randint(0, 16, (n,), generator=g, device=self.dev,
                              dtype=torch.int32)
            return torch.sort(x).values if kind == "sorted" else x
        if kind == "int32 max":
            x = torch.randint(-50, 50, (n,), generator=g, device=self.dev,
                              dtype=torch.int32)
            x[x > 45] = torch.iinfo(torch.int32).max
            return x
        x = torch.randn((n,), generator=g, device=self.dev)
        u = torch.rand((n,), generator=g, device=self.dev)
        for lo, v in ((0.00, float("inf")), (0.01, float("-inf")), (0.02, 0.0),
                      (0.03, -0.0), (0.04, torch.finfo(torch.float32).max)):
            x[(u >= lo) & (u < lo + 0.01)] = v
        return x

    def block(self, x):
        w = x.shape[0] // self.p
        return x[self.r * w:(self.r + 1) * w]

    def wall_ms(self, fn, reps: int = 3):
        """Median wall time of ``fn`` on every rank at once: a barrier,
        then the call between two synchronisations."""
        torch, times = self.torch, []
        for _ in range(reps):
            self.dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def event_ms(self, fn, reps: int = 3):
        """Median CUDA-event time of ``fn`` (no collective inside)."""
        torch, times = self.torch, []
        for _ in range(reps):
            self.dist.barrier()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def main_path(self, fn):
        """``fn`` once with every kernel launch held against its plain
        version and the collectives counted (obs on): ``(result,
        launches, checked, mismatches, records)``."""
        with self.obs.capture() as records, \
                _CheckedKernels(self.torch, self.km) as ck:
            out = fn()
            launches = ck.launches()
        return out, launches, ck.checked, ck.mismatches, list(records)

    @staticmethod
    def collectives(records) -> dict:
        """Bytes delivered here by op, host reads, from the obs records."""
        out = {"host_reads": 0}
        for rec in records:
            if rec["metric"] == "collectives.bytes":
                op = rec["labels"]["op"]
                out[op] = out.get(op, 0) + int(rec["value"])
            elif rec["metric"] == "collectives.host_reads":
                out["host_reads"] += int(rec["value"])
        return out

    @staticmethod
    def gauge(records, metric: str):
        """The value of the one ``metric`` record among ``records``."""
        (value,) = [rec["value"] for rec in records if rec["metric"] == metric]
        return value

    def case(self, name: str, **fields) -> None:
        self.report["cases"][name] = fields

    # -- cases ----------------------------------------------------------------

    def splitters(self) -> None:
        """(a) k-way cuts of every block bound and pairwise co-ranks, over
        collectives, against one process's search of the gathered runs."""
        from repro_torch.core.corank import co_rank
        from repro_torch.core.engine import kway_round_bound, pairwise_lockstep_rounds
        from repro_torch.core.kway import co_rank_kway_batch

        torch, D, p, r = self.torch, self.D, self.p, self.r
        w = 1 << (DIST_KEYS_LOG2 - self.cut)
        bounds = torch.tensor([r * w, (r + 1) * w], dtype=torch.int32,
                              device=self.dev)
        for kind in ("uniform", "duplicates"):
            runs = torch.sort(self.keys(kind, p * w, 11).reshape(p, w), dim=1).values
            with self.obs.capture() as recs:
                cuts = D.distributed_co_rank_kway(bounds, runs[r], self.g)
            want = co_rank_kway_batch(bounds, runs)
            self.case(f"splitters kway {kind}", differ=_bit_mismatches(torch, cuts, want),
                      rounds=self.gauge(recs, "splitters.kway_rounds"),
                      bound=kway_round_bound(w),
                      ms=self.wall_ms(lambda: D.distributed_co_rank_kway(bounds, runs[r], self.g)))
            del runs
        m = 1 << (DIST_MERGE_LOG2 - self.cut)
        a = torch.sort(self.keys("duplicates", m, 12)).values
        b = torch.sort(self.keys("duplicates", m, 13)).values
        s = 2 * m // p
        i = torch.tensor([r * s, r * s + s // 3], dtype=torch.int32, device=self.dev)
        with self.obs.capture() as recs:
            j, k = D.distributed_co_rank(i, self.block(a), self.block(b), self.g)
        want = co_rank(i, a, b)
        self.case("splitters pairwise", differ=_bit_mismatches(torch, j, want.j)
                  + _bit_mismatches(torch, k, want.k),
                  rounds=self.gauge(recs, "splitters.pairwise_rounds"),
                  bound=pairwise_lockstep_rounds(m, m),
                  ms=self.wall_ms(lambda: D.distributed_co_rank(i, self.block(a), self.block(b), self.g)))

    def sorts(self) -> None:
        """(b) ``sharded_sort`` on both strategies, four inputs; the
        permutation through a second exchange; a truncating capacity."""
        from repro_torch.core.mergesort import sort_key_val
        from repro_torch.distributed.api import ragged_merge

        torch, D, p, r, g = self.torch, self.D, self.p, self.r, self.g
        w = 1 << (DIST_KEYS_LOG2 - self.cut)
        bounds = torch.tensor([r * w, (r + 1) * w], dtype=torch.int32, device=self.dev)
        gidx = r * w + torch.arange(w, dtype=torch.int32, device=self.dev)
        for kind in ("uniform", "duplicates", "sorted", "float32 specials"):
            x = self.keys(kind, p * w, 21)
            # one process's stable order; for floats + 0.0 folds -0.0 into
            # 0.0, which the card's radix sort would order apart (they
            # compare equal)
            order = torch.sort(x + 0.0 if x.is_floating_point() else x,
                               stable=True).indices
            want_k, want_i = self.block(x[order]), self.block(order).to(torch.int32)
            del order
            shard = self.block(x)
            for strategy in ("exchange", "allgather"):
                out, launches, checked, mm, recs = self.main_path(
                    lambda: D.sharded_sort(shard, g, strategy=strategy))
                fields = dict(differ=_bit_mismatches(torch, out, want_k),
                              launches=launches, checked=checked, mismatches=mm,
                              expect=add_launches(plan_launches(w), wide_launches()),
                              wire=self.collectives(recs))
                if strategy == "exchange":
                    fields["padding_slots"] = int(self.gauge(recs, "exchange.padding_slots"))
                    keys, idx = sort_key_val(shard, gidx)
                    cuts = D.distributed_co_rank_kway(bounds, keys, g)
                    seg_k, lengths = D.exchange_block(keys, cuts, g)
                    seg_i, _ = D.exchange_block(idx, cuts, g)
                    out_k, out_i = ragged_merge(seg_k, lengths, w, vals=seg_i)
                    fields["perm_differ"] = (_bit_mismatches(torch, out_k, want_k)
                                             + _bit_mismatches(torch, out_i, want_i))
                    del keys, idx, seg_k, seg_i, out_k, out_i
                if kind in ("uniform", "sorted"):
                    fields["ms"] = self.timings(shard, strategy, bounds)
                self.case(f"sort {kind} {strategy}", **fields)
                del out
            if kind == "sorted":
                self.truncation(shard, want_k, bounds, w // 2)
            del x, want_k, want_i, shard
        if r == 0:
            x = self.keys("uniform", p * w, 21)
            self.report["torch_sort_ms"] = self.event_ms(lambda: torch.sort(x, stable=True))
            del x
        else:
            self.event_ms(lambda: None)  # the barriers of rank 0's timing

    def timings(self, shard, strategy, bounds) -> dict:
        """Milliseconds of the whole sort and (exchange) of its parts:
        device-only parts by CUDA events, parts with collectives by wall."""
        from repro_torch.core.mergesort import merge_sort
        from repro_torch.distributed.api import ragged_merge

        D, g = self.D, self.g
        ms = {"whole": self.wall_ms(lambda: D.sharded_sort(shard, g, strategy=strategy)),
              "local sort": self.event_ms(lambda: merge_sort(shard))}
        if strategy == "exchange":
            run = merge_sort(shard)
            cuts = D.distributed_co_rank_kway(bounds, run, g)
            seg, lengths = D.exchange_block(run, cuts, g)
            ms["splitters"] = self.wall_ms(lambda: D.distributed_co_rank_kway(bounds, run, g))
            ms["exchange"] = self.wall_ms(lambda: D.exchange_block(run, cuts, g))
            ms["local merge"] = self.event_ms(lambda: ragged_merge(seg, lengths, run.shape[0]))
        return ms

    def truncation(self, shard, want_k, bounds, cap: int) -> None:
        """The sorted input at ``capacity = w // 2``: each block arrives from
        one peer whole, so half of it is dropped, accounted exactly, and the
        block's tail is zero-filled."""
        from repro_torch.core.mergesort import merge_sort

        torch, D, g = self.torch, self.D, self.g
        run = merge_sort(shard)
        out, launches, checked, mm, _ = self.main_path(
            lambda: D.sharded_merge_kway(run, g, capacity=cap))
        cuts = D.distributed_co_rank_kway(bounds, run, g)
        _, lengths = D.exchange_block(run, cuts, g, capacity=cap)
        planned = cuts[1] - cuts[0]
        kept = int(lengths.sum())
        self.case("truncation sorted capacity w/2", launches=launches, checked=checked,
                  mismatches=mm, expect=wide_launches(),
                  dropped=int((planned - lengths).sum()),
                  expected_dropped=shard.shape[0] - kept,
                  clipped=bool(torch.equal(lengths, torch.clamp(planned, max=cap))),
                  tail_nonzero=int((out[kept:] != 0).sum()),
                  differ=_bit_mismatches(torch, out[:kept], want_k[:kept]))

    def host_sort(self) -> None:
        """(c) ``sharded_sort_host`` of 2^26 + 3 keys with real int32 max
        keys: every rank gets the whole sorted array."""
        torch = self.torch
        n = self.p * (1 << (DIST_KEYS_LOG2 - self.cut)) + 3
        x = self.keys("int32 max", n, 31)
        want = torch.sort(x, stable=True).values
        out, launches, checked, mm, recs = self.main_path(
            lambda: self.D.sharded_sort_host(x))
        self.case("sharded_sort_host", n=n, differ=_bit_mismatches(torch, out, want),
                  launches=launches, checked=checked, mismatches=mm,
                  expect=add_launches(plan_launches(-(-n // self.p)), wide_launches()),
                  wire=self.collectives(recs),
                  ms=self.wall_ms(lambda: self.D.sharded_sort_host(x), 2))

    def merges(self) -> None:
        """(d) ``distributed_merge``, both strategies, m = n = 2^25 int32
        with real int32 max keys, against ``ops.stable_merge`` in one
        process (computed before the counted run)."""
        torch, D, g = self.torch, self.D, self.g
        m = 1 << (DIST_MERGE_LOG2 - self.cut)
        a = torch.sort(self.keys("int32 max", m, 41)).values
        b = torch.sort(self.keys("int32 max", m, 42)).values
        want = self.block(self.ops.stable_merge(a, b))
        sa, sb = self.block(a), self.block(b)
        for strategy in ("allgather", "corank"):
            out, launches, checked, mm, recs = self.main_path(
                lambda: D.distributed_merge(sa, sb, g, strategy=strategy))
            self.case(f"merge {strategy}", differ=_bit_mismatches(torch, out, want),
                      launches=launches, checked=checked, mismatches=mm,
                      expect=add_launches(),
                      wire=self.collectives(recs),
                      ms=self.wall_ms(lambda: D.distributed_merge(sa, sb, g, strategy=strategy)))

    def moe(self) -> None:
        """(e) ``dropless_moe_ffn`` at full width, bf16, uniform and one-hot
        routing: against one process's dropless layer (rank 0), the plan on
        both merge backends, overflow 0, then a truncating capacity."""
        import gc

        for spec in DIST_MOE:
            self.moe_model(*spec)
            gc.collect()
            self.torch.cuda.empty_cache()

    def moe_model(self, name, n_exp, k, d, ff, t_loc) -> None:
        import os as os_

        from repro_torch.distributed import _collectives as C
        from repro_torch.models.moe import _dropless_moe

        torch, D, p, r, g = self.torch, self.D, self.p, self.r, self.g
        t_loc >>= self.cut
        t = p * t_loc
        e_per = n_exp // p
        torch.cuda.reset_peak_memory_stats()
        wg, wu, wd = _expert_weights(torch, self.dev, range(r * e_per, (r + 1) * e_per), d, ff)
        gt = self.gen(51)
        xt_all = torch.randn((t, d), generator=gt, device=self.dev).to(torch.bfloat16)
        w_all = torch.rand((t, k), generator=gt, device=self.dev)
        w_all = w_all / w_all.sum(dim=1, keepdim=True)
        routings = {
            "uniform": torch.rand((t, n_exp), generator=gt, device=self.dev
                                  ).argsort(dim=1)[:, :k].to(torch.int32),
            "one-hot": torch.arange(k, dtype=torch.int32, device=self.dev
                                    ).expand(t, k).contiguous(),
        }
        xt, w = self.block(xt_all), self.block(w_all)
        n = t_loc * k
        backend_var = self.ops.BACKEND_ENV_VAR
        for routing, experts_all in routings.items():
            experts = self.block(experts_all)
            (out, plan), launches, checked, mm, recs = self.main_path(
                lambda: D.dropless_moe_ffn(xt, experts, w, wg, wu, wd, n_exp, g))
            overflow = sum(int(rec["value"]) for rec in recs
                           if rec["metric"] == "moe.overflow")
            os_.environ[backend_var] = "torch"
            try:
                plain = D.dropless_dispatch(xt, experts, n_exp, g)
            finally:
                os_.environ.pop(backend_var)
            plan_differ = sum(
                _bit_mismatches(torch, getattr(plan, f), getattr(plain, f))
                for f in ("sorted_e", "sorted_idx", "group_sizes", "perm",
                          "recv_lengths", "planned"))
            del plain
            # one process's dropless layer on all the tokens (rank 0, with
            # every expert); the other ranks free their share first
            outs = C.all_gather(out, g).reshape(t, d)
            fields = dict(launches=launches, checked=checked, mismatches=mm,
                          expect=add_launches(plan_launches(n), wide_launches()),
                          overflow=overflow, plan_differ=plan_differ,
                          wire=self.collectives(recs),
                          rows_received=int(plan.recv_lengths.sum()),
                          ms=self.wall_ms(lambda: D.dropless_moe_ffn(
                              xt, experts, w, wg, wu, wd, n_exp, g), 2))
            if routing == "one-hot":
                cap = n // 4
                (_, plan_c), _, _, _, recs_c = self.main_path(
                    lambda: D.dropless_moe_ffn(xt, experts, w, wg, wu, wd, n_exp, g, cap))
                fields["capacity"] = cap
                fields["capacity_overflow"] = sum(int(rec["value"]) for rec in recs_c
                                                  if rec["metric"] == "moe.overflow")
                fields["capacity_planned_minus_received"] = int(
                    (plan_c.planned - plan_c.recv_lengths).sum())
                fields["capacity_clipped"] = bool(torch.equal(
                    plan_c.recv_lengths, torch.clamp(plan_c.planned, max=cap)))
                del plan_c
            del plan, out
            fields["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            if r == 0:
                fields.update(self.moe_single(name, n_exp, k, d, ff, xt_all, w_all,
                                              experts_all, outs, _dropless_moe))
            self.dist.barrier()
            self.case(f"moe {name} {routing}", **fields)
        del wg, wu, wd

    def moe_single(self, name, n_exp, k, d, ff, xt_all, w_all, experts_all, outs,
                   dropless) -> dict:
        """One process's dropless layer on every token with every expert,
        against the ranks' gathered output (relative L2, and bit-equality)."""
        torch = self.torch
        params = dict(zip(("w_gate", "w_up", "w_down"),
                          _expert_weights(torch, self.dev, range(n_exp), d, ff)))
        want = dropless(params, xt_all, w_all, experts_all, n_exp, k)
        del params
        rel = float((outs.float() - want.float()).norm() / want.float().norm())
        return dict(rel_l2=rel, bit_equal=bool(torch.equal(outs, want)),
                    finite=bool(torch.isfinite(outs).all()),
                    single_peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    def psum(self) -> None:
        """(f) ``compressed_psum`` of 2^24 float32 a rank against an exact
        (float64) all-reduce, within the quantisation bound."""
        from repro_torch.distributed import _collectives as C
        from repro_torch.train.compress import BLOCK, compressed_psum

        torch, p = self.torch, self.p
        n = 1 << (DIST_KEYS_LOG2 - self.cut)
        x = torch.randn((n,), generator=self.gen(60 + self.r), device=self.dev) * (1 + self.r)
        got = compressed_psum(x, self.g, self.gen(70 + self.r))
        exact = C.psum(x.double(), self.g)
        scale = C.pmax(x.abs().reshape(-1, BLOCK).amax(dim=1) / 127.0, self.g)
        bound = 1.5 * p * scale.double().repeat_interleave(BLOCK) + 1e-6 * exact.abs()
        err = (got.double() - exact).abs()
        self.case("compressed_psum", n=n, max_err=float(err.max()),
                  max_err_over_bound=float((err / bound).max()),
                  mean_err=float((got.double() - exact).mean()),
                  bound_max=float(bound.max()),
                  ms=self.wall_ms(lambda: compressed_psum(x, self.g, self.gen(70 + self.r))))

    def run(self) -> dict:
        for case in (self.splitters, self.sorts, self.host_sort, self.merges,
                     self.moe, self.psum):
            t0 = time.perf_counter()
            case()
            self.report.setdefault("seconds", {})[case.__name__] = time.perf_counter() - t0
        self.report["plain_calls"] = self.guard.calls
        self.report["phase1_calls"] = self.phase1.calls
        return self.report


def distributed_rank(rank: int, world: int, port: int, cut: int, queue) -> None:
    """Entry of a rank process of the distributed phase: join the gloo
    group on ``cuda:0``, run every case, send the report (or the error)
    to the parent."""
    import datetime

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
        try:
            queue.put(_DistRank(rank, world, cut).run())
        finally:
            dist.destroy_process_group()
    except Exception:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


DRYRUN_FAKE_SCRIPT = r"""
import json, sys
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh

arch, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
D.SHAPES["decode_sharded"] = ShapeConfig("decode_sharded", seq, batch, "decode")
D.fake_process_group(4)
mesh = make_mesh((2, 2), ("data", "model"))
fake = FakeTensorMode()
m, cfg, fn, args = D.build_cell(arch, "decode_sharded", False, device="cuda",
                                fake_mode=fake, mesh=mesh)
stats, part, peak, secs = D.trace_cell(m, fn, args, fake)
print(json.dumps({"flops": stats.flops, "collectives": stats.collective_bytes(),
                  "trace_s": secs}))
"""


def dryrun_rank(rank: int, world: int, port: int, ckpt: str, queue) -> None:
    """Entry of a rank process of the dryrun phase's part (c)."""
    import datetime

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300))
        try:
            queue.put(_dryrun_rank_run(rank, torch, dist, ckpt))
        finally:
            dist.destroy_process_group()
    except Exception:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def _gloo_cuda_collectives(torch, dist):
    """A dispatch mode that runs DTensor's functional ``all_gather`` and
    ``all_reduce`` on gloo as the blocking ``torch.distributed`` calls: on
    CUDA tensors gloo takes ``dist.all_gather_into_tensor`` and
    ``dist.all_reduce``, but the functional ``all_gather_tensor`` crashes
    the process (signal 11 on torch 2.11).  The counters
    below it count the same bytes either way."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.utils._python_dispatch import TorchDispatchMode

    funcol = torch.ops._c10d_functional

    class GlooCudaCollectives(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is funcol.all_gather_into_tensor.default:
                x, n, name = args
                out = x.new_empty((n * x.shape[0], *x.shape[1:]))
                dist.all_gather_into_tensor(out, x.contiguous(),
                                            group=_resolve_process_group(name))
                return out
            if func is funcol.all_reduce.default:
                x, op, name = args
                out = x.clone()
                dist.all_reduce(out, op=getattr(dist.ReduceOp, op.upper()),
                                group=_resolve_process_group(name))
                return out
            return func(*args, **(kwargs or {}))

    return GlooCudaCollectives()


def _dryrun_rank_run(rank, torch, dist, ckpt) -> dict:
    from torch.utils._pytree import tree_leaves

    from repro_torch.checkpoint import checkpointer as C
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels.merge import register_dtensor_rules
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.hlo_stats import TraceStats
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import Partitioner
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    probe = {}
    x = torch.full((4,), float(rank), device=dev)
    for name, fn in (
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty(16, device=dev), x)),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                torch.empty(1, device=dev), x))):
        try:
            fn()
            torch.cuda.synchronize()
            probe[name] = "ok"
        except (RuntimeError, ValueError) as e:
            probe[name] = f"{type(e).__name__}: {str(e)[:120]}"
    register_dtensor_rules()
    arch, seq, batch = DRYRUN_SHARDED
    shape = ShapeConfig("decode_sharded", seq, batch, "decode")
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {"rank": rank, "probe": probe}

    gloo_fix = _gloo_cuda_collectives(torch, dist)

    def sharded(cfg, inputs, stats):
        args = D.place_cell(cfg, shape, mesh, inputs)
        try:
            with stats, gloo_fix, Partitioner(stats):
                logits, _ = D.step_fn(cfg, "decode")(*args)
            with gloo_fix:  # gathered for the check, not counted
                full = logits.full_tensor()
        finally:
            L.set_batch_axes(None)
        return full, args[0]

    # the cell as the dry-run sees it (bf16 compute and cache): the counts
    cfg = ARCHS[arch]
    stats = TraceStats()
    sharded(cfg, D.real_inputs(cfg, shape, device=dev, seed=0), stats)
    out["flops"], out["collectives"] = stats.flops, stats.collective_bytes()
    # float32 compute and cache: the logits against one process
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def inputs32():
        return D.real_inputs(cfg32, shape, device=dev, seed=0,
                             cache_dtype=torch.float32)

    got, dparams = sharded(cfg32, inputs32(), TraceStats())
    params, cache, tokens = inputs32()
    want, _ = D.step_fn(cfg32, "decode")(params, cache, tokens)
    out["logits_rel_l2"] = float(torch.linalg.norm(got - want)
                                 / torch.linalg.norm(want))
    # a checkpoint of the sharded params, restored on (4, 1) and whole
    specs = D.sanitize_specs(params, T.param_specs(cfg32), mesh)
    with gloo_fix:
        C.save_checkpoint(ckpt, 1, {"params": dparams}, specs={"params": specs})
        mesh41 = make_mesh((4, 1), ("data", "model"))
        back = C.restore_checkpoint(ckpt, 1, {"params": params}, mesh=mesh41)
        whole = C.restore_checkpoint(ckpt, 1, {"params": T._map(torch.zeros_like,
                                                                params)})
        differ = [0, 0]
        for a, b, c in zip(tree_leaves(params), tree_leaves(back["params"]),
                           tree_leaves(whole["params"])):
            bits = a.view(torch.int32) if a.dtype == torch.float32 else a
            differ[0] += int((bits != b.full_tensor().view(bits.dtype)).sum())
            differ[1] += int((bits != c.view(bits.dtype)).sum())
    out["restored_4x1_differ"], out["restored_whole_differ"] = differ
    out["seconds"] = round(time.perf_counter() - t0, 1)
    return out


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


def log_steps(label: str, res, steps: int, secs: float, times) -> None:
    """One run's line: requests, tokens, tok/s, and the median and p90 of
    the (decode, sample) CUDA-event times of its steps."""
    step_ms = [a + b for a, b in times]
    q = statistics.quantiles(step_ms, n=10)
    tokens = sum(len(t) for t in res.values())
    log(f"  {label}: {len(res)} requests, {tokens} tokens, {steps} steps, "
        f"{secs:.3f} s wall, {tokens / secs:.1f} tok/s; "
        f"step median {statistics.median(step_ms):.3f} ms, "
        f"p90 {q[-1]:.3f} ms (CUDA events: decode + sample); "
        f"sampler share {sum(b for _, b in times) / sum(step_ms):.3f}, "
        f"sampler median {statistics.median(b for _, b in times):.3f} ms")


def _index(tree, i: int):
    """The ``i``-th layer of a tree of stacked tensors."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _leaves(tree):
    """The tensors of a tree of dicts and lists."""
    if isinstance(tree, (dict, list)):
        for v in tree.values() if isinstance(tree, dict) else tree:
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
    parser.add_argument("--only", default="",
                        help="comma-separated phases to run after the build "
                             "(e.g. 'dryrun'); the default runs them all")
    args = parser.parse_args()

    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("error: src/repro_torch not found beside chip_smoke.py; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    # Deterministic cuBLAS (the train phase's restart check) needs a fixed
    # workspace, set before the first product.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    phases = (smoke.phase_build, smoke.phase_merge, smoke.phase_merge_kway,
              smoke.phase_merge_window, smoke.phase_external,
              smoke.phase_serve, smoke.phase_moe, smoke.phase_ssm,
              smoke.phase_train, smoke.phase_distributed, smoke.phase_dryrun)
    if args.only:
        keep = {f"phase_{name}" for name in args.only.split(",")} | {"phase_build"}
        phases = [ph for ph in phases if ph.__name__ in keep]
    for phase in phases:
        t0 = time.perf_counter()
        smoke.guard.calls = smoke.phase1.calls = 0
        try:
            phase()
        except Exception:  # a failed phase fails the run, after the others
            traceback.print_exc()
            smoke.failed.append(phase.__name__)
        torch.cuda.empty_cache()
        log(f"  guard: merge_runs_plain ran {smoke.guard.calls} times on CUDA "
            f"tensors under the cuda backend in {phase.__name__} (must be 0)")
        log(f"  guard: torch-ops phase 1 ran {smoke.phase1.calls} times on CUDA "
            f"tensors in the kernels' wrappers in {phase.__name__} (must be 0)")
        if smoke.guard.calls:
            smoke.failed.append(f"{phase.__name__}: merge_runs_plain on the card")
        if smoke.phase1.calls:
            smoke.failed.append(f"{phase.__name__}: phase 1 in torch ops on the card")
        log(f"  ({phase.__name__} took {time.perf_counter() - t0:.1f} s)")
    for name, n in smoke.launches.items():
        if n == 0 and not args.only:
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
