"""Time the merge kernels' grouped launches and the sorts built on them.

Run on a machine with a CUDA card, from the repository root::

    python src/repro_torch/kernels/bench.py [--src DIR] [--reps N] [--json PATH]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (the
default is this checkout's), so one command can time two checkouts in
turns.  For every case it prints one line with:

* ``device_ms``: the kernels' own time on the card per call
  (``torch.profiler``), ``launches`` per call and the kernels' names;
* ``call_ms``: CUDA events around a call (the host's launch included);
* ``copy_ms``: CUDA events around a device copy of the same bytes (what
  one read and one write of them take on this card);
* ``bound_ms``: each input byte read once and each output byte written
  once over 3.35 TB/s (the H100 SXM data sheet);
* ``sort_ms``: ``torch.sort(stable=True)`` of the same keys (the groups'
  rows for a grouped case), the yardstick.

The cases: the grouped launch at the shapes of the top-k's four block-sort
passes before the block sort became one launch, at that one launch and at
its rounds, the sort plan's leaf, two wide passes and ``merge_kway_tile``
merging the same runs as the second from cuts given (what the wide
launch's own co-rank adds), whole sorts: the MoE dispatch sort of
32,768 int32 keys with an int32 payload and the spill sort of a 2^24-key
int32 chunk (``ops.stable_sort``), and the three merge entries at
``chip_smoke.py``'s shapes (``--entries`` runs only these):
``ops.stable_merge`` of m = n = 2^27 int32 and 2^26 bfloat16 keys,
``ops.stable_merge_kway`` of (4, 2^24) and (16, 2^23) int32 runs and
``ops.merge_window`` of an (8, 2^22) window with ragged lengths (one row
empty, dtype-max keys among the padding), int32 keys with an int32
payload and int64 keys with an int64 payload; their ``sort_ms`` is
``torch.sort(stable=True)`` of the same real keys.  A case whose groups
exceed the grouped launch's tile in the checkout under test runs through
``merge_runs_ranked`` (the checkout's own route for it).

``--ssd`` times only the one-token SSD recurrence of one mamba2-2.7b layer
at 256 rows, (256, 80, 64, 128), bf16 x/B/C and a float32 state of 671 MB:
the checkout's decode-step update of the cached state
(``models.ssm.ssd_step_``, one kernel, where the checkout has it; else
``ssd_step`` and a ``copy_`` into the cache) beside ``plain_ms``, the
plain ``ssd_step`` plus ``copy_``; its bound is the state read and written
once, and ``copy_ms`` a device copy of the state.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12


def _events_ms(torch, fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device(torch, fn, reps: int):
    """(device ms per call, launches per call, {kernel: ms per call})."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels, launches = {}, 0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
        if dev > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key[:60]] = dev / 1e3 / reps
            launches += e.count
    return sum(kernels.values()), launches / reps, kernels


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--json", default="")
    parser.add_argument("--label", default="")
    parser.add_argument("--entries", action="store_true",
                        help="time only the three merge entries")
    parser.add_argument("--ssd", action="store_true",
                        help="time only the SSD decode step of one layer")
    args = parser.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core import mergesort as ms
    from repro_torch.kernels import merge as km
    from repro_torch.kernels import ops

    tile = getattr(km, "GROUPS_TILE", km.KWAY_TILE)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(20131303)
    rows = []

    def report(case, fn, nbytes, sort_fn=None, plain_fn=None):
        d_ms, launches, kernels = _device(torch, fn, args.reps)
        half = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
        row = {
            "label": args.label, "case": case, "device_ms": d_ms,
            "launches": launches, "call_ms": _events_ms(torch, fn, args.reps),
            "copy_ms": _events_ms(torch, half.clone, args.reps),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "kernels": kernels,
        }
        if sort_fn is not None:
            row["sort_ms"] = _events_ms(torch, sort_fn, args.reps)
        if plain_fn is not None:
            row["plain_ms"] = _events_ms(torch, plain_fn, args.reps)
        del half
        rows.append(row)
        print(json.dumps(row), flush=True)

    def grouped(g, k, w, key_dtype=torch.float32):
        keys = torch.randint(-40, 40, (g, k, w), generator=gen, device=dev)
        keys = torch.sort(keys.to(key_dtype), dim=-1, stable=True).values
        vals = torch.arange(g * k * w, device=dev, dtype=torch.int32).reshape(g, k, w)
        fn = ((lambda: km.merge_kway_tile_groups(keys, vals)) if k * w <= tile
              else (lambda: ms.merge_runs_ranked(keys, vals)))
        flat = keys.reshape(g, k * w)
        report(f"groups ({g},{k},{w}) {str(key_dtype)[6:]}+int32", fn,
               2 * keys.numel() * (keys.element_size() + 4),
               lambda: torch.sort(flat, dim=1, stable=True))

    def sorted_keys(shape, dtype=torch.int32):
        x = torch.randint(-(1 << 20), 1 << 20, shape, generator=gen, device=dev)
        if dtype == torch.bfloat16:  # integer-valued: exact
            x = torch.randint(-250, 250, shape, generator=gen, device=dev)
        return torch.sort(x.to(dtype), dim=-1).values

    def entries():
        for kind, log2n in ((torch.int32, 27), (torch.bfloat16, 26)):
            a, b = sorted_keys((1 << log2n,), kind), sorted_keys((1 << log2n,), kind)
            ab = torch.cat([a, b])
            report(f"ops.stable_merge {str(kind)[6:]} m=n=2^{log2n}",
                   lambda: ops.stable_merge(a, b), 2 * ab.numel() * ab.element_size(),
                   lambda: torch.sort(ab, stable=True))
            del a, b, ab
        for k, log2w in ((4, 24), (16, 23)):
            runs = sorted_keys((k, 1 << log2w))
            report(f"ops.stable_merge_kway int32 ({k},2^{log2w})",
                   lambda: ops.stable_merge_kway(runs), 2 * runs.numel() * 4,
                   lambda: torch.sort(runs.reshape(-1), stable=True))
            del runs
        k, w = 8, 1 << 22
        for kd, spread in ((torch.int32, 1 << 20), (torch.int64, 1 << 40)):
            kmax = torch.iinfo(kd).max
            cuts = torch.sort(torch.randint(0, w + 1, (k - 2,), generator=gen,
                                            device=dev)).values
            edges = torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), w)])
            lengths = torch.diff(edges)
            lengths = torch.cat([lengths[:3], lengths.new_zeros(1),
                                 lengths[3:]]).to(torch.int32)
            real = torch.arange(w, device=dev)[None, :] < lengths[:, None]
            keys = torch.randint(0, 1 << 20, (k, w), generator=gen, device=dev,
                                 dtype=torch.int32).to(kd) * (spread >> 20)
            keys[torch.rand((k, w), generator=gen, device=dev) < 0.05] = kmax
            keys[~real] = kmax
            runs = torch.sort(keys, dim=1).values
            vals = torch.arange(k * w, device=dev).to(kd).reshape(k, w)
            flat = runs[real]
            name = str(kd)[6:]
            report(f"ops.merge_window {name}+{name} (8,2^22) ragged",
                   lambda: ops.merge_window(runs, vals, lengths, out_len=w),
                   2 * flat.numel() * 2 * flat.element_size(),
                   lambda: torch.sort(flat, stable=True))
            del keys, runs, vals, flat

    def ssd(bt=256, h=80, p=64, n=128):
        from repro_torch.models import ssm

        xbc = torch.randn((bt, 1, h * p + 2 * n), generator=gen, device=dev
                          ).to(torch.bfloat16)
        step_args = (xbc[..., :h * p].reshape(bt, h, p),
                     torch.rand((bt, h), generator=gen, device=dev) * 0.1,
                     xbc[..., h * p:h * p + n].reshape(bt, 1, n),
                     xbc[..., h * p + n:].reshape(bt, 1, n),
                     torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
                     torch.ones((h,), device=dev))
        state = torch.randn((bt, h, p, n), generator=gen, device=dev)

        def plain():
            state.copy_(ssm.ssd_step(*step_args, state)[1])

        update = getattr(ssm, "ssd_step_", None)
        fn = plain if update is None else (lambda: update(*step_args, state))
        report(f"ssd_step ({bt},{h},{p},{n}) bf16, state in place", fn,
               2 * state.numel() * 4, plain_fn=plain)

    with torch.no_grad():
        if args.ssd:
            ssd()
            return _write(args.json, rows)
        if args.entries:
            entries()
            return _write(args.json, rows)
        for g, k, w in ((607744, 4, 1), (151936, 4, 4), (37984, 4, 16),
                        (18992, 2, 64), (18992, 128, 1), (4752, 4, 50),
                        (1200, 16, 50)):
            grouped(g, k, w)
        grouped(4096, 4096, 1, torch.int32)
        grouped(1024, 4, 4096, torch.int32)
        grouped(1, 4, 1 << 22, torch.int32)
        # the same merge as merge_kway_tile with its cuts given (phase 2 only)
        runs = torch.sort(torch.randint(0, 1 << 16, (4, 1 << 22), generator=gen,
                                        device=dev, dtype=torch.int32), dim=1).values
        cb = km.co_rank_kway_batch(km.tile_bounds(4 << 22, km.KWAY_TILE, dev), runs)
        rvals = torch.arange(4 << 22, device=dev, dtype=torch.int32).reshape(4, -1)
        report("merge_kway_tile (4,2^22) int32+int32, cuts given",
               lambda: km.merge_kway_tile(runs, cb, vals=rvals, out_len=4 << 22),
               2 * (4 << 22) * 8, lambda: torch.sort(runs.reshape(-1), stable=True))
        n = 32768
        experts = torch.randint(0, 16, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
        idx = torch.arange(n, device=dev, dtype=torch.int32)
        report(f"sort_key_val n={n} int32+int32",
               lambda: ms.sort_key_val(experts, idx), 2 * n * 8,
               lambda: torch.sort(experts, stable=True))
        chunk = torch.randint(0, 1 << 16, (1 << 24,), generator=gen,
                              device=dev, dtype=torch.int32)
        report("stable_sort n=2^24 int32", lambda: ops.stable_sort(chunk),
               2 * chunk.numel() * 4, lambda: torch.sort(chunk, stable=True))
        del chunk
        entries()
    return _write(args.json, rows)


def _write(path: str, rows) -> int:
    if path:
        with open(path, "a") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
