"""One run of one cell of the port's benchmark.

A cell (``workloads/<name>.json``) names a configuration
(``configs/<config>.json``, read by ``families/<family>.py``), a traffic
mix (``traffic/<traffic>.json``, read by ``traffic.py``), the serving path
that drives the program (``paths/<path>.py``) and the limits of the
numbers that decide ``correct`` (``check.py``).  Per-layer metrics are the
readers ``metrics/<metric>.py``; FLOPs come from ``flops/<family>.py`` and
the plain reference from ``reference/<family>.py``.  Everything is found
by name, so a new cell, configuration, traffic mix or metric is new files.

A run: weights are made on the device from the seed; one short batch at
the cell's batch size warms every shape up; then the window opens, and
batches of the closed loop run back to back, as many whole batches as fit
in ``seconds`` by the device's clock (at least one: a batch starts only
while the longest one so far would still end inside).  The window is the
span from its start to the last batch's end, so the rates take all the
work and all the time of whole batches.  With ``trace`` the window also
records device stamps around each decode step and sampler call, and one
more batch, after the window, runs a profiled slice of steady steps.
Without it, a cell whose end-to-end metrics (``end_to_end`` in its file)
hold ``device_ms_per_token`` runs each window batch under a profiler of
the device alone, and the device's busy time over the whole window is
read from its operations once the window has closed.
Then the program's state is freed and a sample of the finished requests
is held against the reference.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import check, peaks, stats
from portbench import trace as trace_mod
from portbench.traffic import Traffic

BENCH = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# The profiled slice: generated steps [8, 28) of the batch after the window.
PROFILE_FIRST, PROFILE_STEPS = 8, 20
KEPT_ROWS_PER_BATCH = 8  # rows of each batch whose logits are kept
CHECKED_REQUESTS = 8  # requests the reference runs over
# A cell's end-to-end metrics, where its file names none, and their units.
END_TO_END = ("decode_tok_s", "tpot_p95_ms", "setup_s")
E2E_UNITS = {"decode_tok_s": "tokens/s", "tpot_p95_ms": "ms", "setup_s": "s",
             "device_ms_per_token": "ms/token"}


def load_json(kind: str, name: str, root: Path = BENCH) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = BENCH):
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = root / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(name: str, root: Path = BENCH) -> dict:
    """The configuration as the port runs it: the file's published keys,
    with each departure under ``assumed.departures`` (its ``published``
    value beside the one the port ``runs``) set to what the port runs.
    The family, the FLOP counter and the reference all read this."""
    spec = load_json("configs", name, root)
    departures = spec.get("assumed", {}).get("departures", {})
    for key, d in departures.items():
        if spec[key] != d["published"]:
            raise ValueError(f"configs/{name}.json: {key} is {spec[key]!r}, "
                             f"its departure says {d['published']!r}")
    return {**spec, **{key: d["runs"] for key, d in departures.items()}}


def cell(name: str, root: Path = BENCH) -> dict:
    """The cell's file, with its configuration (:func:`config`) and
    traffic files loaded under ``spec`` and ``traffic_params``."""
    c = load_json("workloads", name, root)
    if c["name"] != name:
        raise ValueError(f"workloads/{name}.json names {c['name']!r}")
    c["spec"] = config(c["config"], root)
    c["traffic_params"] = load_json("traffic", c["traffic"], root)
    return c


def end_to_end(c: dict) -> tuple:
    """The end-to-end metrics cell ``c`` reports (its file's
    ``end_to_end``, else :data:`END_TO_END`)."""
    names = tuple(c.get("end_to_end", END_TO_END))
    unknown = set(names) - set(E2E_UNITS)
    if unknown or "setup_s" not in names:
        raise ValueError(f"{c['name']}: end_to_end {names!r}")
    return names


def readers(root: Path = BENCH) -> dict:
    """Every per-layer metric's reader, by name."""
    return {p.stem: load_module("metrics", p.stem, root)
            for p in sorted((root / "metrics").glob("*.py"))}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Clock:
    """Stamps on the device's timeline: CUDA events on the card; on the
    CPU (the tests) the host clock, which is the CPU's timeline."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def stamp(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self, e) -> None:
        if self.cuda:
            e.synchronize()


@dataclasses.dataclass
class View:
    """What a per-layer reader (``metrics/<name>.py: read(view)``) sees."""

    seconds: float  # the window
    clients: int
    vocab: int  # logits a row
    top_k: int
    sampler: str
    peaks: dict | None
    decode_ms: list  # each decode step's stamps in the window
    sample_ms: list  # each sampler call's
    fed_positions: list  # the position of each decode step in the window
    fed_rows: list  # the rows whose request needs that step
    flops_per_token: object  # position -> FLOPs
    slice: trace_mod.Slice | None
    tokens: int = 0  # tokens the window's requests asked for
    gaps: list = dataclasses.field(default_factory=list)  # ms between a request's tokens
    end_to_end: tuple = END_TO_END  # the cell's end-to-end metrics


@dataclasses.dataclass
class Outcome:
    result: dict
    context: dict | None = None
    window: dict | None = None  # how the window went, for standard error


def _timed_batch(path, prompts, new_tokens, clock, keep_rows=None):
    stamps = []
    served, kept = path.run_batch(prompts, new_tokens,
                                  lambda i: stamps.append(clock.stamp()),
                                  keep_rows=keep_rows)
    return served, kept, stamps


def _profiler(cuda: bool, host: bool = True):
    """Host and device activity; ``host=False``: the device's alone (the
    host's where there is no card)."""
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(
        activities=[*([act.CPU] if host or not cuda else []),
                    *([act.CUDA] if cuda else [])])


def _profiled_batch(path, tr, j, new_tokens, cuda):
    """One batch with the profiler over ``PROFILE_STEPS`` generated steps
    (fewer when the batch is short); the reduced slice."""
    first = min(PROFILE_FIRST, new_tokens // 4)
    steps = min(PROFILE_STEPS, new_tokens - first)
    new_tokens = first + steps
    prof = _profiler(cuda)

    def after(i):
        if i == first:
            prof.start()
        elif i == first + steps:
            if cuda:
                torch.cuda.synchronize()
            prof.stop()

    path.run_batch(tr.prompts(j), new_tokens, after)
    return trace_mod.read(prof.profiler.kineto_results.events(), steps)


def run(name: str, seed: int, seconds: float, trace: bool, *, device=None,
        smoke: bool = False, traffic: dict | None = None, t_start=None,
        keep: bool = False, root: Path = BENCH) -> Outcome:
    """One run of cell ``name``.  ``smoke`` runs the configuration's family
    at its test width, ``traffic`` replaces the traffic file's parameters
    (both for the CPU tests); ``keep`` returns the check's inputs."""
    t_start = time.perf_counter() if t_start is None else t_start
    c = cell(name, root)
    spec = c["spec"]
    fam = load_module("families", spec["family"], root)
    if smoke:
        spec = fam.smoke(spec)
    ref = load_module("reference", spec["family"], root)
    flops = load_module("flops", spec["family"], root)
    tr = Traffic(traffic or c["traffic_params"], seed, fam.prompt_vocab(spec))
    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    clock = Clock(device)
    path_mod = load_module("paths", c["path"], root)
    e2e = end_to_end(c)
    device_time = not trace and "device_ms_per_token" in e2e

    cfg = fam.port_config(spec)
    weights = fam.make_weights(spec, seed, device)
    p_len, new = tr.prompt_len, tr.new_tokens
    path = path_mod.Path(cfg, weights, clients=tr.clients, max_len=p_len + new,
                         sampler=tr.sampler, top_k=tr.top_k, top_p=tr.top_p,
                         seed=seed, device=device, clock=clock)

    # Warm-up: one short batch at the cell's batch size, through every hook
    # the window uses.
    path.probe.spans = trace
    _timed_batch(path, tr.warmup_prompts(), 2, clock,
                 keep_rows=list(range(min(KEPT_ROWS_PER_BATCH, tr.clients))))
    if trace:  # the profiler's first start costs seconds: pay it here
        with _profiler(cuda):
            _timed_batch(path, tr.warmup_prompts(), 1, clock)
    path.probe.decodes, path.probe.samples = [], []
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    # The window: whole batches while the longest so far still fits; with
    # ``device_time`` each under its own profiler (one batch's operations
    # fit the profiler's buffers, a whole window's may not).  The
    # profiler's first start falls in the window, not in the set-up: it
    # delays the host and no operation on the device.
    batches, profs = [], []
    e0 = clock.stamp()
    end_ms, longest = 0.0, 0.0
    j = 0
    while True:
        rng = np.random.default_rng([int(seed) % (1 << 64), j, 3])
        rows = check.halves(tr.clients, KEPT_ROWS_PER_BATCH, rng)
        prompts, asks = tr.prompts(j), tr.asks(j)
        prof = _profiler(cuda, host=False) if device_time else None
        if prof is not None:
            prof.start()
        served, kept, stamps = _timed_batch(path, prompts, new, clock, rows)
        batches.append(dict(rows=rows, prompts=prompts, asks=asks,
                            served=served, kept=kept, stamps=stamps))
        j += 1
        clock.sync(stamps[-1])
        if prof is not None:
            if cuda:
                torch.cuda.synchronize()
            prof.stop()
            profs.append(prof)
        last = clock.ms(e0, stamps[-1])
        end_ms, longest = last, max(longest, last - end_ms)
        if end_ms + longest > seconds * 1e3:
            break
    path.probe.spans = False
    if cuda:
        torch.cuda.synchronize()

    # Tokens a request asked for count; a request's gaps are those between
    # its own tokens (its first token's wait is the prompt feed).
    tokens, gaps = 0, []
    fed_rows = []
    for b in batches:
        at = b["at"] = [clock.ms(e0, s) for s in b["stamps"]]
        tokens += int(b["asks"].sum())
        for i in range(1, len(at)):
            gaps += [at[i] - at[i - 1]] * int((b["asks"] > i).sum())
        fed_rows += [tr.clients] * p_len + [int((b["asks"] > i + 1).sum())
                                            for i in range(new)]
    steps_per_batch = p_len + new
    span_s = end_ms / 1e3

    # The device's busy time over the window's batches, every operation.
    busy_ns = sum(trace_mod.device_busy_ns(p.profiler.kineto_results.events())
                  for p in profs)
    del profs

    decodes = [clock.ms(s, e) for s, e in path.probe.decodes]
    samples = [clock.ms(s, e) for s, e in path.probe.samples]
    window_info = {
        "batches": len(batches),
        "batch_end_s": [round(b["at"][-1] / 1e3, 3) for b in batches],
        "span_s": span_s,
        "step_ms_median": stats.percentile(gaps, 50) if gaps else None,
    }

    the_slice = None
    if trace:
        path.probe.spans = True
        the_slice = _profiled_batch(path, tr, j, new, cuda)
        path.probe.spans = False
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # The check: free the program's state, then the reference.
    failed = sum(int(b["served"].shape != (tr.clients, new)
                     or not ((b["served"] >= 0) & (b["served"] < cfg.vocab)).all())
                 for b in batches)
    attempted = len(batches) * tr.clients
    reqs = [check.Request(r, b["prompts"][r], b["served"][r, :b["asks"][r]],
                          b["kept"][i, :b["asks"][r]])
            for b in batches for i, r in enumerate(b["rows"])]
    sample = check.draw(reqs, seed, CHECKED_REQUESTS, tr.clients)
    del reqs, batches
    path.free()
    del path
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_logits = check.reference_logits(ref, spec, weights, sample, device)
    numbers = {
        **check.decode_gaps(ref_logits, sample),
        "sampler_mismatch": check.sampler_mismatch(
            sample, sampler=tr.sampler, seed=seed, k=min(tr.top_k, cfg.vocab),
            p=tr.top_p),
    }
    correct, table = check.judge(numbers, c["limits"])
    window_info["numbers"] = numbers
    correct = correct and failed == 0

    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    if trace:
        view = View(
            seconds=span_s, clients=tr.clients, vocab=cfg.vocab,
            top_k=tr.top_k, sampler=tr.sampler, peaks=peaks.for_device(kind),
            decode_ms=decodes, sample_ms=samples,
            fed_positions=[idx % steps_per_batch
                           for idx in range(len(decodes))],
            fed_rows=fed_rows,
            flops_per_token=lambda pos: flops.per_token(spec, pos),
            slice=the_slice, tokens=tokens, gaps=gaps, end_to_end=e2e)
        metrics = {}
        for mname, mod in readers(root).items():
            value = mod.read(view)
            if value is not None:
                metrics[mname] = {"value": value, "unit": mod.UNIT}
        if the_slice is not None:
            dev["busy_s"] = the_slice.busy_s
            dev["window_s"] = the_slice.span_s
    else:
        values = {
            "decode_tok_s": lambda: stats.rate(tokens, span_s),
            "tpot_p95_ms": lambda: (stats.percentile(gaps, 95) if gaps
                                    else float("nan")),
            "setup_s": lambda: setup_s,
            # none where the device ran nothing: no card, no result
            "device_ms_per_token": lambda: (busy_ns * 1e-6 / tokens
                                            if busy_ns else None),
        }
        metrics = {name: {"value": v, "unit": E2E_UNITS[name]}
                   for name in e2e if (v := values[name]()) is not None}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and the_slice is not None:
        result["breakdown"] = {
            "device_ops": [list(kv) for kv in the_slice.device_ops()],
            "idle_gaps": [list(kv) for kv in the_slice.idle_gaps]}
    result["checks"] = table
    context = None
    if keep:
        context = dict(spec=spec, weights=weights, sample=sample, ref=ref,
                       ref_logits=ref_logits, device=device, numbers=numbers)
    return Outcome(result, context, window_info)


def check_lines(table: dict) -> list:
    return [f"check {name}: {v['value']!r} (limit {v['limit']!r})"
            for name, v in table.items()]
