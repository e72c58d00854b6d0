"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake
tensors (torch port of ``repro.launch.dryrun``).

For each cell this makes a ``"fake"`` process group of 256 or 512 ranks
(this process is rank 0) and the production ``DeviceMesh`` (16x16 or
2x16x16), builds fake DTensor stand-ins for params / optimizer state /
batch / cache with the real sharding trees (nothing is ever allocated),
and runs the real train step, prefill or decode step once (a train
step's microbatches past the second replay the second's trace), under
:class:`~repro_torch.launch.sharding.Partitioner` (which lets DTensor
shard the unmodified step), :class:`~repro_torch.launch.hlo_stats.
TraceStats` (per-device dot FLOPs, bytes, collective bytes and the peak of live
bytes, counted on rank 0's local shards).  The group is made before ``FakeTensorMode`` is entered.

The record has the reference's keys and layout, one JSON per cell, under
``results/dryrun_torch/`` (never ``results/dryrun/``):
``memory.argument_size_in_bytes`` is the per-device bytes of the step's
inputs, ``temp_size_in_bytes`` the tracked peak minus the arguments;
``cost.flops`` the per-device dot FLOPs; ``collectives`` and ``weighted``
as ``hlo_stats`` gives them; ``trace_s`` replaces ``compile_s`` (there is
no compile) and ``repairs`` counts the partitioner's re-placements.  The
reference's ``normalize_cost_analysis`` has no counterpart: there is no
``cost_analysis()`` to normalise.

Usage:
  python -m repro_torch.launch.dryrun --all                     # every cell, both meshes
  python -m repro_torch.launch.dryrun --all --workers 7         # 7 cells at a time
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all --device cpu        # fake CPU tensors
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS, cell_runnable, input_specs
from repro_torch.launch.hlo_stats import TraceStats
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import Partitioner, distribute, map_specs
from repro_torch.models import layers as model_layers
from repro_torch.models.layers import P
from repro_torch.models.transformer import (
    Cache,
    cache_specs,
    compute_params,
    decode_step,
    init_params,
    param_specs,
    prefill_logits,
)
from repro_torch.train import train_step as train_step_mod
from repro_torch.train.optimizer import AdamWState
from repro_torch.train.train_step import build_train_step

__all__ = [
    "RESULTS_DIR",
    "GRAD_ACCUM",
    "MESHES",
    "fake_process_group",
    "effective_batch_axes",
    "sanitize_specs",
    "build_cell",
    "place_cell",
    "step_fn",
    "real_inputs",
    "local_bytes",
    "trace_cell",
    "run_cell",
    "main",
]

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../results/dryrun_torch")

# Per-cell gradient-accumulation overrides (the reference's): keep
# per-microbatch activation memory inside HBM.
GRAD_ACCUM = {
    ("deepseek-67b", "train_4k"): 16,
    ("qwen1.5-110b", "train_4k"): 16,
    ("deepseek-v3-671b", "train_4k"): 32,
    ("dbrx-132b", "train_4k"): 16,
    ("internvl2-26b", "train_4k"): 8,
    ("musicgen-medium", "train_4k"): 2,
    ("granite-3-2b", "train_4k"): 2,
    ("zamba2-1.2b", "train_4k"): 2,
    ("mamba2-2.7b", "train_4k"): 2,
}

#: multi_pod -> (mesh shape, axis names): the production meshes.
MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def fake_process_group(world_size: int) -> None:
    """Make the default process group a ``"fake"`` one of ``world_size``
    ranks with this process as rank 0 (re-made when the size differs).
    Collectives on it complete at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _sizes(mesh) -> dict:
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def effective_batch_axes(mesh, batch: int, layout: str = "tp"):
    """Greedy prefix of the DP-capable axes whose product divides the
    batch.  ``layout='fsdp'`` adds ``model`` to the pool."""
    pool = ("pod", "data", "model") if layout == "fsdp" else ("pod", "data")
    sizes = _sizes(mesh)
    axes, prod = [], 1
    for a in pool:
        if a in sizes and batch % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return tuple(axes)


def sanitize_specs(tree, spec_tree, mesh):
    """Drop sharding on any axis that does not evenly divide the dim
    (vocab 49155 or 24 heads on a 16-wide model axis, ``n_kv`` 8 < 16):
    those dims replicate on that axis, so DTensor never pads a shard."""
    sizes = _sizes(mesh)

    def fix(spec, t):
        entries = list(spec) + [None] * (t.dim() - len(spec))
        out = []
        for dim, entry in zip(t.shape, entries):
            if entry is None:
                out.append(None)
                continue
            axs = entry if isinstance(entry, (tuple, list)) else (entry,)
            prod, kept = 1, []
            for a in axs:
                if a in sizes and dim % (prod * sizes[a]) == 0:
                    kept.append(a)
                    prod *= sizes[a]
            out.append(tuple(kept))  # P makes (a,) a and () None
        return P(*out)

    return map_specs(fix, spec_tree, tree)


def _fake_like(t, device):
    return torch.empty(t.shape, dtype=t.dtype, device=device)


def local_bytes(tree) -> int:
    """Bytes of this rank's local shards of every tensor in ``tree``."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    total = 0
    for t in tree_leaves(_plain(tree)):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if isinstance(t, DTensor) else t
            total += loc.numel() * loc.element_size()
    return total


def _plain(tree):
    """``tree`` with Caches and NamedTuples as tuples (pytree leaves)."""
    if isinstance(tree, Cache):
        return (tree.data, tree.length)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: dict | None = None, *, device: str = "cuda",
               fake_mode=None, mesh=None):
    """Returns ``(mesh, cfg, fn, args)`` for one cell: ``args`` are fake
    DTensors made under ``fake_mode``, ``fn(*args)`` is the step.  The
    fake process group and the mesh are made here (before ``fake_mode``
    is entered) unless ``mesh`` is given."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    merged = {"grad_accum": GRAD_ACCUM.get((arch, shape_name), 1)}
    merged.update(overrides or {})
    cfg = dataclasses.replace(cfg, **merged)
    if mesh is None:
        dims, axes = MESHES[multi_pod]
        fake_process_group(math.prod(dims))
        mesh = make_mesh(dims, axes, device_type=device)
    fake_mode = fake_mode or FakeTensorMode()
    meta = init_params(cfg, None, device="meta")
    with fake_mode:
        args = place_cell(cfg, shape, mesh, _stand_ins(cfg, shape, meta, device))
    return mesh, cfg, step_fn(cfg, shape.kind), args


def _stand_ins(cfg, shape, meta, device):
    """Empty tensors on ``device`` in :func:`real_inputs`' structure."""
    params = map_specs(lambda _, t: _fake_like(t, device), param_specs(cfg),
                       meta)
    batch = input_specs(cfg, shape, device=device)
    if shape.kind == "decode":
        return params, batch["cache"], batch["tokens"]
    if shape.kind == "prefill":
        return params, batch
    adam = getattr(torch, cfg.adam_dtype)
    moments = [map_specs(lambda _, t: torch.empty(t.shape, dtype=adam,
                                                  device=device),
                         param_specs(cfg), meta) for _ in range(2)]
    step = torch.zeros((), dtype=torch.int32, device=device)
    return params, AdamWState(step=step.clone(), m=moments[0], v=moments[1]), \
        batch, step


def place_cell(cfg, shape, mesh, inputs):
    """The step's inputs (:func:`real_inputs`' structure, real or fake)
    placed on ``mesh`` as DTensors: params and moments by their sanitized
    specs, the batch, tokens and cache rows over the batch axes
    (:func:`effective_batch_axes`, which also become the model's
    activation constraints), the cache's positions over ``model``
    (``cache_specs``); scalars stay plain tensors."""
    ba = effective_batch_axes(mesh, shape.global_batch, cfg.layout)
    model_layers.set_batch_axes(ba)  # residual-stream constraints
    params = inputs[0]
    pspecs = sanitize_specs(params, param_specs(cfg), mesh)
    placed = distribute(params, pspecs, mesh)

    def rows(tree):
        return distribute(tree, {k: P(ba, *(None,) * (v.dim() - 1))
                                 for k, v in tree.items()}, mesh)

    if shape.kind == "decode":
        _, cache, tokens = inputs
        cspecs = sanitize_specs(cache, cache_specs(cfg, ba), mesh)
        return (placed, Cache(cache.kind, distribute(cache.data, cspecs.data,
                                                     mesh), cache.length),
                distribute(tokens, P(ba, None), mesh))
    if shape.kind == "prefill":
        return placed, rows(inputs[1])
    _, opt, batch, step = inputs
    opt = AdamWState(step=opt.step, m=distribute(opt.m, pspecs, mesh),
                     v=distribute(opt.v, pspecs, mesh))
    return placed, opt, rows(batch), step


def step_fn(cfg, kind: str):
    """The step a cell of ``kind`` runs: the train step, the prefill
    logits, or a decode step (casting the stored params as it goes)."""
    if kind == "train":
        return build_train_step(cfg)
    if kind == "prefill":
        def pf(params, batch):
            return prefill_logits(cfg, params, batch["tokens"],
                                  batch.get("frontend_embeds"))
        return pf

    def dc(params, cache, tokens):
        return decode_step(cfg, compute_params(cfg, params), cache, tokens)
    return dc


def real_inputs(cfg, shape, *, device, seed: int = 0, cache_dtype=None):
    """Real tensors for ``build_cell``'s step of ``cfg`` at ``shape``, in
    the stand-ins' structure, shapes and dtypes (a calibration run, or the
    same cell on real ranks): seeded params, zero moments, random tokens
    and an all-ones mask; a decode cache of random values (``cache_dtype``,
    bf16 as the stand-ins by default) filled to half its depth."""
    from repro_torch.models.transformer import init_cache
    from repro_torch.train.optimizer import adamw_init

    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device=device)
    b, s = shape.global_batch, shape.seq_len

    def tokens(n):
        return torch.randint(0, cfg.vocab, (b, n), generator=gen,
                             dtype=torch.int32, device=device)

    if shape.kind == "decode":
        cache = init_cache(cfg, b, s, dtype=cache_dtype or torch.bfloat16,
                           device=device)
        for t in cache.data:
            t.copy_(torch.randn(t.shape, generator=gen, device=device))
        length = torch.tensor(s // 2, dtype=torch.int32, device=device)
        return params, Cache(cache.kind, cache.data, length), tokens(1)
    batch = {"tokens": tokens(s), "labels": tokens(s),
             "mask": torch.ones((b, s), device=device)}
    if cfg.frontend != "none":
        batch["frontend_embeds"] = torch.randn(
            (b, cfg.frontend_tokens, cfg.d_model), generator=gen,
            device=device).to(torch.bfloat16)
    if shape.kind == "prefill":
        return params, batch
    opt = adamw_init(params, dtype=getattr(torch, cfg.adam_dtype))
    return params, opt, batch, torch.zeros((), dtype=torch.int32,
                                           device=device)


class _MicrobatchReplay:
    """Within a train step of ``grad_accum`` microbatches, traces the
    first two microbatches' ``loss_and_grads`` and replays the second's
    result (and counts) for the rest: all microbatches have one shape, so
    the counts are those of tracing each, and the second (the first with
    the float32 accumulators live) holds the step's peak."""

    def __init__(self, stats):
        self.stats = stats
        self.calls = 0
        self.second = None

    def __enter__(self):
        self._orig = train_step_mod.loss_and_grads
        train_step_mod.loss_and_grads = self._call
        return self

    def __exit__(self, *exc):
        train_step_mod.loss_and_grads = self._orig

    def _call(self, *args, **kwargs):
        self.calls += 1
        if self.calls <= 2:
            before = self.stats.snapshot()
            out = self._orig(*args, **kwargs)
            if self.calls == 2:
                self.second = (out, self.stats.delta(before))
            return out
        out, delta = self.second
        self.stats.add(delta)
        return out


def trace_cell(mesh, fn, args, fake_mode, *, by_op: bool = False):
    """Run ``fn(*args)`` once under ``fake_mode`` with the partitioner and
    the counters (``args`` tracked as live; ``by_op`` keeps the FLOPs of
    every product, see :class:`TraceStats`).  Returns ``(stats,
    partitioner, peak live bytes, seconds)``."""
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_leaves

    from repro_torch.kernels.merge import register_dtensor_rules

    register_dtensor_rules()
    stats = TraceStats(by_op=by_op, fake_mode=fake_mode)
    part = Partitioner(stats)
    replay = _MicrobatchReplay(stats)
    t0 = time.time()
    # DTensor derives output shapes by running each op on global fake
    # tensors under the ambient fake mode; a tracing context hands it a
    # fake mode of its own, so the counters (which count only ops on
    # ``fake_mode``'s tensors) skip that work, as they do in a real run.
    with fake_mode, tracing(TracingContext(FakeTensorMode())):
        stats.track(*[t for t in tree_leaves(_plain(args))
                      if isinstance(t, torch.Tensor)])
        with stats, part, replay:
            fn(*args)
    return stats, part, stats.peak, time.time() - t0


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             force: bool = False, overrides: dict | None = None,
             tag: str = "", *, device: str = "cuda", mesh=None) -> dict:
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_tag}" + (f"__{tag}" if tag else "")
    out_path = os.path.join(out_dir, cell_id + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg0 = ARCHS[arch]
    shape = SHAPES[shape_name]
    ok, why = cell_runnable(cfg0, shape)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "params": cfg0.param_count(),
        "active_params": cfg0.active_param_count(),
        "device_type": device,
    }
    if not ok:
        rec.update(status="skipped", reason=why)
    else:
        try:
            fake = FakeTensorMode()
            mesh_, cfg, fn, args = build_cell(
                arch, shape_name, multi_pod, overrides, device=device,
                fake_mode=fake, mesh=mesh)
            arg_bytes = local_bytes(args)
            stats, part, peak, trace_s = trace_cell(mesh_, fn, args, fake)
            fb = stats.flops_bytes()
            rec.update(
                status="ok",
                trace_s=round(trace_s, 2),
                grad_accum=cfg.grad_accum,
                memory={"argument_size_in_bytes": arg_bytes,
                        "temp_size_in_bytes": max(peak - arg_bytes, 0)},
                cost={"flops": float(fb["flops"]),
                      "bytes accessed": float(fb["bytes"])},
                collectives=stats.collective_bytes(),
                weighted=fb,
                repairs=part.repairs,
            )
        except Exception as e:  # record failures: they are faults to fix
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       trace=_short_trace(e))
        finally:
            model_layers.set_batch_axes(None)
    os.makedirs(out_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    status = rec["status"]
    extra = ""
    if status == "ok":
        arg_gb = rec["memory"]["argument_size_in_bytes"] / 2**30
        tmp_gb = rec["memory"]["temp_size_in_bytes"] / 2**30
        extra = (f" args={arg_gb:.2f}GiB temp={tmp_gb:.2f}GiB "
                 f"coll={rec['collectives']['total_bytes'] / 2**30:.2f}GiB "
                 f"trace={rec['trace_s']:.0f}s")
    print(f"[{cell_id}] {status}{extra}", flush=True)
    return rec


def _short_trace(e) -> str:
    """The traceback's frames in this package, then the last frame and
    the error: what locates a fault, in at most 3000 characters."""
    frames = traceback.extract_tb(e.__traceback__)
    keep = [f for f in frames if "repro_torch" in f.filename] + frames[-1:]
    text = "".join(traceback.format_list(keep))
    return (text + f"{type(e).__name__}: {e}")[-3000:]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (python literal), for "
                         "variants; requires --tag")
    ap.add_argument("--tag", default="", help="variant tag for the JSON name")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type of the fake tensors and the mesh")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells traced at once, one subprocess each")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v

    meshes = []
    if args.multi_pod or not args.single_pod:
        meshes.append(True)
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    meshes = sorted(set(meshes))  # False (single) first

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    if args.all:
        archs, shapes = sorted(ARCHS), list(SHAPES)

    cells = [(arch, shape, mp) for arch in archs for shape in shapes
             for mp in meshes]
    t0 = time.time()
    if args.workers > 1:
        recs = _run_parallel(cells, args, argv)
    else:
        recs = [run_cell(arch, shape, mp, args.out, force=args.force,
                         overrides=overrides or None, tag=args.tag,
                         device=args.device) for arch, shape, mp in cells]
    n_bad = sum(rec["status"] == "error" for rec in recs)
    print(f"done; {n_bad} errors ({len(recs)} cells in "
          f"{time.time() - t0:.1f} s wall, {args.workers} at a time)")
    raise SystemExit(1 if n_bad else 0)


def _run_parallel(cells, args, argv) -> list:
    """Every cell in its own ``python -m repro_torch.launch.dryrun``
    subprocess, ``args.workers`` at a time, train cells first (the longest
    traces overlap); each child prints its cell's line as it ends."""
    import subprocess
    import sys

    kind = {"train": 0, "prefill": 1, "decode": 2}
    queue = sorted(cells, key=lambda c: (kind[SHAPES[c[1]].kind], c))[::-1]
    keep = []  # the caller's flags but the selection and the workers
    skip = {"--arch", "--shape", "--workers"}
    flags = list(argv if argv is not None else sys.argv[1:])
    while flags:
        flag = flags.pop(0)
        if flag in skip:
            flags.pop(0)
        elif flag not in ("--all", "--multi-pod", "--single-pod"):
            keep.append(flag)
    running, recs = [], []
    while queue or running:
        while queue and len(running) < args.workers:
            arch, shape, mp = queue.pop()
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                   arch, "--shape", shape,
                   "--multi-pod" if mp else "--single-pod", *keep]
            running.append(((arch, shape, mp), subprocess.Popen(cmd)))
        time.sleep(0.5)
        for item in [r for r in running if r[1].poll() is not None]:
            running.remove(item)
            (arch, shape, mp), _ = item
            mesh_tag = "pod2x16x16" if mp else "pod16x16"
            cell_id = f"{arch}__{shape}__{mesh_tag}" + (
                f"__{args.tag}" if args.tag else "")
            path = os.path.join(args.out, cell_id + ".json")
            recs.append(json.load(open(path)) if os.path.exists(path) else
                        {"status": "error", "error": "no record written"})
    return recs


if __name__ == "__main__":
    main()
