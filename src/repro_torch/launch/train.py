"""Training launcher with restart from the latest checkpoint (torch port
of ``repro.launch.train``).

``python -m repro_torch.launch.train --arch granite-3-2b`` trains on the
card; ``--smoke --device cpu`` trains the reduced config on the CPU.

Every run starts by probing ``latest_step`` and restoring the params,
the optimizer state and the data position, so a process killed at any
point loses at most ``--ckpt-every`` steps (checkpoints are atomic; a
torn write is ignored).  Weights are random, from ``init_params`` with a
seeded generator; the data is the pipeline's synthetic stream, each
step's window of documents bucketed by length with the merge sort (on
the card: the grouped launch of ``merge_kway_tile``; with
``--external-threshold``, the external sort's windows).

``--metrics-dir`` turns on ``repro_torch.obs`` (a ``train.loss`` gauge a
step, JSONL under that directory); ``--profile-steps N`` adds a
``torch.profiler`` trace of the first N steps under
``<metrics-dir>/profile``.  The reference's HLO report reads XLA's
compiled program and has no counterpart here.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import obs
from repro_torch.checkpoint.checkpointer import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.launch.serve import ProfileWindow
from repro_torch.models.transformer import init_params
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import build_train_step


def _step_timer(device: torch.device):
    """``(start, stop)``: ``stop()`` returns the milliseconds since
    ``start()``, from CUDA events on the card (after a synchronise) and
    the host clock on the CPU."""
    if device.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        def stop():
            ev[1].record()
            ev[1].synchronize()
            return ev[0].elapsed_time(ev[1])

        return ev[0].record, stop
    t = [0.0]

    def start():
        t[0] = time.perf_counter()

    return start, lambda: (time.perf_counter() - t[0]) * 1e3


def main(argv=None):
    """Train; returns ``{"start", "losses", "gnorms", "step_ms"}``, one
    entry a step run here (the train step's time alone, without the
    batch's bucketing and packing)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--moe-dispatch", choices=("capacity", "dropless"),
                    default=None,
                    help="override ModelConfig.moe_dispatch (MoE archs)")
    ap.add_argument("--external-threshold", type=int, default=0,
                    help="bucket length-sort windows of >= N docs through "
                         "the out-of-core external sort "
                         "(repro_torch.external); 0 = always in-memory")
    ap.add_argument("--external-workdir", default="",
                    help="spill directory for --external-threshold "
                         "(default: per-process temp dir)")
    ap.add_argument("--metrics-dir", default="",
                    help="enable repro_torch.obs metrics; JSONL lands here "
                         "(overrides ModelConfig.metrics_dir)")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="write a torch.profiler trace of the first N "
                         "steps (under <metrics-dir>/profile)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model trains (default: the card)")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available "
                         "(pass --device cpu to train on the CPU)")
    device = torch.device(args.device)
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_config(cfg)
    cfg = dataclasses.replace(cfg, learning_rate=args.lr)
    if args.moe_dispatch is not None:
        cfg = dataclasses.replace(cfg, moe_dispatch=args.moe_dispatch)
    metrics_dir = args.metrics_dir or cfg.metrics_dir
    if metrics_dir:
        cfg = dataclasses.replace(cfg, metrics_dir=metrics_dir)
        obs.enable(metrics_dir=metrics_dir)
    try:
        return _train(cfg, args, device, metrics_dir)
    finally:
        if metrics_dir:
            obs.disable()


def _train(cfg, args, device, metrics_dir):
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    opt = adamw_init(params, dtype=getattr(torch, cfg.adam_dtype))
    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            restore_checkpoint(args.ckpt_dir, last,
                               {"params": params, "opt": opt})
            start = last
            print(f"[restore] resumed from step {last}")

    step_fn = build_train_step(cfg, total_steps=args.steps, warmup=10)
    dc = DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
        external_threshold=args.external_threshold,
        external_workdir=args.external_workdir,
    )
    stream = batches(dc, start_step=start, device=device)
    timer_start, timer_stop = _step_timer(device)
    profile = ProfileWindow(metrics_dir, args.profile_steps)

    t0 = time.time()
    out = {"start": start, "losses": [], "gnorms": [], "step_ms": []}
    for step in range(start, args.steps):
        batch = next(stream)
        model_batch = {k: batch[k] for k in ("tokens", "labels", "mask")}
        if cfg.frontend != "none":
            model_batch["frontend_embeds"] = torch.zeros(
                (args.batch, cfg.frontend_tokens, cfg.d_model),
                dtype=torch.bfloat16, device=device)
        obs.set_step(step)
        with obs.step_span("train", step):
            timer_start()
            params, opt, metrics = step_fn(params, opt, model_batch, step)
            out["step_ms"].append(timer_stop())
            out["losses"].append(float(metrics["loss"]))
            out["gnorms"].append(float(metrics["gnorm"]))
        if obs.enabled():
            obs.gauge("train.loss", out["losses"][-1])
            obs.flush()
        profile.after(step + 1 - start)
        if (step + 1) % args.log_every == 0:
            tps = args.batch * args.seq * args.log_every / (time.time() - t0)
            print(f"step {step + 1:5d}  loss {out['losses'][-1]:.4f}  "
                  f"gnorm {out['gnorms'][-1]:.3f}  "
                  f"lr {float(metrics['lr']):.2e}  tok/s {tps:,.0f}",
                  flush=True)
            t0 = time.time()
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1,
                            {"params": params, "opt": opt})
            print(f"[ckpt] step {step + 1}")

    profile.close()
    if obs.enabled():
        obs.flush()
    if out["losses"]:
        print(f"final loss {out['losses'][-1]:.4f} "
              f"(start {out['losses'][0]:.4f})")
    return out


if __name__ == "__main__":
    main()
