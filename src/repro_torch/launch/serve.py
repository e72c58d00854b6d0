"""Serving launcher: continuous-batching decode with merge-based sampling
(torch port of ``repro.launch.serve``, its continuous path).

``python -m repro_torch.launch.serve --arch qwen3-0.6b`` serves on the
card; ``--smoke --device cpu`` serves the reduced config on the CPU.

Requests arrive staggered (``--arrival-every`` engine steps apart) and are
admitted into free KV-pool slots between decode steps by the
:class:`~repro_torch.serving.engine.DecodeEngine`: one ragged step
advances every active slot a token at its own position, and the whole
batch's next tokens are drawn with the batched merge sampler.  Finished
slots are recycled at once.  Weights are random, from ``init_params``
with a seeded generator.

Only the ``gqa`` cache family is served.  The reference serves MLA and
SSM/hybrid archs on a lock-step batch path, which is not ported yet: for
those archs this launcher raises.  The reference's ``--metrics-dir``,
``--profile-steps`` and ``--moe-dispatch`` wait for the ``obs`` and MoE
ports.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.models.transformer import cache_kind, init_params
from repro_torch.serving import DecodeEngine, Request


def _serve_continuous(cfg, params, args, device):
    """Continuous-batching path (gqa-cache archs)."""
    max_len = args.prompt_len + args.tokens
    eng = DecodeEngine(
        cfg, params, max_len=max_len,
        max_batch=args.max_batch or cfg.max_batch,
        queue_depth=args.queue_depth or cfg.queue_depth,
        sampler=args.sampler, top_k=min(50, cfg.vocab),
        seed=args.seed, device=device,
    )
    rng = np.random.default_rng(0)
    arrivals = [
        (i * args.arrival_every,
         Request(i, rng.integers(1, cfg.vocab, args.prompt_len,
                                 dtype=np.int32), args.tokens))
        for i in range(args.requests)
    ]

    t0 = time.time()
    i = 0
    while True:
        while i < len(arrivals) and arrivals[i][0] <= eng.steps:
            if not eng.submit(arrivals[i][1]):
                break  # queue at depth: retry after the next step
            i += 1
        if eng.pending == 0 and i == len(arrivals):
            break
        info = eng.step()
        if info["completed"] and args.verbose:
            print(f"step {eng.steps}: finished rids {info['completed']} "
                  f"(active {info['active']})")

    dt = time.time() - t0
    results = eng.results
    total = sum(len(t) for t in results.values())
    print(f"served {len(results)} requests / {total} tokens in "
          f"{eng.steps} steps, {dt:.2f}s ({total / dt:.1f} tok/s) on {device}")
    for rid in sorted(results)[:2]:
        print(f"  rid{rid}: {results[rid][:16]}...")
    eng.scheduler.check_invariants()
    eng.pool.check_invariants()
    return results


def _serve_lockstep(cfg):
    """The reference's fixed-batch decode for MLA / SSM / hybrid caches."""
    raise NotImplementedError(
        f"{cfg.name}: the {cache_kind(cfg)!r} cache is served by the "
        f"lock-step decode path, which is not ported yet (ROADMAP.md, "
        f"Queue 1 item 3)"
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=8,
                    help="requests to serve")
    ap.add_argument("--arrival-every", type=int, default=2,
                    help="engine steps between request arrivals")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="KV pool slots (0 = ModelConfig.max_batch)")
    ap.add_argument("--queue-depth", type=int, default=0,
                    help="queue bound (0 = ModelConfig.queue_depth)")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=32,
                    help="max new tokens per request")
    ap.add_argument("--sampler", choices=["greedy", "topk", "topp"],
                    default="topk")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced same-family config")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model runs (default: the card)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available "
                         "(pass --device cpu to serve on the CPU)")
    device = torch.device(args.device)
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_config(cfg)
    if cache_kind(cfg) != "gqa":
        return _serve_lockstep(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device=device)
    return _serve_continuous(cfg, params, args, device)


if __name__ == "__main__":
    main()
