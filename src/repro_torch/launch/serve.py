"""Serving launcher: continuous-batching decode with merge-based sampling
(torch port of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch qwen3-0.6b`` serves on the
card; ``--smoke --device cpu`` serves the reduced config on the CPU.

Archs with a ``gqa`` decode cache (dense and MoE) take the continuous
path: requests arrive staggered (``--arrival-every`` engine steps apart)
and are admitted into free KV-pool slots between decode steps by the
:class:`~repro_torch.serving.engine.DecodeEngine`: one ragged step
advances every active slot a token at its own position, and the whole
batch's next tokens are drawn with the batched merge sampler.  Finished
slots are recycled at once.

Archs with an ``mla`` cache (deepseek-v3), an ``ssm`` cache (mamba2) or
a ``hybrid`` one (zamba2) take the lock-step path
(:class:`LockstepDecoder`): a fixed batch of ``max_batch`` rows starts
together, the prompt is fed one token per ``decode_step``, and each row's
tokens are drawn with the per-request samplers; on the card, for a model
without MoE layers, the step is replayed as one captured CUDA graph.
``--moe-dispatch`` overrides the MoE configs' dispatch.  Weights are
random, from ``init_params`` with a seeded generator.

``--metrics-dir`` turns on ``repro_torch.obs`` (JSONL records under that
directory, stamped with the decode step and flushed once a step);
``--profile-steps N`` adds a ``torch.profiler`` trace of the first N
steps under ``<metrics-dir>/profile``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.models.transformer import (
    Cache,
    cache_kind,
    compute_params,
    decode_step,
    decode_step_capturable,
    decode_step_tables,
    init_cache,
    init_params,
)
from repro_torch.serving import DecodeEngine, Request
from repro_torch.serving.sampling import (
    request_keys,
    sample_greedy,
    sample_topp,
)
# The lock-step ``topk`` sampler is the batched form, one tournament and one
# draw for the whole batch; it keeps the name ``sample_topk`` here, which
# ``portbench``'s planted-fault test patches.
from repro_torch.serving.sampling import sample_topk_batched as sample_topk


class ProfileWindow:
    """The ``--profile-steps`` window: a trace of a launcher's first
    ``steps`` steps under ``<metrics_dir>/profile``."""

    def __init__(self, metrics_dir: str, steps: int):
        self.steps = steps
        self.on = steps > 0 and obs.start_profile(
            os.path.join(metrics_dir or ".", "profile"))

    def after(self, done: int) -> None:
        if self.on and done >= self.steps:
            self.close()

    def close(self) -> None:
        if self.on:
            obs.stop_profile()
            self.on = False


def _serve_continuous(cfg, params, args, device, metrics_dir=""):
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

    profile = ProfileWindow(metrics_dir, args.profile_steps)
    t0 = time.time()
    i = 0
    while True:
        while i < len(arrivals) and arrivals[i][0] <= eng.steps:
            if not eng.submit(arrivals[i][1]):
                break  # queue at depth: retry after the next step
            i += 1
        if eng.pending == 0 and i == len(arrivals):
            break
        obs.set_step(eng.steps)
        with obs.step_span("decode", eng.steps):
            info = eng.step()
        if obs.enabled():
            obs.flush()
        profile.after(eng.steps)
        if info["completed"] and args.verbose:
            print(f"step {eng.steps}: finished rids {info['completed']} "
                  f"(active {info['active']})")
    profile.close()
    if obs.enabled():
        obs.flush()

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


@dataclasses.dataclass
class _StepGraph:
    """One ``decode_step`` captured as a CUDA graph.  ``key`` is what the
    graph is bound to (:func:`_step_key`), ``params`` the tree it reads,
    held so that the key's identity of it stays unique; ``tables`` the
    position tables it reads (:func:`decode_step_tables`), held so that
    their cache cannot free them; ``tokens`` ``(batch, 1)`` int64 and
    ``length`` are the buffers it reads, ``length`` advanced by one on
    every replay; ``logits`` is the buffer every replay writes.  Dropping
    the object frees the graph and its private memory pool."""

    key: tuple
    params: dict
    tables: tuple
    tokens: torch.Tensor
    length: torch.Tensor
    graph: torch.cuda.CUDAGraph
    logits: torch.Tensor


def _step_key(params, cache, tokens) -> tuple | None:
    """What a captured decode step is bound to: the identity of
    ``params``, the cache's kind, the tokens' shape and, for every cache
    tensor, its address, shape, strides and dtype.  A graph replays only
    while all of these are equal, so a cache made anew elsewhere (or
    resized) is captured again.  ``None`` where a cache tensor or the
    length is not a plain CUDA tensor (a DTensor, a fake or CPU tensor)."""
    if type(cache.length) is not torch.Tensor:
        return None
    key = [id(params), cache.kind, tuple(tokens.shape)]
    for t in cache.data:
        if type(t) is not torch.Tensor or not t.is_cuda:
            return None
        key.append((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype))
    return tuple(key)


class LockstepDecoder:
    """Fixed-batch decode over one cache of ``batch`` rows: every row
    starts together, the prompt is fed one token per ``decode_step`` and
    then every row samples a token per step, ``topk`` in one batched
    tournament and one draw for the whole batch.  Row ``b``'s draw at
    token index ``i`` uses the key ``request_keys(seed, b, i)``; ``topp`` keeps
    the reference's nucleus of 0.9 over 64 candidates, and the cache is
    bfloat16, as in the reference.  ``params`` is the model's tree on
    ``device`` (the params' device by default).

    On the card the decode step is replayed as one CUDA graph where it
    can be: the device is CUDA, the cache's tensors are plain tensors, the
    model says the step on that cache can be captured
    (:func:`decode_step_capturable`) and obs is off (so every record
    point fires each step while it is on).  The first step on a cache runs eagerly on the stream the capture
    uses; the next captures ``decode_step`` and every later one replays
    it, for as long as the cache's storage is the same (:func:`_step_key`;
    the graph keeps no reference to the cache).  ``graph_captures`` and
    ``graph_replays`` count both; the ``serve.graph_capture`` and
    ``serve.graph_replay`` spans cover them.  Everywhere else each step
    runs ``decode_step`` eagerly."""

    def __init__(self, cfg, params, *, batch: int, max_len: int,
                 sampler: str = "topk", top_k: int = 50, seed: int = 42,
                 device=None):
        if sampler not in ("greedy", "topk", "topp"):
            raise ValueError(f"unknown sampler {sampler!r}")
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else (
            params["embed"]["table"].device)
        self.params = compute_params(cfg, params)
        self.cache = init_cache(cfg, batch, max_len, device=self.device)
        self.batch = batch
        self.sampler = sampler
        self.top_k = min(top_k, cfg.vocab)
        self.seed = seed
        self.graph_captures = 0
        self.graph_replays = 0
        self._graph = None  # the captured step (_StepGraph)
        self._warm = None  # the key of the last step run on _stream
        self._stream = None

    def _decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """One model step: ``(batch, vocab)`` float32 logits, the cache
        advanced in place.  Replays the captured step where the decoder
        can (see the class), else runs :meth:`_step`."""
        key = None
        if (self.device.type == "cuda" and not obs.enabled()
                and decode_step_capturable(self.cfg, self.cache)):
            key = _step_key(self.params, self.cache, tokens)
        if key is None:
            return self._step(tokens)
        if self._graph is not None and self._graph.key != key:
            self._graph = None  # bound to storage that has gone
        if self._graph is None:
            if self._warm != key:
                return self._warm_step(key, tokens)
            self._capture(key, tokens)
        return self._replay(tokens)

    def _step(self, tokens: torch.Tensor) -> torch.Tensor:
        logits, self.cache = decode_step(self.cfg, self.params, self.cache,
                                         tokens)
        return logits

    def _warm_step(self, key, tokens):
        """An eager step on the capture stream, so that what the first
        call sets up (the kernels' build, the BLAS handles and workspaces,
        the rope tables) is made outside the capture."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        here = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(here)
        with torch.cuda.stream(self._stream):
            logits = self._step(tokens)
        here.wait_stream(self._stream)
        self._warm = key
        return logits

    def _capture(self, key, tokens) -> None:
        cache = self.cache
        toks = torch.empty(tuple(tokens.shape), dtype=torch.long,
                           device=self.device)
        length = torch.empty_like(cache.length, device=self.device)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        with obs.span("serve.graph_capture"), torch.cuda.stream(self._stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                logits, out = decode_step(
                    self.cfg, self.params,
                    Cache(cache.kind, cache.data, length), toks)
                length.copy_(out.length)
            finally:
                graph.capture_end()
        if len(out.data) != len(cache.data) or any(
                a is not b for a, b in zip(out.data, cache.data)):
            raise RuntimeError(f"{self.cfg.name}: decode_step returned new "
                               "cache tensors; a replay needs them updated "
                               "in place")
        tables = decode_step_tables(self.cfg, cache, toks.device)
        self._graph = _StepGraph(key, self.params, tables, toks, length,
                                 graph, logits)
        self.graph_captures += 1

    def _replay(self, tokens):
        """The captured step on this step's tokens and the cache's length;
        the logits are copied out, so no later step overwrites them."""
        g = self._graph
        with obs.span("serve.graph_replay"):
            g.tokens.copy_(tokens)
            if self.cache.length is not g.length:
                g.length.copy_(self.cache.length)
                self.cache = Cache(self.cache.kind, self.cache.data, g.length)
            g.graph.replay()
            self.graph_replays += 1
            return g.logits.clone()

    def _sample(self, keys: torch.Tensor, logits: torch.Tensor):
        if self.sampler == "greedy":
            return sample_greedy(logits)
        if self.sampler == "topk":
            return sample_topk(keys, logits, k=self.top_k,
                               fanout=self.cfg.fanout)
        return sample_topp(keys, logits, p=0.9, k=min(64, self.cfg.vocab),
                           fanout=self.cfg.fanout)

    def generate(self, prompts: np.ndarray, n_tokens: int,
                 after_step=None) -> np.ndarray:
        """``prompts`` ``(batch, prompt_len)`` -> ``(batch, n_tokens)``
        generated token ids; the cache ends at ``prompt_len + n_tokens``.
        The prompt feed runs in the ``serve.prefill`` host span and each
        generated step (sample, then decode) in ``step_span("decode", i)``;
        every model step sits in a ``serve.decode`` span and every
        sampling, key hash included, in a ``serve.sample`` span.  Every
        model step has the step label set: prompt position t of P is step
        t - P, so the feed's records precede step 0's.  Each generated
        step has its tokens recorded (``serve.sampled_tokens``, a snapshot
        on the device); obs is flushed after each step, then
        ``after_step(i + 1)`` is called if given."""
        tokens = torch.from_numpy(np.asarray(prompts, np.int64)).to(self.device)
        logits = None
        n_prompt = tokens.shape[1]
        with obs.host_span("serve.prefill"):
            for t in range(n_prompt):
                obs.set_step(t - n_prompt)
                with obs.span("serve.decode"):
                    logits = self._decode(tokens[:, t:t + 1])
        rows = torch.arange(self.batch, device=self.device)
        out = []
        for i in range(n_tokens):
            obs.set_step(i)
            with obs.step_span("decode", i):
                with obs.span("serve.sample"):
                    nxt = self._sample(request_keys(
                        self.seed, rows, torch.full_like(rows, i)), logits)
                out.append(nxt)
                obs.gauge("serve.sampled_tokens", nxt, batch=self.batch)
                with obs.span("serve.decode"):
                    logits = self._decode(nxt[:, None].long())
            if obs.enabled():
                obs.flush()
            if after_step is not None:
                after_step(i + 1)
        return torch.stack(out, dim=1).cpu().numpy()


def _serve_lockstep(cfg, params, args, device, metrics_dir=""):
    """Lock-step path (mla, ssm and hybrid caches): the reference's fixed
    batch."""
    batch = args.max_batch or cfg.max_batch
    max_len = args.prompt_len + args.tokens
    dec = LockstepDecoder(cfg, params, batch=batch, max_len=max_len,
                          sampler=args.sampler, top_k=50, seed=args.seed,
                          device=device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (batch, args.prompt_len))
    profile = ProfileWindow(metrics_dir, args.profile_steps)
    t0 = time.time()
    gen = dec.generate(prompts, args.tokens, after_step=profile.after)
    dt = time.time() - t0
    profile.close()
    if obs.enabled():
        obs.flush()
    print(f"generated {gen.shape} tokens in {dt:.2f}s "
          f"({batch * args.tokens / dt:.1f} tok/s) on {device} [lock-step]")
    for b in range(min(batch, 2)):
        print(f"  seq{b}: {gen[b][:16].tolist()}...")
    if int(dec.cache.length) != max_len:
        raise RuntimeError(f"lock-step cache at {int(dec.cache.length)}, "
                           f"expected {max_len}")
    return {b: gen[b].tolist() for b in range(batch)}


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
    ap.add_argument("--moe-dispatch", choices=("capacity", "dropless"),
                    default=None,
                    help="override ModelConfig.moe_dispatch (MoE archs)")
    ap.add_argument("--metrics-dir", default="",
                    help="enable repro_torch.obs metrics; JSONL lands here "
                         "(overrides ModelConfig.metrics_dir)")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="write a torch.profiler trace of the first N "
                         "decode steps (under <metrics-dir>/profile)")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available "
                         "(pass --device cpu to serve on the CPU)")
    device = torch.device(args.device)
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.moe_dispatch is not None:
        cfg = dataclasses.replace(cfg, moe_dispatch=args.moe_dispatch)
    metrics_dir = args.metrics_dir or cfg.metrics_dir
    if metrics_dir:
        obs.enable(metrics_dir=metrics_dir)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device=device)
    serve = (_serve_continuous if cache_kind(cfg) == "gqa"
             else _serve_lockstep)
    try:
        return serve(cfg, params, args, device, metrics_dir)
    finally:
        if metrics_dir:
            obs.disable()


if __name__ == "__main__":
    main()
