"""The port's decode service: scheduler and pool invariants, greedy streams
against the JAX package's ``DecodeEngine``, and the port's own
determinism contract.

Scheduler and pool tests mirror ``tests/test_serving.py`` (FIFO,
back-pressure, double free, recycling resets the length only, the
random-trace no-leak property).  Greedy streams are compared token for
token with the reference engine at smoke size in float32 (weights carried
over through numpy, staggered arrivals).  Equality may be waived only from
a step where the reference's top-two logit gap is under ``GAP_TOL`` (the
two models' logits agree within 1e-5 of the largest, so a smaller gap may
flip the arg-max); the test prints every waiver.
"""

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from _prop import given, settings, st

from repro.configs.registry import ARCHS as REF_ARCHS, smoke_config as ref_smoke
from repro.launch import serve as ref_serve
from repro.models.transformer import init_params as ref_init_params
from repro.serving import DecodeEngine as RefEngine
from repro_torch import obs
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import (decode_step, decode_step_capturable,
                                            decode_step_tables, init_cache,
                                            init_params)
from repro_torch.serving import DecodeEngine, KVPool, Request, Scheduler
from repro_torch.serving.sampling import sample_topk

REPO = pathlib.Path(__file__).resolve().parents[1]
GAP_TOL = 2e-5  # relative to the largest logit: twice the logits' tolerance


@pytest.fixture(scope="module")
def smoke_model():
    cfg = smoke_config(ARCHS["qwen3-0.6b"])
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


# --- scheduler and pool -----------------------------------------------------------


def test_fifo_admission_order():
    sched = Scheduler(max_batch=2, queue_depth=8)
    for rid in range(6):
        assert sched.submit(Request(rid, np.asarray([1]), 1))
    assert [r.rid for _, r in sched.admit([0, 1])] == [0, 1]
    sched.complete(0)
    assert [r.rid for _, r in sched.admit([0])] == [2]
    sched.check_invariants()


def test_queue_depth_backpressure():
    sched = Scheduler(max_batch=1, queue_depth=2)
    assert sched.submit(Request(0, np.asarray([1]), 1))
    assert sched.submit(Request(1, np.asarray([1]), 1))
    assert not sched.submit(Request(2, np.asarray([1]), 1))  # shed, not drop
    sched.check_invariants()
    assert sched.pending == 2


def test_request_and_scheduler_validation():
    with pytest.raises(ValueError, match="non-empty"):
        Request(0, np.asarray([], np.int32), 1)
    with pytest.raises(ValueError, match="max_new_tokens"):
        Request(0, np.asarray([1]), 0)
    with pytest.raises(ValueError, match="max_batch"):
        Scheduler(0, 1)
    with pytest.raises(RuntimeError, match="empty slot"):
        Scheduler(1, 1).complete(0)


def test_pool_double_free_and_exhaustion_raise(smoke_model):
    cfg, _ = smoke_model
    pool = KVPool(cfg, capacity=2, max_len=8, device="cpu")
    a, b = pool.alloc(), pool.alloc()
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc()
    pool.free(a)
    with pytest.raises(RuntimeError, match="not in use"):
        pool.free(a)
    pool.free(b)
    pool.check_invariants()


def test_pool_recycle_resets_length_only(smoke_model):
    cfg, _ = smoke_model
    pool = KVPool(cfg, capacity=2, max_len=8, device="cpu")
    slot = pool.alloc()
    pool.cache.data[0][:, slot] = 7.0  # stale KV of the previous occupant
    lengths = pool.cache.length.clone()
    lengths[slot] = 5
    pool.set_cache(pool.cache.data, lengths)
    pool.free(slot)
    again = pool.alloc()  # LIFO: same slot comes back
    assert again == slot
    assert int(pool.cache.length[slot]) == 0  # recycled: masked, not zeroed
    assert bool((pool.cache.data[0][:, slot] == 7.0).all())
    pool.check_invariants()


def test_pool_refuses_other_cache_families():
    """SSM and hybrid caches have no per-slot positions either: the pool
    refuses them, naming the lock-step path they are served on."""
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        cfg = smoke_config(ARCHS[arch])
        with pytest.raises(NotImplementedError, match="lock-step"):
            KVPool(cfg, capacity=2, max_len=8, device="cpu")


def test_pool_refuses_the_mla_cache():
    """MLA caches have no per-slot positions: deepseek-v3 is served on
    the lock-step path, never through the pool."""
    cfg = smoke_config(ARCHS["deepseek-v3-671b"])
    with pytest.raises(NotImplementedError, match="lock-step"):
        KVPool(cfg, capacity=2, max_len=8, device="cpu")


@given(st.data())
@settings(max_examples=15, deadline=None)
def test_no_slot_leak_random_traces(data):
    """Conservation + FIFO + pool partition under arbitrary interleaved
    submit/admit/complete traces (the state machine without a model)."""
    cap = data.draw(st.integers(1, 4))
    depth = data.draw(st.integers(1, 5))
    sched = Scheduler(cap, depth)
    free = list(range(cap))
    rid = 0
    for _ in range(data.draw(st.integers(5, 40))):
        op = data.draw(st.sampled_from(["submit", "admit", "complete"]))
        if op == "submit":
            if sched.submit(Request(rid, np.asarray([1, 2]), 1)):
                rid += 1
        elif op == "admit":
            placed = sched.admit(free)
            free = free[len(placed):]
        elif op == "complete" and sched.occupied():
            slot, _ = sched.occupied()[0]
            sched.complete(slot)
            free.append(slot)
        sched.check_invariants()
        assert len(free) + sched.active_slots == cap


# --- greedy streams against the reference engine -----------------------------------


def _arrivals(vocab, n=6, seed=9):
    """Staggered arrivals (one every step, then a gap), prompts of 2-5
    tokens, 3-7 new tokens."""
    rng = np.random.default_rng(seed)
    return [(i + (3 if i >= n // 2 else 0),
             Request(i, rng.integers(1, vocab, 2 + i % 4, dtype=np.int32),
                     3 + i % 5))
            for i in range(n)]


class _RefRecorder(RefEngine):
    """The reference engine, keeping each due slot's logits by (rid,
    token index)."""

    def _sample(self, keys, logits):
        rows = np.asarray(logits)
        for slot, st in self.scheduler.occupied():
            if st.samples_this_step:
                self.seen[(st.request.rid, st.generated)] = rows[slot]
        return super()._sample(keys, logits)


@pytest.mark.filterwarnings("ignore:scatter inputs have incompatible types")
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b"])
def test_greedy_streams_match_reference_engine(arch):
    """qwen3: dense GQA; dbrx: MoE layers with dropless dispatch."""
    rcfg = dataclasses.replace(ref_smoke(REF_ARCHS[arch]), dtype="float32")
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32")
    ref_params, _ = ref_init_params(rcfg, jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    kw = dict(max_len=24, max_batch=3, queue_depth=8, sampler="greedy")
    # The reference's KVPool keeps its cache in bfloat16 whatever
    # cache_dtype says; the port's is given the same.
    ref = _RefRecorder(rcfg, ref_params, **kw)
    ref.seen = {}
    assert ref.pool.cache.data[0].dtype == jnp.bfloat16
    want = ref.run(arrivals=_arrivals(rcfg.vocab, 8))
    got = DecodeEngine(cfg, params, cache_dtype=torch.bfloat16, **kw).run(
        arrivals=_arrivals(cfg.vocab, 8))
    assert sorted(got) == sorted(want)
    waived = []
    for rid, stream in want.items():
        assert len(got[rid]) == len(stream)
        for t, (a, b) in enumerate(zip(got[rid], stream)):
            if a == b:
                continue
            row = ref.seen[(rid, t)]
            top2 = np.sort(row)[-2:]
            gap = float(top2[1] - top2[0]) / float(np.abs(row).max())
            assert gap < GAP_TOL, (rid, t, a, b, gap)
            waived.append((rid, t, gap))
            break  # the streams part ways from here
    print(f"greedy streams: {len(want)} requests, "
          f"{sum(map(len, want.values()))} tokens, waived {waived}")
    assert len(waived) <= 1


def test_greedy_lockstep_streams_match_reference():
    """deepseek-v3 smoke (MLA cache, one leading dense layer, sigmoid
    routing, a shared expert) on the lock-step path: the port's
    ``_serve_lockstep`` against the reference's, same prompts, float32."""
    rcfg = dataclasses.replace(ref_smoke(REF_ARCHS["deepseek-v3-671b"]),
                               dtype="float32")
    cfg = dataclasses.replace(smoke_config(ARCHS["deepseek-v3-671b"]),
                              dtype="float32")
    ref_params, _ = ref_init_params(rcfg, jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    args = argparse.Namespace(max_batch=0, prompt_len=5, tokens=8,
                              sampler="greedy", seed=3, profile_steps=0)
    want = ref_serve._serve_lockstep(rcfg, ref_params, args, None)
    got = serve._serve_lockstep(cfg, params, args, "cpu")
    assert len(want) == rcfg.max_batch
    assert got == want


def test_lockstep_decoder_checks():
    cfg = smoke_config(ARCHS["deepseek-v3-671b"])
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="unknown sampler"):
        serve.LockstepDecoder(cfg, params, batch=2, max_len=8, sampler="beam")
    dec = serve.LockstepDecoder(cfg, params, batch=2, max_len=8, top_k=8)
    out = dec.generate(np.array([[1, 2, 3], [4, 5, 6]]), 5)
    assert out.shape == (2, 5) and int(dec.cache.length) == 8
    assert ((out >= 0) & (out < cfg.vocab)).all()


class _PerRowDecoder(serve.LockstepDecoder):
    """The lock-step decoder with the per-request top-k sampler: one
    tournament and one draw a row, the oracle of the batched form."""

    def _sample(self, keys, logits):
        return sample_topk(keys, logits, k=self.top_k, fanout=self.cfg.fanout)


@pytest.fixture(scope="module")
def lockstep_models():
    out = {}
    for arch in ("mamba2-2.7b", "deepseek-v3-671b"):
        cfg = smoke_config(ARCHS[arch])
        out[arch] = cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    return out


@pytest.mark.parametrize("batch,seed", [(1, 0), (4, 42), (8, 2**31 + 11)])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "deepseek-v3-671b"])
def test_lockstep_topk_streams_equal_per_row_sampler(lockstep_models, arch,
                                                     batch, seed):
    """The lock-step ``topk`` path draws the whole batch with one batched
    tournament a step: its streams equal the per-row sampler's token for
    token, and ``serve.topk_merge_rounds`` is recorded once a generated
    step at the decoder's rows."""
    cfg, params = lockstep_models[arch]
    new = 5
    prompts = np.random.default_rng(seed).integers(1, cfg.vocab, (batch, 3))
    kw = dict(batch=batch, max_len=prompts.shape[1] + new, sampler="topk",
              top_k=50, seed=seed)
    with obs.capture() as recs:
        got = serve.LockstepDecoder(cfg, params, **kw).generate(prompts, new)
    want = _PerRowDecoder(cfg, params, **kw).generate(prompts, new)
    assert got.shape == (batch, new)
    np.testing.assert_array_equal(got, want)
    rounds = [r for r in recs if r["metric"] == "serve.topk_merge_rounds"]
    assert [r["step"] for r in rounds] == list(range(new))
    assert all(r["labels"]["batch"] == batch for r in rounds)


class _EagerDecoder(serve.LockstepDecoder):
    """The lock-step decoder with every step run by ``decode_step``."""

    def _decode(self, tokens):
        logits, self.cache = decode_step(self.cfg, self.params, self.cache,
                                         tokens)
        return logits


@pytest.mark.parametrize("obs_on", [False, True])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_lockstep_decoder_never_captures_on_cpu(arch, obs_on):
    """Off the card, and with obs on, the lock-step decoder runs every step
    eagerly: no CUDA graph is captured or replayed, and its greedy and
    top-k streams and cache equal the eager decoder's."""
    cfg = smoke_config(ARCHS[arch])
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = np.random.default_rng(5).integers(1, cfg.vocab, (3, 2))
    for sampler in ("greedy", "topk"):
        kw = dict(batch=3, max_len=6, sampler=sampler, top_k=8, seed=9)
        dec = serve.LockstepDecoder(cfg, params, **kw)
        if obs_on:
            with obs.capture():
                got = dec.generate(prompts, 4)
        else:
            got = dec.generate(prompts, 4)
        eager = _EagerDecoder(cfg, params, **kw)
        np.testing.assert_array_equal(got, eager.generate(prompts, 4))
        assert dec.graph_captures == dec.graph_replays == 0
        assert int(dec.cache.length) == 6
        for a, b in zip(dec.cache.data, eager.cache.data):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch, capturable", [
    ("mamba2-2.7b", True), ("zamba2-1.2b", True), ("deepseek-v3-671b", False),
    ("dbrx-132b", False), ("qwen3-0.6b", False)])
def test_decode_step_capturable_for_state_caches_without_moe(arch, capturable):
    """Only an ssm or hybrid cache of a model without MoE layers may have
    its decode step captured; the position tables a step reads come from
    their cache, the same objects on every call."""
    cfg = smoke_config(ARCHS[arch])
    cache = init_cache(cfg, 2, 5, device="cpu")
    assert decode_step_capturable(cfg, cache) is capturable
    first, again = (decode_step_tables(cfg, cache, torch.device("cpu"))
                    for _ in range(2))
    assert len(first) in (1, 2) and all(a is b for a, b in zip(first, again))


# --- the port's determinism contract ------------------------------------------------


def _engine(cfg, params, **kw):
    kw.setdefault("max_len", 32)
    kw.setdefault("max_batch", 2)
    kw.setdefault("queue_depth", 8)
    kw.setdefault("sampler", "topk")
    kw.setdefault("top_k", 8)
    kw.setdefault("seed", 11)
    return DecodeEngine(cfg, params, **kw)


@pytest.mark.parametrize("sampler", ["topk", "topp"])
def test_streams_invariant_to_pool_size(smoke_model, sampler):
    """Streams depend on (seed, rid), never on the slot or the batch:
    shrinking the pool reorders execution but not one request's tokens."""
    cfg, params = smoke_model
    out4 = _engine(cfg, params, max_batch=4, sampler=sampler).run(
        arrivals=_arrivals(cfg.vocab, 4))
    out1 = _engine(cfg, params, max_batch=1, sampler=sampler).run(
        arrivals=_arrivals(cfg.vocab, 4))
    assert out4 == out1
    assert all(len(t) == r.max_new_tokens
               for (_, r), t in zip(_arrivals(cfg.vocab, 4),
                                    (out4[i] for i in range(4))))


def test_recycled_slot_matches_fresh_pool(smoke_model):
    """A request decoded in a recycled slot sees no trace of the slot's
    previous occupant: same stream as in a new pool."""
    cfg, params = smoke_model
    probe = Request(77, np.asarray([3, 1, 4], np.int32), 5)
    eng = _engine(cfg, params, max_batch=1)
    eng.submit(Request(5, np.asarray([9, 9, 9, 9], np.int32), 6))
    out = eng.run(arrivals=[(1, probe)])  # probe reuses rid 5's slot
    fresh = _engine(cfg, params, max_batch=1).run(
        arrivals=[(0, Request(77, probe.prompt, probe.max_new_tokens))])
    assert out[77] == fresh[77]
    eng.scheduler.check_invariants()
    eng.pool.check_invariants()


def test_engine_rejects_oversized_request(smoke_model):
    cfg, params = smoke_model
    eng = _engine(cfg, params, max_len=8)
    with pytest.raises(ValueError, match="exceeds pool max_len"):
        eng.submit(Request(0, np.arange(1, 7, dtype=np.int32), 4))
    with pytest.raises(ValueError, match="unknown sampler"):
        _engine(cfg, params, sampler="beam")


def test_serve_launcher_smoke_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--smoke", "--device", "cpu", "--requests", "4",
         "--tokens", "6"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert "served 4 requests / 24 tokens" in res.stdout


@pytest.mark.parametrize("arch,extra,expect", [
    ("dbrx-132b", ["--moe-dispatch", "dropless"], "served 4 requests / 24 tokens"),
    ("dbrx-132b", ["--moe-dispatch", "capacity"], "served 4 requests / 24 tokens"),
    ("deepseek-v3-671b", [], "generated (4, 6) tokens"),
    ("mamba2-2.7b", [], "generated (8, 6) tokens"),
    ("zamba2-1.2b", [], "generated (8, 6) tokens"),
])
def test_serve_launcher_moe_and_mla_on_cpu(arch, extra, expect):
    """dbrx (MoE, gqa cache) serves on the continuous path with either
    dispatch; deepseek-v3 (MLA cache), mamba2 (SSM cache) and zamba2
    (hybrid cache) on the lock-step path."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--requests", "4", "--tokens", "6",
         *extra],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert expect in res.stdout
    if "generated" in expect:
        assert "[lock-step]" in res.stdout


@pytest.mark.parametrize("arch,path_metric", [
    ("qwen3-0.6b", "serve.step_latency"),  # continuous path
    ("zamba2-1.2b", "serve.sampled_tokens"),  # lock-step path
])
def test_serve_launcher_metrics_dir_on_cpu(tmp_path, arch, path_metric):
    """``--metrics-dir`` writes the JSONL, every decode step's records
    carrying its ``step`` label, and ``--profile-steps`` a trace under
    ``<metrics-dir>/profile``."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--requests", "3", "--tokens", "4",
         "--metrics-dir", str(tmp_path), "--profile-steps", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    names = {r["metric"] for r in recs}
    assert {path_metric, "kernels.dispatch_calls", "obs.profile_started",
            "obs.profile_stopped"} <= names
    stepped = [r["step"] for r in recs if r["metric"] == path_metric]
    assert stepped and stepped == sorted(stepped) and stepped[0] == 0
    assert all("step" in r for r in recs if r["metric"] == "kernels.dispatch_calls")
    assert list((tmp_path / "profile").glob("*.pt.trace.json"))
