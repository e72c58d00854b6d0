"""The continuous serving path (``paths/engine.py``) and the DBRX family, on
the CPU at the family's test width with the ``torch`` merge backend.

The plain reference (``reference/dbrx.py``) is held to the port's logits
at every generated position of runs through ``DecodeEngine``; the
family's weights are the port's tree; the path serves what the lock-step
path serves for the same requests; planted faults read ``correct`` false
and the sound run true; the fp8 control reads far above the program; and
the per-layer reader of the engine's host loop (``engine_gap_ms``) finds
the path's host-work span, and nothing on a path without it.
"""

import numpy as np
import pytest
import torch

from portbench import check, harness, trace
from portbench.control import control_gaps, control_judged
from repro_torch.models.transformer import Cache
from repro_torch.serving import engine as engine_mod
from test_portbench_arithmetic import EVENTS, _Ev, _view
from test_portbench_reference import TOL, _leaves

CELL = "dbrx-serve-topk"


@pytest.fixture(autouse=True)
def torch_backend(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_MERGE_BACKEND", "torch")


def _small(sampler="topk", clients=4, prompt_len=6, cap=10):
    return {"loop": "closed", "clients": clients, "prompt_len": prompt_len,
            "new_tokens": {"lognormal": {"median": 40, "sigma": 1.0},
                           "scale": 0.5, "max": cap},
            "prompt_tokens": "uniform", "sampler": sampler, "top_k": 50}


def _smoke_spec():
    spec = harness.config("dbrx-132b-10l")
    return harness.load_module("families", "dbrx").smoke(spec)


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_reference_matches_port(seed, monkeypatch):
    """With the pool's cache in float32, the port's logits are the
    reference's within rounding at every position: the smoke width
    computes in float32, and a bfloat16 cache's rounding can flip one
    router choice of four experts (a whole spread at that position, and
    ``decode_gap_mean`` is the number that allows for it)."""
    monkeypatch.setattr(harness, "KEPT_ROWS_PER_BATCH", 4)
    monkeypatch.setattr(harness, "CHECKED_REQUESTS", 64)
    pool = engine_mod.KVPool
    monkeypatch.setattr(engine_mod, "KVPool", lambda cfg, n, max_len, dtype,
                        device: pool(cfg, n, max_len, torch.float32, device))
    out = harness.run(CELL, seed, 0.01, False, device="cpu", smoke=True,
                      traffic=_small(), keep=True)
    assert out.result["correct"], out.result["checks"]
    ctx = out.context
    ref = ctx["ref_logits"]
    scale = ref.std(dim=-1, keepdim=True)
    lens = [len(r.served) for r in ctx["sample"]]
    assert len(lens) == 4 and max(lens) == 10
    for i, r in enumerate(ctx["sample"]):
        err = ((r.logits - ref[i, :lens[i]]).abs() / scale[i, :lens[i]]).max()
        assert float(err) < TOL
    # a wrong model is far outside: the reference with one layer's output
    # projection zeroed
    ctx["weights"]["layers"]["attn"]["wo"][0].zero_()
    broken = check.reference_logits(ctx["ref"], ctx["spec"], ctx["weights"],
                                    ctx["sample"], "cpu")
    far = max(float(((r.logits - broken[i, :lens[i]]).abs()
                     / scale[i, :lens[i]]).max())
              for i, r in enumerate(ctx["sample"]))
    assert far > 10 * TOL


def test_weights_have_the_ports_tree():
    from repro_torch.models.transformer import init_params

    spec = _smoke_spec()
    fam = harness.load_module("families", "dbrx")
    ours = fam.make_weights(spec, 7, "cpu")
    theirs = init_params(fam.port_config(spec), torch.Generator().manual_seed(0),
                         device="cpu")
    assert _leaves(ours) == _leaves(theirs)
    again = fam.make_weights(spec, 7, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(ours),
        torch.utils._pytree.tree_leaves(again)))


def test_port_config_runs_dbrx_as_published():
    """The cell's configuration runs at its published widths with the
    published norm and clamp; a key or value the port does not run is
    refused; the smoke width's clamp binds."""
    fam = harness.load_module("families", "dbrx")
    spec = harness.config("dbrx-132b-10l")
    cfg = fam.port_config(spec)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.moe_ff, cfg.n_experts, cfg.moe_top_k, cfg.vocab) == (
        6144, 48, 8, 128, 10752, 16, 4, 100352)
    assert (cfg.norm, cfg.clip_qkv, cfg.rope_theta, cfg.router_scoring,
            cfg.n_layers, cfg.tie_embeddings) == (
        "layernorm", 8.0, 5e5, "softmax", 10, False)
    for bad in (dict(spec, tie_word_embeddings=True),
                dict(spec, ffn_config=dict(spec["ffn_config"],
                                           moe_normalize_expert_weights=2)),
                dict(spec, attn_config=dict(spec["attn_config"],
                                            qk_ln=True)),
                dict(spec, resid_pdrop=0.1)):
        with pytest.raises(ValueError):
            fam.port_config(bad)
    small = _smoke_spec()
    w = fam.make_weights(small, 5, "cpu")
    x = torch.randn((64, 64), generator=torch.Generator().manual_seed(1))
    h = torch.nn.functional.layer_norm(x, (64,))
    q = torch.einsum("td,dhk->thk", h, w["layers"]["attn"]["wq"][0].float())
    share = float((q.abs() > small["attn_config"]["clip_qkv"]).float().mean())
    assert 0.05 < share < 0.25


def test_engine_serves_what_lockstep_serves():
    """The same requests through the engine path and the lock-step path
    (equal prompts, every row to the batch's end): the same tokens, and
    the same kept logits at every generated step."""
    spec = _smoke_spec()
    fam = harness.load_module("families", "dbrx")
    cfg = fam.port_config(spec)
    weights = fam.make_weights(spec, 11, "cpu")
    prompts = np.random.default_rng(2).integers(1, cfg.vocab, (4, 5))
    got = {}
    for name in ("engine", "lockstep"):
        mod = harness.load_module("paths", name)
        path = mod.Path(cfg, weights, clients=4, max_len=12, sampler="topk",
                        top_k=50, seed=2**33 + 1, device=torch.device("cpu"),
                        clock=harness.Clock(torch.device("cpu")))
        calls = []
        got[name] = path.run_batch(prompts, 7, calls.append, keep_rows=[1, 3])
        assert calls == list(range(1, 8))
    (served, kept), (want, want_kept) = got["engine"], got["lockstep"]
    assert served.shape == (4, 7) and kept.shape == (2, 7, cfg.vocab)
    np.testing.assert_array_equal(served, want)
    assert torch.allclose(kept, want_kept, atol=1e-4)


def _stuck_state(real):
    def step(cfg, params, cache, tokens, lengths):
        saved = tuple(t.clone() for t in cache.data)
        logits, _ = real(cfg, params, cache, tokens, lengths)
        for t, s in zip(cache.data, saved):
            t.copy_(s)
        return logits, Cache(cache.kind, cache.data, lengths + 1)
    return step


def _half_batch(real):
    def step(cfg, params, cache, tokens, lengths):
        half = tokens.shape[0] // 2
        tokens = torch.cat([tokens[:half], tokens[:tokens.shape[0] - half]])
        return real(cfg, params, cache, tokens, lengths)
    return step


def _altered(real):
    def sample(*args, **kwargs):
        return (real(*args, **kwargs) + 1) % 250
    return sample


def _run(seed=2**31 + 99):
    t = dict(harness.cell(CELL)["traffic_params"], prompt_len=4)
    t["new_tokens"] = dict(t["new_tokens"], max=6)
    return harness.run(CELL, seed, 0.05, False, device="cpu", smoke=True,
                       traffic=t)


def test_sound_run_is_correct():
    out = _run()
    assert out.result["correct"], out.result["checks"]
    assert out.result["attempted"] == 256 and out.result["failed"] == 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_fault_reads_incorrect(fault, monkeypatch):
    if fault == "state_unchanged":
        monkeypatch.setattr(engine_mod, "decode_step_ragged",
                            _stuck_state(engine_mod.decode_step_ragged))
    elif fault == "half_batch":
        monkeypatch.setattr(engine_mod, "decode_step_ragged",
                            _half_batch(engine_mod.decode_step_ragged))
    else:
        monkeypatch.setattr(engine_mod, "sample_topk_batched",
                            _altered(engine_mod.sample_topk_batched))
    out = _run()
    assert not out.result["correct"], out.result["checks"]


def test_control_reads_far_above_the_program(monkeypatch):
    monkeypatch.setattr(harness, "KEPT_ROWS_PER_BATCH", 4)
    monkeypatch.setattr(harness, "CHECKED_REQUESTS", 64)
    limits = harness.cell(CELL)["limits"]
    program, control = [], []
    for seed in (1, 2, 2**31 + 5):
        out = harness.run(CELL, seed, 0.01, False, device="cpu", smoke=True,
                          traffic=_small(prompt_len=8, cap=24), keep=True)
        assert out.result["correct"], out.result["checks"]
        program.append(out.context["numbers"]["decode_gap"])
        gaps = control_gaps(out.context)
        control.append(gaps["max"])
        assert set(control_judged(gaps, limits)[1]) == set(limits)
    assert min(control) > 3 * max(program) and min(control) > 0.1


@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card: "
                    "the control is judged at the cell's own size")
def test_control_fails_the_cells_limits_on_card():
    """At the cell's own size, with its own traffic, the program reads
    correct and the control, judged against the same limits, does not."""
    out = harness.run(CELL, 2**32 + 17, 1.0, False, keep=True)
    assert out.result["correct"], out.result["checks"]
    correct, table = control_judged(control_gaps(out.context),
                                    harness.cell(CELL)["limits"])
    assert not correct, table


# ---------------------------------------------------------------------------
# the engine's host-work span and its reader
# ---------------------------------------------------------------------------

# Two steps of an engine: each a host-work span (the packed copy's
# launch), the decode and sample spans, then host work again (the
# readback); the device idles 40 ns before the second step's copy and
# 30 ns before its gemm.
ENGINE_EVENTS = [
    _Ev("user_annotation", "portbench.engine", 0, 10),
    _Ev("cuda_runtime", "cudaMemcpyAsync", 5, 6, 1),
    _Ev("gpu_memcpy", "Memcpy HtoD", 20, 25, 1),
    _Ev("user_annotation", "portbench.decode", 10, 30),
    _Ev("cuda_runtime", "cudaLaunchKernel", 12, 13, 2),
    _Ev("kernel", "gemm", 25, 100, 2),
    _Ev("user_annotation", "portbench.sample", 30, 40),
    _Ev("cuda_runtime", "cudaLaunchKernel", 32, 33, 3),
    _Ev("kernel", "merge_kway_groups_kernel<float>", 100, 110, 3),
    _Ev("user_annotation", "portbench.engine", 40, 150),
    _Ev("cuda_runtime", "cudaMemcpyAsync", 41, 42, 4),
    _Ev("gpu_memcpy", "Memcpy DtoH", 110, 112, 4),
    _Ev("cuda_runtime", "cudaMemcpyAsync", 140, 141, 5),
    _Ev("gpu_memcpy", "Memcpy HtoD", 152, 155, 5),
    _Ev("user_annotation", "portbench.decode", 150, 170),
    _Ev("cuda_runtime", "cudaLaunchKernel", 160, 161, 6),
    _Ev("kernel", "gemm", 185, 200, 6),
]


def test_engine_gap_reader():
    rd = harness.readers()["engine_gap_ms"]
    sl = trace.read(ENGINE_EVENTS, steps=2)
    assert [o.span for o in sl.ops] == ["engine", "decode", "sample",
                                        "engine", "engine", "decode"]
    assert dict(sl.idle_gaps) == pytest.approx({"engine:launch": 40e-9,
                                                "decode:launch": 30e-9})
    assert rd.read(_view(slice=sl)) == pytest.approx(40e-6 / 2)
    # no host-work span (the lock-step path): nothing to read
    assert rd.read(_view(slice=trace.read(EVENTS, steps=2))) is None
    assert rd.read(_view(slice=None)) is None


def test_path_spans_do_not_overlap():
    """A traced batch on the CPU: the path's three spans alternate, host
    work, decode, sample, host work, never overlapping, one decode and
    one sample a step."""
    spec = _smoke_spec()
    fam = harness.load_module("families", "dbrx")
    cfg = fam.port_config(spec)
    mod = harness.load_module("paths", "engine")
    path = mod.Path(cfg, fam.make_weights(spec, 3, "cpu"), clients=3,
                    max_len=8, sampler="topk", top_k=50, seed=9,
                    device=torch.device("cpu"),
                    clock=harness.Clock(torch.device("cpu")))
    path.probe.spans = True
    prompts = np.ones((3, 4), dtype=np.int64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        path.run_batch(prompts, 3, lambda i: None)
    spans = sorted((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("portbench."))
    steps = 4 + 3 - 1
    names = [n for _, _, n in spans]
    assert names == ["portbench.engine", "portbench.decode",
                     "portbench.sample", "portbench.engine"] * steps
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert len(path.probe.decodes) == len(path.probe.samples) == steps
