"""The spans inside the port's decode step and sampler, on the CPU.

One smoke-width lock-step batch of deepseek-v3 (MLA, dropless MoE, the
batched top-k sampler) and one of mamba2 run under a CPU profiler, and
``DecodeEngine`` runs of qwen3 (the batched sampler) and of dbrx (the
engine's host work); the annotations the profiler records must nest as
``repro_torch.obs`` lists them, each span the expected number of times,
and the served tokens must be the same with the profiler on and off.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.launch import serve
from repro_torch.models.transformer import init_params
from repro_torch.serving import DecodeEngine, Request

PROMPTS = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]])
NEW = 4


def _profiled(run):
    """``run()`` with the profiler off, then on: ``(tokens off, tokens
    on, Counter of (span, its nearest enclosing span))``."""
    off = run()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = run()
    tree = Counter()
    for e in prof.events():
        if not e.is_user_annotation:
            continue
        p = e.cpu_parent
        while p is not None and not p.is_user_annotation:
            p = p.cpu_parent
        parent = None if p is None else p.name
        if parent is not None and "#" in parent:
            parent = parent.split("#")[0] + "#"  # one step marker a step
        tree[e.name, parent] += 1
    return off, on, tree


def _lockstep(arch):
    cfg = smoke_config(ARCHS[arch])
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def run():
        dec = serve.LockstepDecoder(cfg, params, batch=len(PROMPTS),
                                    max_len=PROMPTS.shape[1] + NEW, top_k=8)
        return dec.generate(PROMPTS, NEW)
    return cfg, _profiled(run)


def _children(tree, parent):
    return {name: n for (name, p), n in tree.items() if p == parent}


def test_deepseek_lockstep_span_tree():
    cfg, (off, on, tree) = _lockstep("deepseek-v3-671b")
    assert cfg.moe_dispatch == "dropless" and cfg.mla
    np.testing.assert_array_equal(on, off)
    steps = PROMPTS.shape[1] + NEW  # prompt feed and generated steps
    dense, moe = cfg.first_k_dense, cfg.n_layers - cfg.first_k_dense
    assert tree["serve.decode", "serve.prefill"] == PROMPTS.shape[1]
    assert tree["serve.decode", "decode#"] == NEW
    assert tree["serve.sample", "decode#"] == NEW
    assert _children(tree, "serve.decode") == {
        "model.embed": steps, "model.attn": steps * cfg.n_layers,
        "model.mlp": steps * dense, "model.moe": steps * moe,
        "model.head": steps}
    layers = steps * moe
    assert _children(tree, "model.moe") == {
        "moe.route": layers, "moe.dispatch": layers, "moe.experts": layers,
        "moe.combine": 2 * layers}  # the routed combine, the shared experts
    assert _children(tree, "serve.sample") == {"sample.topk": NEW,
                                               "sample.draw": NEW}
    for name in ("model.attn", "model.mlp", "moe.dispatch", "moe.experts",
                 "sample.draw"):
        assert not _children(tree, name), name


def test_mamba2_lockstep_span_tree():
    cfg, (off, on, tree) = _lockstep("mamba2-2.7b")
    np.testing.assert_array_equal(on, off)
    steps = PROMPTS.shape[1] + NEW
    assert _children(tree, "serve.decode") == {
        "model.embed": steps, "model.ssm": steps * cfg.n_layers,
        "model.head": steps}
    assert _children(tree, "model.ssm") == {
        "ssm.state_write": steps * cfg.n_layers}
    assert _children(tree, "serve.sample") == {
        "sample.topk": NEW, "sample.draw": NEW}


@pytest.mark.parametrize("sampler", ["topk", "topp"])
def test_engine_span_tree(sampler):
    """``DecodeEngine`` records the same names; its batched sampler runs
    one ``sample.topk`` and one ``sample.draw`` a step."""
    cfg = smoke_config(ARCHS["qwen3-0.6b"])
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def run():
        eng = DecodeEngine(cfg, params, max_len=16, max_batch=2,
                           queue_depth=4, sampler=sampler, top_k=8, seed=5)
        for rid, prompt in enumerate(PROMPTS):
            eng.submit(Request(rid, prompt.astype(np.int32), 3))
        return eng.run(), eng.steps

    (off, steps), (on, steps_on), tree = _profiled(run)
    assert on == off and steps_on == steps
    assert tree["serve.decode", None] == tree["serve.sample", None] == steps
    assert _children(tree, "serve.decode") == {
        "model.embed": steps, "model.attn": steps * cfg.n_layers,
        "model.mlp": steps * cfg.n_layers, "model.head": steps}
    assert _children(tree, "serve.sample") == {"sample.topk": steps,
                                               "sample.draw": steps}


def test_engine_host_spans():
    """Each engine step records its host work as four spans beside
    ``serve.decode`` and ``serve.sample``, in step order: admission, the
    packed inputs, (decode, sample), the readback, the retire loop; none
    of the four holds another span."""
    cfg = smoke_config(ARCHS["dbrx-132b"])
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def run():
        eng = DecodeEngine(cfg, params, max_len=16, max_batch=2,
                           queue_depth=4, top_k=8, seed=5)
        for rid, prompt in enumerate(PROMPTS):
            eng.submit(Request(rid, prompt.astype(np.int32), 3))
        return eng.run(), eng.steps

    (off, steps), (on, steps_on), tree = _profiled(run)
    assert on == off and steps_on == steps
    host = ("serve.admit", "serve.pack", "serve.readback", "serve.retire")
    top = _children(tree, None)
    assert {name: top[name] for name in host} == dict.fromkeys(host, steps)
    assert top["serve.decode"] == top["serve.sample"] == steps
    for name in host:
        assert not _children(tree, name), name

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    order = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
             if e.is_user_annotation and e.cpu_parent is None]
    assert order == ["serve.admit", "serve.pack", "serve.decode",
                     "serve.sample", "serve.readback", "serve.retire"] * steps
