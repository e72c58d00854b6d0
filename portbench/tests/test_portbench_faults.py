"""A run with the timed path broken underneath reads ``correct`` false.

Each test drives the harness as ``run.py`` does (weights, warm-up, the
window, the check), on the CPU at the family's test width, with one fault
planted in the program: a decode step that returns its state unchanged,
half of the batch left out (those rows fed the other half's tokens), a
served token altered where the sampler produces it, or (top-p) the
nucleus's ``p`` ignored, every one of the ``k`` candidates kept.  A cell on one chip
has no exchange between chips to leave out.  The traffic is the cell's
own (its clients, its spread of lengths) with shorter prompts and a lower
cap on new tokens, and the harness keeps and checks the rows and requests
it keeps and checks in a run on the card.  The sound run beside them reads
``correct`` true.
"""

import pytest
import torch

from portbench import harness
from repro_torch.launch import serve
from repro_torch.models.transformer import Cache

CELLS = ["mamba2-chat-topk", "dsv3-chat-topk", "mamba2-chat-greedy",
         "dsv3-chat-greedy", "mamba2-chat-topp"]
SAMPLER = {"topk": "sample_topk", "greedy": "sample_greedy",
           "topp": "sample_topp"}


def _traffic(cell):
    t = dict(harness.cell(cell)["traffic_params"], prompt_len=4)
    t["new_tokens"] = dict(t["new_tokens"], max=6)
    return t


def _run(cell, seed=2**31 + 99):
    return harness.run(cell, seed, 0.05, False, device="cpu", smoke=True,
                       traffic=_traffic(cell))


def _stuck_state(real):
    def step(cfg, params, cache, tokens):
        saved = tuple(t.clone() for t in cache.data)
        logits, _ = real(cfg, params, cache, tokens)
        for t, s in zip(cache.data, saved):
            t.copy_(s)
        return logits, Cache(cache.kind, cache.data, cache.length)
    return step


def _half_batch(real):
    def step(cfg, params, cache, tokens):
        half = tokens.shape[0] // 2
        tokens = torch.cat([tokens[:half], tokens[:tokens.shape[0] - half]])
        return real(cfg, params, cache, tokens)
    return step


def _altered(real):
    def sample(*args, **kwargs):
        out = real(*args, **kwargs)
        return (out + 1) % 250
    return sample


def _p_ignored(real):
    def sample(keys, logits, p=0.9, **kwargs):
        return real(keys, logits, p=1.0, **kwargs)
    return sample


def test_device_time_cell_reports_its_end_to_end(monkeypatch):
    """A cell whose end-to-end metric is the device's time a token runs
    each window batch under its own profiler and reports that metric and
    ``setup_s`` alone; its traced run reads the host's rate per layer."""
    busy = []

    def one_ms(events):
        busy.append(1)
        return 1_000_000

    monkeypatch.setattr(harness.trace_mod, "device_busy_ns", one_ms)
    out = _run("dsv3-chat-greedy")
    assert out.result["correct"], out.result["checks"]
    assert set(out.result["metrics"]) == {"device_ms_per_token", "setup_s"}
    per_batch = sum(harness.Traffic(_traffic("dsv3-chat-greedy"), 1, 10).lengths)
    assert len(busy) == out.window["batches"]
    assert out.result["metrics"]["device_ms_per_token"]["value"] == (
        pytest.approx(1.0 / per_batch))
    traced = harness.run("dsv3-chat-greedy", 2**31 + 99, 0.05, True,
                         device="cpu", smoke=True,
                         traffic=_traffic("dsv3-chat-greedy"))
    assert {"host_decode_tok_s", "host_tpot_p95_ms"} <= set(traced.result["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out.result["correct"], out.result["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_fault_reads_incorrect(cell, fault, monkeypatch):
    if fault == "state_unchanged":
        monkeypatch.setattr(serve, "decode_step", _stuck_state(serve.decode_step))
    elif fault == "half_batch":
        monkeypatch.setattr(serve, "decode_step", _half_batch(serve.decode_step))
    else:
        name = SAMPLER[cell.rsplit("-", 1)[1]]
        monkeypatch.setattr(serve, name, _altered(getattr(serve, name)))
    out = _run(cell)
    assert not out.result["correct"], out.result["checks"]


def test_topp_with_p_ignored_reads_incorrect(monkeypatch):
    monkeypatch.setattr(serve, "sample_topp", _p_ignored(serve.sample_topp))
    out = _run("mamba2-chat-topp")
    assert not out.result["correct"], out.result["checks"]
    assert out.result["checks"]["sampler_mismatch"]["value"] > 0
