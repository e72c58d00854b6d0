"""A run with the timed path broken underneath reads ``correct`` false.

Each test drives the harness as ``run.py`` does (weights, warm-up, the
window, the check), on the CPU at the family's test width, with one fault
planted in the program: a decode step that returns its state unchanged,
half of the batch left out (those rows fed the other half's tokens), or a
served token altered where the sampler produces it.  A cell on one chip
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
         "dsv3-chat-greedy"]


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
        name = "sample_topk" if cell.endswith("topk") else "sample_greedy"
        monkeypatch.setattr(serve, name, _altered(getattr(serve, name)))
    out = _run(cell)
    assert not out.result["correct"], out.result["checks"]
