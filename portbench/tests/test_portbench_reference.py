"""The plain references against the port, on the CPU at the families' test
widths with the ``torch`` merge backend.

The model references are held to the port's decode logits at every
generated position of a lock-step run; the smoke widths compute in
float32 and keep the port's bfloat16 caches, so the two differ by the
caches' rounding alone: a few thousandths of the logits' spread, against
whole spreads when a layer or the recurrence is wrong.  The samplers must
choose the port's token exactly, on logits with many ties.
"""

import pytest
import torch

from portbench import harness
from portbench.reference import sampler as ref_sampler
from repro_torch.serving.sampling import (
    request_keys,
    sample_greedy,
    sample_topk,
    sample_topp,
    sample_topp_batched,
)

TOL = 0.05  # in standard deviations of the reference's logits


@pytest.fixture(autouse=True)
def torch_backend(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_MERGE_BACKEND", "torch")


@pytest.mark.parametrize("cell", ["mamba2-chat-greedy", "dsv3-chat-greedy"])
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_model_reference_matches_port(cell, seed, monkeypatch):
    monkeypatch.setattr(harness, "KEPT_ROWS_PER_BATCH", 4)
    monkeypatch.setattr(harness, "CHECKED_REQUESTS", 64)
    traffic = {"loop": "closed", "clients": 4, "prompt_len": 6,
               "new_tokens": 10, "prompt_tokens": "uniform",
               "sampler": "greedy"}
    out = harness.run(cell, seed, 0.01, False, device="cpu", smoke=True,
                      traffic=traffic, keep=True)
    ctx = out.context
    ref = ctx["ref_logits"]
    prog = torch.stack([r.logits for r in ctx["sample"]])
    err = ((prog - ref).abs() / ref.std(dim=-1, keepdim=True)).max()
    assert float(err) < TOL
    # a wrong model is far outside: the reference with one layer's output
    # projection zeroed
    w = ctx["weights"]
    stack = w["layers"]["mamba"]["w_out"] if "mamba" in w["layers"] else \
        w["layers"]["attn"]["wo"]
    stack[0].zero_()
    from portbench import check

    broken = check.reference_logits(ctx["ref"], ctx["spec"], w, ctx["sample"],
                                    "cpu")
    assert float(((prog - broken).abs() / ref.std(dim=-1, keepdim=True)).max()) > 10 * TOL


def test_samplers_choose_the_ports_token():
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn((6, 300), generator=gen).to(torch.bfloat16).float()
    logits[2, :] = 0.25  # every logit tied
    logits[3, 7] = logits[3, 9] = logits[3].max() + 1  # a tie at the top
    seed = 2**31 + 77
    rows = torch.arange(6)
    for i in range(3):
        keys = request_keys(seed, rows, torch.full_like(rows, i))
        got = sample_topk(keys, logits, k=50)
        greedy = sample_greedy(logits)
        for r in range(6):
            assert ref_sampler.choose(logits[r], sampler="topk", seed=seed,
                                      row_id=r, token_idx=i, k=50) == int(got[r])
            assert ref_sampler.choose(logits[r], sampler="greedy", seed=seed,
                                      row_id=r, token_idx=i, k=50) == int(greedy[r])


@pytest.mark.parametrize("port", [sample_topp, sample_topp_batched],
                         ids=["per_row", "batched"])
@pytest.mark.parametrize("p", [0.9, 0.3, 1.0])
def test_topp_chooses_the_ports_token(port, p):
    """The plain top-p draws the token the port's nucleus sampler serves
    (the lock-step decoder's per-row form, and the batched form), on rows
    with many ties: all tied, a tie at the top, ties across the nucleus's
    edge, and peaked rows whose nucleus is one or two candidates."""
    gen = torch.Generator().manual_seed(9)
    logits = torch.randn((8, 300), generator=gen).to(torch.bfloat16).float()
    logits[2, :] = 0.25
    logits[3, 7] = logits[3, 9] = logits[3].max() + 1
    logits[4] = torch.randint(0, 4, (300,), generator=gen).float()
    logits[5, 11] = logits[5].max() + 8
    logits[6] = (logits[6] * 4).round()
    seed = 2**31 + 41
    rows = torch.arange(8)
    for i in range(4):
        keys = request_keys(seed, rows, torch.full_like(rows, i))
        got = port(keys, logits, p=p, k=64)
        for r in range(8):
            assert ref_sampler.choose(logits[r], sampler="topp", seed=seed,
                                      row_id=r, token_idx=i, k=64,
                                      p=p) == int(got[r]), (r, i)


def test_topp_differs_from_topk_over_the_same_candidates():
    """The nucleus cut matters: on flat rows the plain top-p and the top-k
    of the same candidates draw different tokens somewhere."""
    logits = torch.randn((32, 300), generator=torch.Generator().manual_seed(2))
    seed, differ = 5, 0
    for r in range(32):
        key = ref_sampler.request_key(seed, r, 0, "cpu")
        differ += ref_sampler.topp(logits[r], key, 0.5, 64) != ref_sampler.topk(
            logits[r], key, 64)
    assert differ > 0


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), tree.dtype)}


@pytest.mark.parametrize("config", ["mamba2-2.7b", "deepseek-v3-671b-5l"])
def test_weights_have_the_ports_tree(config):
    """The benchmark's weights have ``init_params``' paths, shapes and
    dtypes, so the port takes them as its own."""
    from repro_torch.models.transformer import init_params

    spec = harness.config(config)
    fam = harness.load_module("families", spec["family"])
    spec = fam.smoke(spec)
    ours = fam.make_weights(spec, 7, "cpu")
    theirs = init_params(fam.port_config(spec), torch.Generator().manual_seed(0),
                         device="cpu")
    assert _leaves(ours) == _leaves(theirs)
    again = fam.make_weights(spec, 7, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(ours), torch.utils._pytree.tree_leaves(again)))
