"""The port's samplers against the JAX package's, and its own draw contract.

Held against the reference (the same numpy logits through both): the
batched top-k candidates (values and indices bit for bit), the softmax
probabilities over them (absolute tolerance 1e-6: the two frameworks
reduce in another order, each within a float32 ulp or two of 1/k), the
nucleus count ``n_keep`` (exact) and greedy decoding (exact).

The draw itself is the port's own: the reference's
``jax.random.categorical`` on threefry keys has no torch counterpart.  So
the stream contract is held against the port itself: a request's token
depends only on the seed, its id, its token index and its logits, never
on its row, the batch size or the other requests; the batched forms equal
the per-request ones; and the Gumbel-max draw follows the probabilities.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import engine as ref_engine
from repro.serving import sampling as ref_sampling
from repro_torch.serving import sampling

VOCAB = 1000


def _logits(b=6, n=VOCAB, seed=0):
    """Duplicate-heavy logits with +-inf entries in some rows."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-40, 40, (b, n)) / 8).astype(np.float32)
    x[1, rng.random(n) < 0.05] = np.inf
    x[2, rng.random(n) < 0.2] = -np.inf
    return x


@pytest.mark.parametrize("fanout", [2, 4, 16])
def test_batched_topk_matches_reference(fanout):
    x = _logits()
    rv, ri = ref_sampling.batched_topk(jnp.asarray(x), 50, fanout=fanout)
    pv, pi = sampling.batched_topk(torch.from_numpy(x), 50, fanout=fanout)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(pv.numpy().view(np.int32),
                                  np.asarray(rv).view(np.int32))


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_candidate_probabilities_match_reference(temperature):
    x = _logits()[[0, 3, 4, 5]]  # finite rows
    rv, _ = ref_sampling.batched_topk(jnp.asarray(x), 50, fanout=4)
    ref_p = np.asarray(jax.nn.softmax(rv.astype(jnp.float32) / temperature,
                                      axis=-1))
    pv, _ = sampling.batched_topk(torch.from_numpy(x), 50, fanout=4)
    p = torch.softmax(pv.float() / temperature, dim=-1).numpy()
    np.testing.assert_allclose(p, ref_p, rtol=0, atol=1e-6)


@pytest.mark.parametrize("p", [0.05, 0.5, 0.9, 0.999])
def test_nucleus_count_matches_reference(p):
    rng = np.random.default_rng(int(p * 1000))
    x = (rng.standard_normal((8, 300)) * 3).astype(np.float32)
    rv, _ = ref_sampling.batched_topk(jnp.asarray(x), 64, fanout=4)
    probs = jax.nn.softmax(rv.astype(jnp.float32), axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    want = jax.vmap(lambda row: ref_engine.value_cut_counts(
        row, jnp.float32(p)))(cum - probs)
    # the reference's own prefix rule, too
    keep = np.asarray(cum - probs < p).sum(axis=1)
    got = sampling.nucleus_counts(torch.from_numpy(np.array(probs)), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), keep)
    assert got.dtype == torch.int32


def test_sample_greedy_matches_reference():
    x = _logits(b=5)
    x[0, :] = 1.0  # all tied: the first index
    x[3, 17] = x[3, 400] = 99.0  # two maxima: the lower
    want = np.asarray(ref_sampling.sample_greedy(jnp.asarray(x)))
    got = sampling.sample_greedy(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


# ---------------------------------------------------------------------------
# the port's own draw: the stream contract
# ---------------------------------------------------------------------------


def _keys(rids, gens, seed=5):
    return sampling.request_keys(seed, torch.tensor(rids), torch.tensor(gens))


@pytest.mark.parametrize("form", ["topk", "topp"])
def test_batched_equals_per_request(form):
    x = torch.from_numpy(_logits())
    keys = _keys([3, 1, 4, 1, 5, 9], [0, 2, 7, 1, 8, 2])
    if form == "topk":
        got = sampling.sample_topk_batched(keys, x, k=50, fanout=4)
        want = sampling.sample_topk(keys, x, k=50, fanout=4)
    else:  # +inf logits give NaN probabilities: no nucleus to cut
        x, keys = x[[0, 2, 3, 4, 5]], keys[[0, 2, 3, 4, 5]]
        got = sampling.sample_topp_batched(keys, x, p=0.8, k=64, fanout=4)
        want = sampling.sample_topp(keys, x, p=0.8, k=64, fanout=4)
    assert torch.equal(got, want)
    assert got.dtype == torch.int32


def test_token_does_not_depend_on_row_batch_or_neighbours():
    x = torch.from_numpy(_logits(b=6, seed=3))
    rids, gens = [10, 11, 12, 13, 14, 15], [0, 5, 9, 2, 2, 40]
    full = sampling.sample_topk_batched(_keys(rids, gens), x, k=50, fanout=4)
    perm = [4, 0, 5, 2, 1, 3]
    shuffled = sampling.sample_topk_batched(
        _keys([rids[i] for i in perm], [gens[i] for i in perm]), x[perm],
        k=50, fanout=4)
    assert torch.equal(shuffled, full[perm])
    for sub in ([2], [5, 1], [0, 3, 4]):
        alone = sampling.sample_topk_batched(
            _keys([rids[i] for i in sub], [gens[i] for i in sub]), x[sub],
            k=50, fanout=4)
        assert torch.equal(alone, full[sub])
    other = x.clone()
    other[[0, 2]] = torch.flip(other[[0, 2]], dims=[1])  # change neighbours
    again = sampling.sample_topk_batched(_keys(rids, gens), other, k=50,
                                         fanout=4)
    assert torch.equal(again[[1, 3, 4, 5]], full[[1, 3, 4, 5]])


def test_request_keys_hash_seed_rid_and_index():
    base = _keys([7] * 4, [0, 1, 2, 3])
    assert len(set(base.tolist())) == 4
    assert torch.equal(base, _keys([7] * 4, [0, 1, 2, 3]))
    assert not torch.equal(base, _keys([8] * 4, [0, 1, 2, 3]))
    assert not torch.equal(base, _keys([7] * 4, [0, 1, 2, 3], seed=6))
    assert int(base.min()) >= 0 and int(base.max()) < 2**32
    big = sampling.request_keys(2**40 + 5, torch.tensor([2**33 + 7]),
                                torch.tensor([1]))
    assert 0 <= int(big[0]) < 2**32


def test_gumbel_draw_follows_the_probabilities():
    """Over 20000 token indices of one request, the top-k draw's
    frequencies are the softmax of the candidates within 0.015 (the
    binomial standard error at p = 0.5 is 0.0035)."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -30.0]]).expand(20000, 6)
    gens = torch.arange(20000)
    keys = sampling.request_keys(1, torch.full_like(gens, 3), gens)
    got = sampling.sample_topk_batched(keys, logits.contiguous(), k=4,
                                       fanout=2)
    freq = torch.bincount(got.long(), minlength=6).double() / 20000
    want = torch.softmax(torch.tensor([2.0, 1.0, 0.5, 0.0]), 0).double()
    assert torch.allclose(freq[:4], want, atol=0.015), (freq, want)
    assert freq[4:].sum() == 0


def test_topp_keeps_only_the_nucleus():
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal((400, 200)) * 2).astype(np.float32))
    keys = _keys(list(range(400)), [0] * 400)
    got = sampling.sample_topp_batched(keys, x, p=0.5, k=64, fanout=4)
    vals, idx = sampling.batched_topk(x, 64, fanout=4)
    n_keep = sampling.nucleus_counts(torch.softmax(vals, dim=-1), 0.5)
    rank = (idx == got[:, None]).int().argmax(dim=1)
    assert bool((rank < n_keep).all())
    assert bool((rank > 0).any())  # not always the top candidate
