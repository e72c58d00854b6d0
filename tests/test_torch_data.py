"""The port's data pipeline (``repro_torch.data.pipeline``) against the JAX
package's, on the CPU: documents, bucket orders and packed batches are
integers and must be equal bit for bit, and the bucket order must be
numpy's stable argsort of the lengths."""

import numpy as np
import pytest
import torch

from repro.data import pipeline as ref
from repro_torch.data import pipeline as port

DC = dict(vocab=256, seq_len=64, batch=2, mean_doc_len=16)


def _dcs(**over):
    return ref.DataConfig(**{**DC, **over}), port.DataConfig(**{**DC, **over})


@pytest.mark.parametrize("seed,epoch", [(0, 0), (7, 0), (3, 2)])
def test_synthetic_doc_matches_reference(seed, epoch):
    rdc, dc = _dcs(seed=seed)
    for idx in (0, 1, 17, 12345):
        got = port.synthetic_doc(dc, epoch, idx)
        want = ref.synthetic_doc(rdc, epoch, idx)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fanout", [0, 2, 8])
@pytest.mark.parametrize("n", [1, 5, 64, 100])
def test_bucket_by_length_in_memory_matches_reference(n, fanout):
    lengths = np.random.default_rng(n).integers(4, 40, n)  # many ties
    got = port.bucket_by_length(lengths, fanout, device="cpu")
    np.testing.assert_array_equal(got, ref.bucket_by_length(lengths, fanout))
    np.testing.assert_array_equal(got, np.argsort(lengths, kind="stable"))


def test_bucket_by_length_past_the_external_threshold(tmp_path):
    """A window at the threshold spills runs of half of it and merges them
    (the out-of-core tier): the same order as the reference's tier and the
    in-memory sort."""
    lengths = np.random.default_rng(9).integers(4, 40, 64)
    got = port.bucket_by_length(lengths, external_threshold=32,
                                external_workdir=str(tmp_path / "port"),
                                device="cpu")
    want = ref.bucket_by_length(lengths, external_threshold=32,
                                external_workdir=str(tmp_path / "ref"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.argsort(lengths, kind="stable"))
    assert (tmp_path / "port" / "bucket").is_dir()


def test_pack_documents_matches_reference():
    rdc, dc = _dcs(batch=3, seq_len=20)
    docs = [port.synthetic_doc(dc, 0, i)[: 5 + 7 * i] for i in range(6)]
    for got, want in zip(port.pack_documents(docs, dc),
                         ref.pack_documents(docs, rdc)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rank,world,start", [(0, 1, 0), (1, 2, 3)])
@pytest.mark.parametrize("threshold", [0, 8])
def test_batches_match_reference(rank, world, start, threshold, tmp_path):
    """Three steps of the stream, from ``start`` (a resumed run) on one
    rank of ``world``; with a threshold below the window (8 of 16
    documents) every step's bucketing goes through the external sort."""
    over = dict(external_threshold=threshold,
                external_workdir=str(tmp_path) if threshold else "")
    rdc, dc = _dcs(**over)
    rs = ref.batches(rdc, rank=rank, world=world, start_step=start)
    ps = port.batches(dc, rank=rank, world=world, start_step=start,
                      device="cpu")
    for i in range(3):
        got, want = next(ps), next(rs)
        assert got["step"] == want["step"] == start + i
        for key, dtype in (("tokens", torch.int32), ("labels", torch.int32),
                           ("mask", torch.float32)):
            assert got[key].dtype == dtype and got[key].device.type == "cpu"
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        assert float(got["mask"].sum()) > 0


def test_window_documents_are_the_stream_s_documents():
    """``window_documents`` is the unsorted window ``batches`` buckets and
    packs: sorted by the bucket order, it packs into the stream's batch."""
    _, dc = _dcs()
    docs = port.window_documents(dc, 4)
    assert len(docs) == port.docs_per_step(dc) == 2 * 4 * 2
    order = port.bucket_by_length([len(d) for d in docs], device="cpu")
    tokens, _, _ = port.pack_documents([docs[i] for i in order], dc)
    batch = next(port.batches(dc, start_step=4, device="cpu"))
    np.testing.assert_array_equal(batch["tokens"].numpy(), tokens)


def test_pipeline_defaults_to_the_card():
    """Without a device argument the bucketing runs on the card; without
    one it raises instead of falling back to the CPU."""
    _, dc = _dcs()
    if torch.cuda.is_available():
        assert next(port.batches(dc))["tokens"].device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            port.bucket_by_length(np.arange(8))
