"""Deterministic, resumable data pipeline with merge-sort length bucketing
(torch port of ``repro.data.pipeline``).

* **Determinism and resumability**: a document is a pure function of
  (seed, epoch, index), so a restarted job regenerates the exact stream
  with no state files.
* **Sharding**: each data-parallel rank reads a disjoint strided slice.
* **Length bucketing with the paper's sort**: each step's window of
  documents is stably merge-sorted by length before packing
  (``core.mergesort.sort_key_val`` on the device: on the card, the
  grouped launch of ``merge_kway_tile``); past ``external_threshold``
  documents the out-of-core tier (``external.external_argsort``) sorts
  them, its windows merged by ``merge_kway_tile``.  Stability keeps the
  document order within a length class deterministic.
* **Packing**: greedy fill of ``seq_len``-token rows from the sorted
  stream, with EOS separators and a loss mask over the padding.

The documents, the bucket order and the packed rows are integers and
equal the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.mergesort import sort_key_val

__all__ = ["DataConfig", "synthetic_doc", "docs_per_step",
           "window_documents", "bucket_by_length", "pack_documents",
           "batches"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch: int  # per-host batch
    seed: int = 0
    mean_doc_len: int = 512
    eos: int = 0
    fanout: int = 0  # length-bucketing merge-sort fan-out; 0 = default
    # Out-of-core tier (repro_torch.external): windows of >=
    # external_threshold documents bucket through the spill-to-host
    # external sort; 0 = always in memory.  external_workdir holds the
    # spill files ('' = a per-process temporary directory).
    external_threshold: int = 0
    external_workdir: str = ""


def synthetic_doc(dc: DataConfig, epoch: int, idx: int) -> np.ndarray:
    """A deterministic document with learnable structure: an arithmetic
    chain ``t_{n+1} = (t_n + stride) mod A`` with occasional random
    restarts, so that a model that learns it drives the loss well below
    ``log V``."""
    rng = np.random.default_rng(
        np.uint64(dc.seed) * np.uint64(1_000_003)
        + np.uint64(epoch) * np.uint64(10_007)
        + np.uint64(idx)
    )
    ln = int(rng.integers(dc.mean_doc_len // 4, dc.mean_doc_len * 2))
    stride = int(rng.integers(1, 4))  # per-doc stride, inferable from context
    alphabet = min(dc.vocab - 1, 1024)
    out = np.empty(ln, np.int64)
    t = int(rng.integers(0, alphabet))
    for i in range(ln):
        out[i] = 1 + t
        if rng.random() < 0.02:  # restart: irreducible entropy floor
            t = int(rng.integers(0, alphabet))
        else:
            t = (t + stride) % alphabet
    return out.astype(np.int32)


def docs_per_step(dc: DataConfig) -> int:
    """Documents in one step's window: twice the batch's rows' worth."""
    return dc.batch * max(dc.seq_len // dc.mean_doc_len, 1) * 2


def window_documents(dc: DataConfig, step: int, *, rank: int = 0,
                     world: int = 1) -> list:
    """The documents of ``step``'s window for one rank, unsorted."""
    epoch = step >> 20
    base = (step % (1 << 20)) * docs_per_step(dc) * world
    return [synthetic_doc(dc, epoch, base + rank + world * i)
            for i in range(docs_per_step(dc))]


def bucket_by_length(lengths, fanout: int = 0, *,
                     external_threshold: int = 0, external_workdir: str = "",
                     device="cuda") -> np.ndarray:
    """Stable merge-argsort of document lengths (the paper's sort) on
    ``device`` (the card unless the caller passes ``"cpu"``): an int32
    permutation.  Windows of at least ``external_threshold`` documents go
    through ``external_argsort`` (chunks of half the threshold, so that
    crossing it spills at least two runs), smaller ones through the
    in-memory merge sort."""
    n = len(lengths)
    if external_threshold and n >= external_threshold:
        from repro_torch.external.api import external_argsort

        workdir = external_workdir or os.path.join(
            tempfile.gettempdir(), f"repro-external-{os.getpid()}")
        order = external_argsort(
            np.asarray(lengths, np.int32),
            chunk=max(1, external_threshold // 2),
            workdir=os.path.join(workdir, "bucket"), resume=False,
            device=device)
        return np.array(order)
    keys = torch.as_tensor(np.asarray(lengths, np.int32), device=device)
    idx = torch.arange(n, dtype=torch.int32, device=device)
    _, order = sort_key_val(keys, idx, fanout=fanout)
    return order.cpu().numpy()


def pack_documents(docs, dc: DataConfig):
    """Pack docs into (batch, seq_len) rows with EOS separators.

    Returns tokens, labels (shift-by-one), mask (0 on pad)."""
    rows = np.full((dc.batch, dc.seq_len + 1), dc.eos, np.int32)
    mask = np.zeros((dc.batch, dc.seq_len + 1), np.float32)
    r, col = 0, 0
    for doc in docs:
        take = doc[: dc.seq_len]  # clamp overlong docs
        while len(take) and r < dc.batch:
            space = dc.seq_len + 1 - col
            n = min(space, len(take) + 1)  # +1 for EOS
            rows[r, col : col + n - 1] = take[: n - 1]
            mask[r, col : col + n - 1] = 1.0
            col += n
            take = take[n - 1 :]
            if col >= dc.seq_len + 1:
                r, col = r + 1, 0
        if r >= dc.batch:
            break
    tokens = rows[:, :-1]
    labels = rows[:, 1:]
    return tokens, labels.astype(np.int32), mask[:, 1:]


def batches(dc: DataConfig, *, rank: int = 0, world: int = 1,
            start_step: int = 0, device="cuda") -> Iterator[dict]:
    """Infinite deterministic batch stream for one data-parallel rank, as
    tensors on ``device`` (the card unless the caller passes ``"cpu"``):
    int32 ``tokens`` and ``labels``, float32 ``mask``, and the ``step``.

    ``start_step`` resumes mid-epoch after a restart (pure recomputation).
    Each step buckets its window of documents by length with the stable
    merge sort, then packs them.
    """
    step = start_step
    while True:
        docs = window_documents(dc, step, rank=rank, world=world)
        workdir = dc.external_workdir and os.path.join(
            dc.external_workdir, f"rank{rank}")
        order = bucket_by_length(
            [len(d) for d in docs], fanout=dc.fanout,
            external_threshold=dc.external_threshold,
            external_workdir=workdir, device=device)
        tokens, labels, mask = pack_documents([docs[i] for i in order], dc)
        yield {
            "tokens": torch.from_numpy(tokens.copy()).to(device),
            "labels": torch.from_numpy(labels.copy()).to(device),
            "mask": torch.from_numpy(mask.copy()).to(device),
            "step": step,
        }
        step += 1
