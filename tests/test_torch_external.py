"""The port's out-of-core sort against numpy and against the JAX reference.

``external_argsort(device="cpu")`` must equal ``np.argsort(kind="stable")``
and the reference's ``external_argsort`` bit for bit, on duplicate-heavy,
+-inf, dtype-max and pre-sorted inputs through several merge passes.  A
crash after some durable windows resumes by replaying exactly the
remaining windows, and a spill directory left by the reference's
interrupted sort is resumed by the port (the run set is the state the two
packages share: the manifest and the ``.npy`` runs).
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.external.api import external_argsort as ref_external_argsort
from repro.external.api import external_sort as ref_external_sort
from repro_torch.external import planner
from repro_torch.external.api import external_argsort, external_sort
from repro_torch.external.runs import MANIFEST_NAME, RunSet


class Boom(RuntimeError):
    pass


def _inputs(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "dup_heavy":
        return rng.integers(0, 4, n).astype(np.int32)
    if kind == "pm_inf":
        f = np.finfo(np.float32)
        base = np.array([np.inf, -np.inf, f.max, f.min, 0.0, -0.0, 1.5],
                        np.float32)
        return base[rng.integers(0, len(base), n)]
    if kind == "dtype_max":
        hi = np.iinfo(np.int32).max
        return rng.choice(np.array([hi, hi - 1, 0, -5], np.int32), n)
    return np.arange(n, dtype=np.int32)  # pre_sorted


@pytest.mark.parametrize("kind", ["dup_heavy", "pm_inf", "dtype_max",
                                  "pre_sorted"])
def test_external_argsort_matches_numpy_and_reference(kind, tmp_path):
    # 12 runs, three merge passes; whole windows keep the reference's
    # compiled shapes few.
    keys = _inputs(kind, 384, seed=len(kind))
    kw = dict(chunk=32, fanout=3, window=16)
    got = np.asarray(external_argsort(keys, workdir=str(tmp_path / "port"),
                                      device="cpu", **kw))
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))
    want = np.asarray(ref_external_argsort(keys, workdir=str(tmp_path / "ref"),
                                           **kw))
    np.testing.assert_array_equal(got, want)


def test_external_sort_keys_only_and_edges(tmp_path):
    rng = np.random.default_rng(3)
    keys = rng.integers(-50, 50, 257).astype(np.int32)
    for sub, kw in (("a", dict(chunk=31, fanout=2)), ("b", dict(chunk=1024))):
        got = external_sort(keys, workdir=str(tmp_path / sub), device="cpu",
                            **kw)
        np.testing.assert_array_equal(np.asarray(got),
                                      np.sort(keys, kind="stable"))
    empty = external_sort(np.empty(0, np.int32), workdir=str(tmp_path / "c"),
                          chunk=8, device="cpu")
    assert len(empty) == 0
    one = external_sort(np.array([7], np.int32), workdir=str(tmp_path / "d"),
                        chunk=8, device="cpu")
    np.testing.assert_array_equal(np.asarray(one), [7])


@pytest.mark.parametrize("fanout", [3, 8])
def test_external_sort_wide_dtypes_and_ragged_groups(tmp_path, fanout):
    """11 runs (fanout 8 leaves a tail group of 3), int64 keys, float64
    payload."""
    rng = np.random.default_rng(fanout)
    keys = rng.integers(-(1 << 40), 1 << 40, 11 * 23 - 5)
    keys[::7] = np.iinfo(np.int64).max
    vals = rng.standard_normal(len(keys))
    sk, sv = external_sort(keys, vals, chunk=23, fanout=fanout, window=19,
                           workdir=str(tmp_path), device="cpu")
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), keys[order])
    np.testing.assert_array_equal(np.asarray(sv), vals[order])


def test_external_sort_runs_on_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        external_argsort(np.arange(4, dtype=np.int32), chunk=2,
                         workdir=str(tmp_path))


def test_crash_resume_replays_exactly_the_remaining_windows(tmp_path):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 100, 700).astype(np.int32)
    vals = np.arange(700, dtype=np.int32)
    kw = dict(chunk=97, fanout=3, window=29, cleanup=False, device="cpu")

    full = []
    external_sort(keys, vals, workdir=str(tmp_path / "full"),
                  on_window=lambda *a: full.append(a), **kw)

    crashed = []

    def crash(*where):
        crashed.append(where)
        if len(crashed) == 3:
            raise Boom

    wd = str(tmp_path / "crashy")
    with pytest.raises(Boom):
        external_sort(keys, vals, workdir=wd, on_window=crash, **kw)
    resumed = []
    sk, sv = external_sort(keys, vals, workdir=wd,
                           on_window=lambda *a: resumed.append(a), **kw)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), keys[order])
    np.testing.assert_array_equal(np.asarray(sv), order)
    assert resumed == full[3:]


def test_port_resumes_a_spill_directory_of_the_reference(tmp_path):
    """The reference spills and is interrupted mid-merge; the port resumes
    in the same workdir and finishes bit-exact: the manifest and the run
    files are read the same way by both packages."""
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 30, 600).astype(np.int32)
    vals = np.arange(600, dtype=np.int32)
    kw = dict(chunk=71, fanout=3, window=23, cleanup=False)
    wd = str(tmp_path / "shared")

    ref_windows = []

    def crash(*where):
        ref_windows.append(where)
        if len(ref_windows) == 5:
            raise Boom

    with pytest.raises(Boom):
        ref_external_sort(keys, vals, workdir=wd, on_window=crash, **kw)
    with open(os.path.join(wd, MANIFEST_NAME)) as f:
        state = json.load(f)
    assert state["merge"]["windows_done"] == 5

    full = []
    external_sort(keys, vals, workdir=str(tmp_path / "clean"), device="cpu",
                  on_window=lambda *a: full.append(a), **kw)
    resumed = []
    sk, sv = external_sort(keys, vals, workdir=wd, device="cpu",
                           on_window=lambda *a: resumed.append(a), **kw)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), keys[order])
    np.testing.assert_array_equal(np.asarray(sv), order)
    assert resumed == full[5:]  # nothing the reference finished is redone


def test_runset_manifest_round_trips_between_packages(tmp_path):
    from repro.external.runs import RunSet as RefRunSet
    from repro.external.runs import spill_run as ref_spill_run
    from repro_torch.external.runs import spill_run

    keys = np.arange(10, dtype=np.int32)
    meta = {"n": 20, "chunk": 10}
    rs = RunSet(str(tmp_path), meta)
    rs.add_chunk_run(spill_run(str(tmp_path), "run_p0_c00000", keys, keys))
    back = RefRunSet.load(str(tmp_path))
    assert back.matches(meta) and back.chunks_done == 1
    assert back.passes[0][0].key_path == rs.passes[0][0].key_path
    back.add_chunk_run(ref_spill_run(str(tmp_path), "run_p0_c00001", keys))
    again = RunSet.load(str(tmp_path))
    assert [r.to_json(str(tmp_path)) for r in again.passes[0]] == [
        r.to_json(str(tmp_path)) for r in back.passes[0]]


def test_fingerprint_matches_reference():
    from repro.external.merge import _fingerprint as ref_fingerprint
    from repro_torch.external.merge import _fingerprint

    for keys in (np.arange(1000, dtype=np.int32),
                 np.linspace(-1, 1, 77).astype(np.float32),
                 np.empty(0, np.int32)):
        assert _fingerprint(keys, len(keys)) == ref_fingerprint(keys, len(keys))


def test_host_planner_matches_window_ranks():
    assert planner.window_ranks(10, 4) == [(0, 4), (4, 8), (8, 10)]
    assert planner.window_ranks(0, 4) == []


def test_torn_manifest_restarts_cleanly(tmp_path):
    (tmp_path / MANIFEST_NAME).write_text('{"torn', encoding="ascii")
    assert RunSet.load(str(tmp_path)) is None
    got = external_sort(np.array([3, 1, 2, 0], np.int32),
                        workdir=str(tmp_path), chunk=2, device="cpu")
    np.testing.assert_array_equal(np.asarray(got), [0, 1, 2, 3])
