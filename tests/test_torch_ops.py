"""Dispatch policy of the port's kernel entry points (``repro_torch.kernels.ops``).

A bad backend name raises; ``cuda`` on a CPU tensor raises (no silent
fallback); ``auto`` picks ``torch`` on the CPU; the port reads its own
environment variable, so the reference's variable does not steer it and
its variable does not steer the reference.  Results on the CPU backends
match the JAX reference's ``xla`` paths bit for bit.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops


def _runs(seed=0, k=4, w=37):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, 6, (k, w)), axis=1).astype(np.int32)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.delenv(ops.BACKEND_ENV_VAR, raising=False)
    monkeypatch.delenv(ref_ops.BACKEND_ENV_VAR, raising=False)


def test_env_var_is_the_ports_own():
    assert ops.BACKEND_ENV_VAR == "REPRO_TORCH_MERGE_BACKEND"
    assert ops.BACKEND_ENV_VAR != ref_ops.BACKEND_ENV_VAR
    assert ops.VALID_BACKENDS == ("cuda", "torch", "torch_native")


def test_auto_picks_torch_on_cpu_and_cuda_on_the_card():
    assert ops.default_backend("cpu") == "torch"
    assert ops.default_backend(torch.device("cuda", 0)) == "cuda"


@pytest.mark.parametrize("entry", ["stable_merge", "stable_merge_kway",
                                   "merge_window", "stable_sort"])
def test_bad_backend_name_raises(entry):
    x = torch.zeros((2, 8), dtype=torch.int32)
    args = (x[0], x[1]) if entry == "stable_merge" else (
        (x[0],) if entry == "stable_sort" else (x,))
    with pytest.raises(ValueError, match="backend must be one of"):
        getattr(ops, entry)(*args, backend="pallas")


@pytest.mark.parametrize("entry", ["stable_merge", "stable_merge_kway",
                                   "merge_window", "stable_sort"])
def test_cuda_backend_on_cpu_tensor_raises(entry, monkeypatch):
    x = torch.zeros((2, 8), dtype=torch.int32)
    args = (x[0], x[1]) if entry == "stable_merge" else (
        (x[0],) if entry == "stable_sort" else (x,))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        getattr(ops, entry)(*args, backend="cuda")
    monkeypatch.setenv(ops.BACKEND_ENV_VAR, "cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        getattr(ops, entry)(*args)


def test_bad_env_value_raises_and_does_not_touch_reference(monkeypatch):
    runs = _runs()
    monkeypatch.setenv(ops.BACKEND_ENV_VAR, "pallas")
    with pytest.raises(ValueError, match=ops.BACKEND_ENV_VAR):
        ops.stable_merge_kway(torch.from_numpy(runs))
    # The reference ignores the port's variable (fresh shape: no jit cache).
    got = ref_ops.stable_merge_kway(jnp.asarray(_runs(k=2, w=41)))
    assert got.shape == (82,)


def test_reference_env_does_not_steer_the_port(monkeypatch):
    monkeypatch.setenv(ref_ops.BACKEND_ENV_VAR, "bogus")
    runs = _runs(1)
    got = ops.stable_merge_kway(torch.from_numpy(runs))
    np.testing.assert_array_equal(got.numpy(),
                                  np.sort(runs.reshape(-1), kind="stable"))


@pytest.mark.parametrize("backend", [None, "torch", "torch_native"])
def test_cpu_backends_match_reference(backend, monkeypatch):
    rng = np.random.default_rng(3)
    a = np.sort(rng.integers(0, 5, 50)).astype(np.int32)
    b = np.sort(rng.integers(0, 5, 31)).astype(np.int32)
    runs = _runs(2)
    x = rng.integers(0, 9, 70).astype(np.int32)
    np.testing.assert_array_equal(
        ops.stable_merge(torch.from_numpy(a), torch.from_numpy(b),
                         backend=backend).numpy(),
        np.asarray(ref_ops.stable_merge(jnp.asarray(a), jnp.asarray(b),
                                        backend="xla")))
    np.testing.assert_array_equal(
        ops.stable_merge_kway(torch.from_numpy(runs), backend=backend).numpy(),
        np.asarray(ref_ops.stable_merge_kway(jnp.asarray(runs),
                                             backend="xla")))
    np.testing.assert_array_equal(
        ops.stable_sort(torch.from_numpy(x), backend=backend).numpy(),
        np.asarray(ref_ops.stable_sort(jnp.asarray(x), backend="xla")))


def test_env_selects_torch_native_sort(monkeypatch):
    monkeypatch.setenv(ops.BACKEND_ENV_VAR, "torch_native")
    x = np.array([3.0, -0.0, 0.0, 1.0, -0.0], np.float32)
    got = ops.stable_sort(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sort(x, kind="stable").view(np.int32))


def test_merge_window_ragged_matches_reference():
    hi = np.iinfo(np.int32).max
    lengths = np.array([37, 0, 12, 30], np.int32)
    rng = np.random.default_rng(4)
    runs = np.full((4, 37), hi, np.int32)
    vals = np.zeros((4, 37), np.int32)
    for q, n in enumerate(lengths):
        runs[q, :n] = np.sort(rng.choice(np.array([hi, 2, 0], np.int32), n))
        vals[q, :n] = rng.integers(0, 1000, n)
    total = int(lengths.sum())
    gk, gv = ops.merge_window(torch.from_numpy(runs), torch.from_numpy(vals),
                              torch.from_numpy(lengths), out_len=total)
    wk, wv = ref_ops.merge_window(jnp.asarray(runs), jnp.asarray(vals),
                                  jnp.asarray(lengths), out_len=total,
                                  backend="xla")
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
