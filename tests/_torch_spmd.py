"""Run a test module's SPMD cases in fresh processes: ``p`` gloo ranks of
the port on the CPU, and the reference under ``shard_map`` on ``p`` fake
JAX devices, all at once.

A test module that uses this is also a script: ``python <module> rank R
P INIT OUT`` runs rank ``R`` of ``P`` (its process group rendezvous in the
file ``INIT``) and writes ``OUT/rank<R>.npz``; ``python <module>
reference P OUT`` writes ``OUT/reference.npz``.  The main pytest process
keeps one JAX device and no process group.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 600


def run(module: str, world: int, out: Path):
    """Start the reference and ``world`` ranks of ``module``; wait for
    every one (a rank that fails or hangs fails the run).  Returns
    ``(reference, [rank results])`` as dicts of arrays."""
    out.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    script = str(REPO / "tests" / module)
    cmds = [[sys.executable, script, "reference", str(world), str(out)]]
    cmds += [[sys.executable, script, "rank", str(r), str(world),
              str(out / "init"), str(out)] for r in range(world)]
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    try:
        for proc in procs:
            text, _ = proc.communicate(timeout=TIMEOUT)
            logs.append(text)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [(c[2:4], log[-3000:]) for c, proc, log in zip(cmds, procs, logs)
              if proc.returncode]
    assert not failed, failed

    def load(name):
        with np.load(out / name) as f:
            return dict(f)

    return load("reference.npz"), [load(f"rank{r}.npz") for r in range(world)]


def main(rank_fn, reference_fn) -> None:
    """The script entry of a test module (see the module docstring)."""
    mode = sys.argv[1]
    if mode == "rank":
        import datetime

        import torch.distributed as dist

        r, world, init, out = sys.argv[2:6]
        dist.init_process_group(
            "gloo", init_method=f"file://{init}", rank=int(r),
            world_size=int(world), timeout=datetime.timedelta(seconds=300))
        try:
            res = rank_fn(int(r), int(world))
        finally:
            dist.destroy_process_group()
        np.savez(Path(out) / f"rank{r}.npz", **res)
    else:
        world, out = int(sys.argv[2]), Path(sys.argv[3])
        os.environ["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={world} "
            + os.environ.get("XLA_FLAGS", ""))
        np.savez(out / "reference.npz", **reference_fn(world))


def bits(x: np.ndarray) -> np.ndarray:
    """The bit pattern of ``x`` (-0.0 and 0.0 differ)."""
    x = np.asarray(x)
    if x.dtype.kind == "f":
        return x.view({2: np.int16, 4: np.int32, 8: np.int64}[x.itemsize])
    return x


def assert_bits(got, want, what: str = "") -> None:
    """Equal shapes and values; floats bit for bit, in one dtype."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if "f" in (got.dtype.kind, want.dtype.kind):
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=what)
