"""The port's examples (``examples/torch_*.py``) run on the CPU at their
smallest size, each in a subprocess with ``--device cpu``; each ends with
``ok``."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

EXAMPLES = {
    "torch_quickstart.py": [],
    "torch_serve_lm.py": [],
    "torch_train_lm.py": ["--steps", "4"],
    "torch_distributed_sort.py": ["--ranks", "4"],
}


@pytest.mark.parametrize("script", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(script, tmp_path):
    args = list(EXAMPLES[script])
    if script == "torch_train_lm.py":
        args += ["--ckpt-dir", str(tmp_path / "ck")]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    p = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                        "--device", "cpu", *args], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
    if script == "torch_serve_lm.py":
        assert "served 4 requests" in p.stdout
    else:
        assert p.stdout.strip().splitlines()[-1] == "ok"
