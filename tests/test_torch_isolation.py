"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and no ``examples/torch_*.py`` imports ``jax`` or the
reference package ``repro``."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))
IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|repro)\b", re.MULTILINE)


def test_sources_import_neither_jax_nor_repro():
    assert len(PORT_FILES) > 10
    offenders = [
        f"{path.relative_to(ROOT)}: {m.group(0).strip()}"
        for path in PORT_FILES
        for m in IMPORT.finditer(path.read_text())
    ]
    assert not offenders, offenders


@pytest.fixture(scope="module")
def fresh_import():
    """One interpreter with ``jax`` and ``repro`` blocked imports the whole
    port and reports what it loaded and whether anything was built."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.core, repro_torch.kernels.ops, "
        "repro_torch.external, repro_torch.obs\n"
        "import repro_torch.kernels.merge, repro_torch.kernels._build as b\n"
        "import repro_torch.serving, repro_torch.launch.serve, "
        "repro_torch.models.convert, repro_torch.configs.registry\n"
        "import repro_torch.models.ssm, repro_torch.core.baselines\n"
        "import repro_torch.train, repro_torch.train.optimizer, "
        "repro_torch.train.train_step, repro_torch.train.compress\n"
        "import repro_torch.data, repro_torch.data.pipeline\n"
        "import repro_torch.checkpoint, repro_torch.checkpoint.checkpointer\n"
        "import repro_torch.launch.train, repro_torch.launch.mesh, "
        "repro_torch.launch.sharding, repro_torch.launch.hlo_stats, "
        "repro_torch.launch.dryrun\n"
        "import repro_torch.distributed, warnings\n"
        "import repro_torch.kernels.bench\n"
        "from repro_torch.kernels.merge import merge_kway_groups_wide\n"
        "import torch\n"
        "print('ops', sorted(n for n in ('merge_tile', 'merge_kway_tile', "
        "'merge_kway_groups', 'merge_kway_groups_wide') "
        "if hasattr(torch.ops.repro_torch, n)))\n"
        "with warnings.catch_warnings(record=True) as caught:\n"
        "    warnings.simplefilter('always')\n"
        "    import repro_torch.core.distributed\n"
        "print('shim warns', [w.category.__name__ for w in caught])\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None "
        "and (m in ('jax', 'repro') or m.startswith(('jax.', 'repro.'))))\n"
        "print('foreign', bad)\n"
        "print('built', sorted(b._loaded))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert res.returncode == 0, res.stderr
    return res.stdout.splitlines()


def test_package_imports_with_jax_and_repro_blocked(fresh_import):
    assert "foreign []" in fresh_import


def test_importing_the_port_builds_nothing(fresh_import):
    assert "built []" in fresh_import


def test_distributed_shim_warns_on_import(fresh_import):
    assert "shim warns ['DeprecationWarning']" in fresh_import


def test_the_four_custom_ops_register_without_jax(fresh_import):
    """Both grouped launches' ops (and the two tiled ones) register when the
    port is imported with ``jax`` and ``repro`` blocked, and nothing is
    built for them."""
    assert ("ops ['merge_kway_groups', 'merge_kway_groups_wide', "
            "'merge_kway_tile', 'merge_tile']") in fresh_import
