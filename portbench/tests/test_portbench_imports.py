"""The benchmark stays apart from JAX, from the JAX package and its old
benchmark, and its references from the program.

Imports are read from every file's syntax tree and compared by whole
top-level names: ``repro_torch`` begins with ``repro`` and is not it.
"""

import ast
import sys
from pathlib import Path

import pytest

from portbench import harness

BENCH = Path(harness.__file__).resolve().parent
FILES = sorted(BENCH.rglob("*.py"))


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not _top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert "repro_torch" not in _top_level_imports(path)


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name != "tests"],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_old_benchmark_not_read(path):
    text = path.read_text()
    assert "benchmarks/" not in text and "BENCH_" not in text


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "jaxtyping", "reproduce"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == [] or set(
        harness.forbidden_modules()) <= {"jax", "jaxlib", "flax", "repro"}
    found_before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert set(harness.forbidden_modules()) == found_before | {"repro", "jaxlib"}


def test_harness_loads_no_jax():
    """A fresh interpreter that imports the harness and every module it
    loads by name holds none of the forbidden modules."""
    import subprocess

    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from portbench import harness, check, control\n"
        "for kind in ('families', 'reference', 'flops', 'paths', 'metrics'):\n"
        "    for p in sorted((harness.BENCH / kind).glob('*.py')):\n"
        "        harness.load_module(kind, p.stem)\n"
        "print(harness.forbidden_modules())\n")
    root = BENCH.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
