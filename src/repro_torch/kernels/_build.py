"""Build the port's CUDA kernels from ``kernels/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``.  Nothing is built at import: the first CUDA call builds what it
needs, and :func:`build` compiles several sources at once, one ``nvcc``
process each.  Libraries live in ``build/repro_torch/`` at the repository
root, named by a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source is rebuilt and an unchanged one is
reused.  A failed build raises with ``nvcc``'s output; ``-Xptxas -v``'s
report of registers and shared memory is kept beside each library as
``<lib>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build", "load", "lib_path"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("merge_tile", "merge_kway_tile", "ssd_step")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
        "repro_torch are built from source at their first call"
    )


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built.  The
    name hashes the source, the shared headers ``csrc/*.cuh`` and the
    flags."""
    text = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> list[str]:
    """Compile every named source whose library is missing; all ``nvcc``
    processes run at once.  Returns the names actually compiled."""
    pending = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        )
        pending[name] = (proc, tmp, out)
    errors = []
    for name, (proc, tmp, out) in pending.items():
        text, _ = proc.communicate()
        out.with_name(out.name + ".log").write_bytes(text)
        if proc.returncode:
            errors.append(
                f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
                + text.decode(errors="replace")
            )
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return list(pending)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
