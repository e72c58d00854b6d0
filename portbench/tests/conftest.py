"""Run from anywhere: ``pytest portbench/tests`` finds the benchmark (the
checkout's root) and the port (``src``)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
