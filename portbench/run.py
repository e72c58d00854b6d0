"""Run one cell of the port's benchmark on this machine's card.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the numbers compared, each beside
its limit, as the last lines of standard error, and one JSON object as
the last line of standard output.  Exits non-zero, printing no result,
without a CUDA card (or fewer than the cell asks for), and when JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench import harness

    c = harness.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c["chips"]:
        print(f"{args.workload}: needs {c['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"window: {json.dumps(out.window)}", file=sys.stderr)
    for line in harness.check_lines(out.result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
