"""Readings that set a cell's limits: the program's on many seeds, and the
control's on the same requests.

    python portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 2

For each seed, one run of the cell as ``run.py`` makes it (a short window:
the batches it starts finish, and the check samples as many requests as a
full run does), then the control: the plain reference computed with every
product in fp8 (``reference/common.py``), the step below the bfloat16 the
configurations state, put in the program's place over the same prompts
and served tokens.  Its ``decode_gap`` is the gap, in the float32
reference's logits, of the token the fp8 logits put first.  The control's
numbers go through ``check.judge`` with the cell's limits, as the
program's do (its sampler choice is the plain sampler's own, so its
``sampler_mismatch`` is 0), and ``control_correct`` has to read false.
One JSON line a seed; ``chiprun_out/`` is a good place for the output of
a long list.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _summary(gaps) -> dict:
    """The widest position gap, and the mean and 90th percentile beside it."""
    import torch

    flat = gaps.flatten().double()
    return {"max": float(flat.max()), "mean": float(flat.mean()),
            "p90": float(torch.quantile(flat, 0.9))}


def control_gaps(ctx) -> dict:
    """The control's position gaps, summarised: at each asked-for position,
    the gap in the float32 reference's logits of the token the fp8
    reference puts first.  Its ``max`` is the control's ``decode_gap``."""
    import torch

    from portbench import check

    low = check.reference_logits(ctx["ref"], ctx["spec"], ctx["weights"],
                                 ctx["sample"], ctx["device"], precision="fp8")
    first = torch.argmax(low, dim=-1)
    return _summary(check.request_gaps(ctx["ref_logits"], ctx["sample"],
                                       list(first)))


def control_judged(gaps: dict, limits: dict) -> tuple[bool, dict]:
    """The control's numbers beside the cell's limits: ``(correct,
    table)``, as ``check.judge`` gives them for the program."""
    from portbench import check

    numbers = {"decode_gap": gaps["max"], "decode_gap_mean": gaps["mean"],
               "sampler_mismatch": 0}
    return check.judge(numbers, limits)


def program_gaps(ctx) -> dict:
    import torch

    from portbench import check

    return _summary(check.request_gaps(
        ctx["ref_logits"], ctx["sample"],
        [torch.argmax(r.logits, dim=-1) for r in ctx["sample"]]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    passed = 0  # seeds on which the control read correct: none may
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        out = harness.run(args.workload, seed, args.seconds, False, keep=True)
        ctx = out.context
        line = {"workload": args.workload, "seed": seed,
                "correct": out.result["correct"],
                "program": {k: v["value"] for k, v in out.result["checks"].items()},
                "program_gaps": program_gaps(ctx),
                "metrics": {k: v["value"] for k, v in out.result["metrics"].items()}}
        line["control_gaps"] = control_gaps(ctx)
        line["control_correct"] = control_judged(
            line["control_gaps"], harness.cell(args.workload)["limits"])[0]
        passed += line["control_correct"]
        print(json.dumps(line), flush=True)
        del out, ctx
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
