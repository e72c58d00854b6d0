"""The control: the plain reference computed in fp8 and put in the
program's place.

On the CPU, at the family's test width (where the program computes in
float32), it reads a ``decode_gap`` far above the program's own on the
same requests.  The cells' limits were set at the cells' own widths, where
gaps are larger, so only a run at the cell's own size can hold the control
against them: the card test does, for every cell, and ``control.py`` does
on many seeds.
"""

import pytest
import torch

from portbench import harness
from portbench.control import control_gaps, control_judged

CELLS = ["mamba2-chat-topk", "dsv3-chat-topk", "mamba2-chat-greedy",
         "dsv3-chat-greedy", "mamba2-chat-topp"]


@pytest.mark.parametrize("cell", ["mamba2-chat-topk", "dsv3-chat-greedy"])
def test_control_reads_far_above_the_program(cell, monkeypatch):
    monkeypatch.setattr(harness, "KEPT_ROWS_PER_BATCH", 4)
    monkeypatch.setattr(harness, "CHECKED_REQUESTS", 64)
    sampler = "topk" if cell.endswith("topk") else "greedy"
    traffic = {"loop": "closed", "clients": 4, "prompt_len": 8,
               "new_tokens": {"lognormal": {"median": 40, "sigma": 1.0},
                              "scale": 0.5, "max": 24},
               "prompt_tokens": "uniform",
               "sampler": sampler, "top_k": 50}
    limits = harness.cell(cell)["limits"]
    program, control = [], []
    for seed in (1, 2, 2**31 + 5):
        out = harness.run(cell, seed, 0.01, False, device="cpu", smoke=True,
                          traffic=traffic, keep=True)
        program.append(out.context["numbers"]["decode_gap"])
        gaps = control_gaps(out.context)
        control.append(gaps["max"])
        assert out.result["correct"], out.result["checks"]
        assert set(control_judged(gaps, limits)[1]) == set(limits)
    assert min(control) > 3 * max(program) and min(control) > 0.1


@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card: "
                    "the control is judged at the cell's own size")
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limits_on_card(cell):
    """At the cell's own size, with its own traffic, the program reads
    correct and the control, judged against the same limits, does not."""
    out = harness.run(cell, 2**32 + 17, 1.0, False, keep=True)
    assert out.result["correct"], out.result["checks"]
    correct, table = control_judged(control_gaps(out.context),
                                    harness.cell(cell)["limits"])
    assert not correct, table
