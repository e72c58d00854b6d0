"""The program's own spans (``obs.span``: every annotation but the
harness's ``portbench.*`` ones, recorded while the profiler records) are
kept on the profiled slice as named host intervals, leave everything else
the slice holds and every other per-layer reader as they are, and give the
MoE layer's readers their inclusive host time a step and the device time
of what was launched inside."""

import dataclasses

import pytest

from portbench import harness, trace
from test_portbench_arithmetic import EVENTS, _Ev, _view

# The synthetic events of the arithmetic tests with the program's spans
# around them: a step marker over both harness spans, ``serve.sample``
# holding ``sample.topk`` (around the merge kernel's launch), and
# ``serve.decode`` holding ``model.ssm`` holding ``ssm.state_write``
# (around the gemm's launch); one on the device's timeline too.
SPANNED = EVENTS + [
    _Ev("user_annotation", "decode#8", 0, 300),
    _Ev("user_annotation", "serve.sample", 0, 100),
    _Ev("user_annotation", "sample.topk", 15, 40),
    _Ev("user_annotation", "serve.decode", 100, 300),
    _Ev("user_annotation", "model.ssm", 140, 200),
    _Ev("user_annotation", "ssm.state_write", 145, 160),
    _Ev("gpu_user_annotation", "serve.decode", 300, 460),
]

# Two steps of a model with two MoE layers: in the first step's first
# layer ``moe.dispatch`` holds another ``moe.dispatch`` (counted once) and
# a ``moe.experts`` holds a nested ``moe.experts``; each layer's spans
# repeat (summed).  Dispatch: 10+10+10+10 = 40 ns; experts: 30+20+20+20
# = 90 ns, over 2 steps.
MOE = EVENTS + [
    _Ev("user_annotation", "moe.dispatch", 110, 120),
    _Ev("user_annotation", "moe.dispatch", 112, 118),
    _Ev("user_annotation", "moe.experts", 120, 150),
    _Ev("user_annotation", "moe.experts", 125, 140),
    _Ev("user_annotation", "moe.dispatch", 160, 170),
    _Ev("user_annotation", "moe.experts", 170, 190),
    _Ev("user_annotation", "moe.dispatch", 200, 210),
    _Ev("user_annotation", "moe.experts", 210, 230),
    _Ev("user_annotation", "moe.dispatch", 240, 250),
    _Ev("user_annotation", "moe.experts", 250, 270),
    _Ev("gpu_user_annotation", "moe.experts", 300, 400),
]


# Device operations launched inside the MoE spans of two layers: the first
# layer's ``moe.dispatch`` holds a nested one around its sort's launch
# (counted once) and launches the sizes' copy; its two expert products
# overlap on the device (their union counts); one kernel is launched
# outside every MoE span.  Dispatch: 10 + 2 + 10 = 22 ns; experts: 40 + 30
# = 70 ns; host: 200 ns each; over 2 steps.
MOE_DEVICE = [
    _Ev("user_annotation", "moe.dispatch", 0, 100),
    _Ev("user_annotation", "moe.dispatch", 10, 50),
    _Ev("user_annotation", "moe.experts", 100, 200),
    _Ev("user_annotation", "moe.dispatch", 300, 400),
    _Ev("user_annotation", "moe.experts", 400, 500),
    _Ev("cuda_runtime", "cudaLaunchKernel", 20, 21, 1),
    _Ev("kernel", "sort", 1000, 1010, 1),
    _Ev("cuda_runtime", "cudaMemcpyAsync", 60, 61, 2),
    _Ev("gpu_memcpy", "Memcpy DtoH", 1010, 1012, 2),
    _Ev("cuda_runtime", "cudaLaunchKernel", 150, 151, 3),
    _Ev("kernel", "gemm", 1020, 1050, 3),
    _Ev("cuda_runtime", "cudaLaunchKernel", 160, 161, 4),
    _Ev("kernel", "gemm", 1040, 1060, 4),
    _Ev("cuda_runtime", "cudaLaunchKernel", 350, 351, 5),
    _Ev("kernel", "sort", 1100, 1110, 5),
    _Ev("cuda_runtime", "cudaLaunchKernel", 450, 451, 6),
    _Ev("kernel", "gemm", 1110, 1140, 6),
    _Ev("cuda_runtime", "cudaLaunchKernel", 600, 601, 7),
    _Ev("kernel", "other", 1200, 1300, 7),
]
MOE_READERS = {"moe_dispatch_ms", "expert_ffn_ms", "moe_dispatch_device_ms",
               "expert_ffn_device_ms"}


def test_slice_unchanged_by_program_spans():
    """Every field but the program's intervals, every op's span and the
    idle gaps' names are the slice's without them; the intervals hold
    each host annotation outside ``portbench.*`` by name."""
    base, spanned = trace.read(EVENTS, steps=2), trace.read(SPANNED, steps=2)
    assert base.program_spans == {}
    assert dataclasses.replace(spanned, program_spans={}) == base
    assert spanned.program_spans == {
        "decode#8": [(0, 300)], "serve.sample": [(0, 100)],
        "sample.topk": [(15, 40)], "serve.decode": [(100, 300)],
        "model.ssm": [(140, 200)], "ssm.state_write": [(145, 160)]}
    assert spanned.program_s("model.ssm") == pytest.approx(60e-9)
    assert spanned.program_s("moe.dispatch") is None


@pytest.mark.parametrize("events", [SPANNED, MOE], ids=["ssm", "moe"])
@pytest.mark.parametrize("name", sorted(set(harness.readers()) - MOE_READERS))
def test_readers_unchanged_by_program_spans(name, events):
    rd = harness.readers()[name]
    assert rd.read(_view(slice=trace.read(events, steps=2))) == rd.read(
        _view(slice=trace.read(EVENTS, steps=2)))


@pytest.mark.parametrize("name, want", [("moe_dispatch_ms", 40e-6 / 2),
                                        ("expert_ffn_ms", 90e-6 / 2)])
def test_moe_readers_sum_nested_and_repeated_spans(name, want):
    rd = harness.readers()[name]
    assert rd.read(_view(slice=trace.read(MOE, steps=2))) == pytest.approx(want)
    assert rd.read(_view(slice=trace.read(SPANNED, steps=2))) is None
    assert rd.read(_view(slice=None)) is None


def test_launched_in_takes_each_operation_once():
    sl = trace.read(MOE_DEVICE, steps=2)
    assert [o.end - o.start for o in sl.launched_in("moe.dispatch")] == [10, 2, 10]
    assert [o.end - o.start for o in sl.launched_in("moe.experts")] == [30, 20, 30]
    assert sl.launched_in("model.attn") is None


@pytest.mark.parametrize("name, want", [
    ("moe_dispatch_device_ms", 22e-6 / 2), ("expert_ffn_device_ms", 70e-6 / 2),
    ("moe_dispatch_ms", 200e-6 / 2), ("expert_ffn_ms", 200e-6 / 2)])
def test_moe_device_readers_take_what_was_launched_inside(name, want):
    rd = harness.readers()[name]
    assert rd.read(_view(slice=trace.read(MOE_DEVICE, steps=2))) == pytest.approx(want)
    assert rd.read(_view(slice=trace.read(SPANNED, steps=2))) is None
