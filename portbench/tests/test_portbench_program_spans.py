"""The program's own spans (``obs.span``: every annotation but the
harness's ``portbench.*`` ones, recorded while the profiler records) leave
the profiled slice's reduction and every per-layer reader as they are."""

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


def test_slice_unchanged_by_program_spans():
    base, spanned = trace.read(EVENTS, steps=2), trace.read(SPANNED, steps=2)
    assert spanned == base


@pytest.mark.parametrize("name", sorted(harness.readers()))
def test_readers_unchanged_by_program_spans(name):
    rd = harness.readers()[name]
    assert rd.read(_view(slice=trace.read(SPANNED, steps=2))) == rd.read(
        _view(slice=trace.read(EVENTS, steps=2)))
