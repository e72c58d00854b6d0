"""The port's telemetry layer (``repro_torch.obs``) on the CPU.

Mirrors ``tests/test_obs.py``'s registry and sink cases, then holds the
port's records against the reference's for the same calls (every field
but ``ts``, and the JSONL lines byte for byte once ``ts`` is taken out),
counts the tensor operations a disabled record point or span dispatches
(none), checks that an enabled record point snapshots its tensors, and
that spans record under a profiler and only there.

The reference's side runs in this file only: ``repro.obs.enable`` and
``disable`` clear JAX's compile caches.
"""

import contextlib
import json
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
import jax.numpy as jnp

from repro import obs as ref_obs
from repro_torch import obs
from repro_torch.obs.sink import ListSink


@pytest.fixture(autouse=True)
def _obs_off():
    assert not obs.enabled()
    yield
    obs.disable()
    obs.set_step(None)


# ---------------------------------------------------------------------------
# registry / sink behaviour
# ---------------------------------------------------------------------------


def test_counter_totals_accumulate():
    with obs.capture() as recs:
        obs.counter("t.hits", 5, tag="a")
        obs.counter("t.hits", torch.arange(3))  # vector counter: summed
        assert obs.totals().get("t.hits", 0) == 0  # nothing flushed yet
        obs.flush()
        assert obs.totals()["t.hits"] == 5 + (0 + 1 + 2)
        assert len([r for r in recs if r["metric"] == "t.hits"]) == 2


def test_histogram_summary_fields():
    with obs.capture() as recs:
        obs.histogram("t.dist", torch.tensor([1.0, 2.0, 3.0, 4.0]))
        obs.flush()
        (r,) = [x for x in recs if x["metric"] == "t.dist"]
        assert r["kind"] == "histogram"
        assert r["count"] == 4
        assert r["min"] == 1.0 and r["max"] == 4.0 and r["sum"] == 10.0
        assert r["p50"] == 2.5 and r["p90"] == pytest.approx(3.7)


def test_tensor_labels_forwarded():
    with obs.capture() as recs:
        obs.gauge("t.lbl", torch.tensor(7, dtype=torch.int32),
                  device=torch.tensor(3), tag="x")
        obs.flush()
        (r,) = [x for x in recs if x["metric"] == "t.lbl"]
        assert r["value"] == 7
        assert r["labels"] == {"tag": "x", "device": 3}


def test_step_label_stamped():
    with obs.capture() as recs:
        obs.set_step(42)
        obs.gauge("t.stepped", 1.0)
        obs.set_step(43)  # the label is the step at record time
        obs.flush()
        (r,) = [x for x in recs if x["metric"] == "t.stepped"]
        assert r["step"] == 42


def test_enable_argument_validation(tmp_path):
    with pytest.raises(ValueError):
        obs.enable()
    with pytest.raises(ValueError):
        obs.enable(metrics_dir=str(tmp_path), sink=ListSink())
    assert not obs.enabled()


def test_capture_nests_without_cross_talk():
    with obs.capture() as outer:
        obs.gauge("t.outer", 1)
        with obs.capture() as inner:
            obs.gauge("t.inner", 2)
            obs.flush()
        obs.gauge("t.outer", 3)
        obs.flush()
        assert [r["metric"] for r in inner] == ["t.inner"]
        outer_names = [r["metric"] for r in outer]
        assert outer_names.count("t.outer") == 2
        assert "t.inner" not in outer_names
    assert not obs.enabled()


def test_jsonl_sink_roundtrip(tmp_path):
    obs.enable(metrics_dir=str(tmp_path))
    try:
        obs.gauge("t.file", torch.tensor(1.5), tag="x")
        obs.log_event("t.event", detail="hello")
        obs.flush()
    finally:
        obs.disable()
    lines = (tmp_path / "metrics.jsonl").read_text().strip().splitlines()
    recs = [json.loads(line) for line in lines]
    assert [r["metric"] for r in recs] == ["t.file", "t.event"]
    assert recs[0]["value"] == 1.5 and recs[1]["labels"] == {"detail": "hello"}


def test_log_event_safe_while_disabled():
    assert not obs.enabled()
    obs.log_event("t.disabled_event", reason="nothing should raise")


def test_records_emitted_in_call_order():
    """Events and tensor records leave the pending list in the order
    they were made, whatever their kind."""
    with obs.capture() as recs:
        obs.gauge("t.a", torch.tensor([1, 2]))
        obs.log_event("t.b")
        obs.counter("t.c")
        obs.histogram("t.d", np.arange(4))
        obs.flush()
        assert [r["metric"] for r in recs] == ["t.a", "t.b", "t.c", "t.d"]


def test_long_arrays_are_summarised():
    with obs.capture() as recs:
        obs.gauge("t.long", torch.arange(2000))
        obs.flush()
        (r,) = recs
        assert r["truncated"] is True and r["count"] == 2000
        assert "value" not in r


# ---------------------------------------------------------------------------
# the reference's records, byte for byte
# ---------------------------------------------------------------------------


def _calls(o, arr):
    """The same record-point calls on either package: ``arr`` makes its
    arrays (a tensor or a JAX array from a numpy array)."""
    o.set_step(3)
    o.counter("t.count", 2, op="merge", backend="torch")
    o.gauge("t.vec", arr(np.array([4, 5, 6], np.int32)), device=arr(np.int32(1)))
    o.gauge("t.float", 0.1, unit="us")
    o.gauge("t.bool", True)
    o.histogram("t.hist", arr(np.array([3.0, 1.0, 2.0, 8.0], np.float32)),
                bound=4)
    o.gauge("t.long", arr(np.arange(1500, dtype=np.int32)))
    o.log_event("t.event", op="stable_merge", n=np.int64(9))
    o.set_step(None)
    o.counter("t.count", arr(np.array([1, 2], np.int32)))


def _torch_arr(a):
    return torch.from_numpy(np.asarray(a).copy())


def test_records_equal_the_reference():
    with ref_obs.capture() as want:
        _calls(ref_obs, jnp.asarray)
        ref_obs.flush()
        want_totals = ref_obs.totals()
    with obs.capture() as got:
        _calls(obs, _torch_arr)
        obs.flush()
        got_totals = obs.totals()
    strip = [{k: v for k, v in r.items() if k != "ts"} for r in want]
    assert [{k: v for k, v in r.items() if k != "ts"} for r in got] == strip
    assert all(isinstance(r["ts"], float) for r in got)
    assert got_totals == want_totals


def test_jsonl_equals_the_reference_but_ts(tmp_path):
    def lines(o, arr, d):
        o.enable(metrics_dir=str(d))
        try:
            _calls(o, arr)
            o.flush()
        finally:
            o.disable()
        text = (d / "metrics.jsonl").read_text()
        assert all(line.startswith('{"ts":') for line in text.splitlines())
        return re.sub(r'^\{"ts":[0-9.e+-]+,', "{", text, flags=re.MULTILINE)

    want = lines(ref_obs, jnp.asarray, tmp_path / "ref")
    got = lines(obs, _torch_arr, tmp_path / "port")
    assert got.count("\n") == 8 and got == want


# ---------------------------------------------------------------------------
# cost: nothing when off, no wait for the device when on
# ---------------------------------------------------------------------------


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _every_point(x, lbl):
    obs.counter("t.c", x, device=lbl)
    obs.gauge("t.g", x, device=lbl)
    obs.histogram("t.h", x, device=lbl)
    obs.record("t.r", x, kind="gauge", device=lbl)
    obs.log_event("t.e", detail="host only")
    with obs.span("t.span"), obs.host_span("t.host"), \
            obs.step_span("decode", 0):
        pass


def test_disabled_points_and_spans_dispatch_nothing():
    x, lbl = torch.arange(6.0), torch.tensor(2)
    with _CountOps() as mode:
        _every_point(x, lbl)
    assert mode.ops == []


def test_enabled_points_only_snapshot():
    """Enabled, a record point clones its tensors (on their own device)
    and nothing else -- no copy to the host until ``flush`` -- and a span
    opens and closes its profiler annotation."""
    x, lbl = torch.arange(6.0), torch.tensor(2)
    with obs.capture() as recs:
        with _CountOps() as mode:
            _every_point(x, lbl)
        assert "aten.clone.default" in mode.ops
        assert set(mode.ops) <= {"aten.detach.default", "aten.clone.default",
                                 "profiler._record_function_enter_new.default",
                                 "profiler._record_function_exit._RecordFunction"}
        assert recs == []
        obs.flush()
        assert [r["metric"] for r in recs] == ["t.c", "t.g", "t.h", "t.r",
                                               "t.e"]


def test_value_updated_in_place_is_recorded_as_it_was():
    length = torch.zeros((), dtype=torch.int32)
    cache = torch.zeros(3)
    with obs.capture() as recs:
        obs.gauge("t.length", length, slots=cache)
        length += 5  # the decode steps update caches and lengths in place
        cache[1] = 9.0
        obs.gauge("t.length", length)
        obs.flush()
        assert [r["value"] for r in recs] == [0, 5]
        assert recs[0]["labels"]["slots"] == [0.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# spans: on only while a profiler records, whatever obs says
# ---------------------------------------------------------------------------


def _spans():
    with obs.span("t.span"), obs.host_span("t.host"), \
            obs.step_span("decode", 0):
        with obs.span("serve.decode"):
            torch.ones(2).sum()


@pytest.mark.parametrize("on", [False, True], ids=["obs_off", "obs_on"])
def test_spans_dispatch_nothing_without_a_profiler(on):
    """With no profiler recording, every span is one shared null context
    and dispatches nothing, whether obs is on or off."""
    assert not torch.autograd.profiler._is_profiler_enabled
    with obs.capture() if on else contextlib.nullcontext():
        assert obs.enabled() == on
        assert obs.span("a") is obs.host_span("b") is obs.step_span("c", 1)
        with _CountOps() as mode:
            with obs.span("t.span"), obs.host_span("t.host"), \
                    obs.step_span("decode", 0):
                pass
        assert mode.ops == []


@pytest.mark.parametrize("on", [False, True], ids=["obs_off", "obs_on"])
def test_spans_are_annotations_under_a_profiler(on):
    """Under ``torch.profiler.profile`` every span is a user annotation of
    the trace, with its name, whether obs is on or off, and an operation
    inside falls within it."""
    with obs.capture() if on else contextlib.nullcontext():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            assert torch.autograd.profiler._is_profiler_enabled
            _spans()
        assert not torch.autograd.profiler._is_profiler_enabled
    events = prof.profiler.kineto_results.events()
    spans = {e.name(): (e.start_ns(), e.end_ns()) for e in events
             if e.is_user_annotation()}
    assert set(spans) == {"t.span", "t.host", "decode#0", "serve.decode"}
    ops = [(x.start_ns(), x.end_ns()) for x in events
           if x.name() == "aten::sum"]
    assert ops
    for name, (lo, hi) in spans.items():  # nested: each holds the operation
        assert all(lo <= s <= e <= hi for s, e in ops), name


# ---------------------------------------------------------------------------
# dispatch counters and the trace dump
# ---------------------------------------------------------------------------


def test_dispatch_counter_and_one_time_log():
    from repro_torch import backend
    from repro_torch.kernels import ops

    a = torch.tensor([1, 3], dtype=torch.int32)
    b = torch.tensor([2, 4], dtype=torch.int32)
    backend._LOGGED_CHOICES.discard(("stable_merge", "torch", "arg"))
    with obs.capture() as recs:
        np.testing.assert_array_equal(
            ops.stable_merge(a, b, backend="torch").numpy(), [1, 2, 3, 4])
        ops.stable_merge(a, b, backend="torch")
        obs.flush()
        chosen = [r for r in recs if r["metric"] == "kernels.backend_selected"]
        assert len(chosen) == 1  # announced once per distinct choice
        assert chosen[0]["labels"]["backend"] == "torch"
        assert chosen[0]["labels"]["source"] == "arg"
        assert obs.totals()["kernels.dispatch_calls"] == 2


def test_profile_writes_a_trace_and_is_idempotent(tmp_path):
    with obs.capture() as recs:
        assert obs.start_profile(str(tmp_path))
        assert not obs.start_profile(str(tmp_path))
        with obs.step_span("decode", 0):
            torch.ones(4).sum()
        assert obs.stop_profile()
        assert not obs.stop_profile()
        obs.flush()
        assert [r["metric"] for r in recs] == ["obs.profile_started",
                                               "obs.profile_stopped"]
    (trace,) = tmp_path.glob("*.pt.trace.json")
    assert "decode#0" in trace.read_text()


# ---------------------------------------------------------------------------
# attach_hlo_report: the collective traffic of a traced step
# ---------------------------------------------------------------------------


def test_attach_hlo_report_takes_stats_or_a_step():
    from repro_torch.launch.hlo_stats import TraceStats

    stats = TraceStats()
    stats.per_op_bytes["all-gather"] += 96
    stats.op_counts["all-gather"] += 2
    with obs.capture() as recs:
        got = obs.attach_hlo_report("decode", stats, arch="qwen3-0.6b")
        traced = obs.attach_hlo_report("step", lambda: torch.ones(3, 3) @ torch.ones(3, 3))
        obs.flush()
    assert got == {"total_bytes": 96, "per_op_bytes": {"all-gather": 96},
                   "op_counts": {"all-gather": 2}}
    assert traced == {"total_bytes": 0, "per_op_bytes": {}, "op_counts": {}}
    assert [r["metric"] for r in recs] == ["hlo.collectives", "hlo.collectives"]
    assert recs[0]["labels"] == {"entry": "decode", "total_bytes": 96,
                                 "per_op_bytes": {"all-gather": 96},
                                 "op_counts": {"all-gather": 2},
                                 "arch": "qwen3-0.6b"}


def test_attach_hlo_report_never_raises():
    def broken():
        raise RuntimeError("no step")

    with obs.capture() as recs:
        assert obs.attach_hlo_report("broken", broken, arch="x") is None
        obs.flush()
    assert [(r["metric"], r["labels"]["error_type"], r["labels"]["entry"])
            for r in recs] == [("hlo.report_failed", "RuntimeError", "broken")]


def test_attach_hlo_report_is_the_reference_s_record():
    """The same event names and label keys as ``repro.obs.attach_hlo_report``
    (whose input is HLO text, here one with no collective)."""
    with obs.capture() as ours:
        obs.attach_hlo_report("e", lambda: None, k=1)
        obs.flush()
    with ref_obs.capture() as theirs:
        ref_obs.attach_hlo_report("e", "HloModule m\n\nENTRY %main () -> () {\n}\n", k=1)
        ref_obs.flush()
    assert [(r["metric"], sorted(r["labels"])) for r in ours] == \
        [(r["metric"], sorted(r["labels"])) for r in theirs]


# ---------------------------------------------------------------------------
# the MoE load gauge
# ---------------------------------------------------------------------------


def _smoke_moe(seed=0):
    from repro_torch.models import moe

    p = moe.init_moe(torch.Generator().manual_seed(seed), 64, 32, 4,
                     device="cpu")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 8, 64)).astype(np.float32))
    return moe, p, x


def _apply(moe, p, x):
    return moe.moe_apply(p, x, n_experts=4, top_k=2, capacity_factor=1.25,
                         dispatch="dropless")


def test_expert_load_gauge_once_per_moe_layer():
    """Under ``obs.capture`` every dropless MoE layer records
    ``moe.expert_load`` once: the largest expert's rows over the mean,
    labelled with the expert count and top-k; a decode step of smoke DBRX
    records it once per layer."""
    from repro_torch.configs.registry import ARCHS, smoke_config
    from repro_torch.models import transformer as tf

    moe, p, x = _smoke_moe()
    _, experts = moe.route_topk(x.reshape(-1, 64) @ p["router"], 2)
    rows = torch.bincount(experts.reshape(-1).long(), minlength=4)
    with obs.capture() as recs:
        _apply(moe, p, x)
        obs.flush()
    load = [r for r in recs if r["metric"] == "moe.expert_load"]
    assert len(load) == 1 and load[0]["kind"] == "gauge"
    assert load[0]["labels"] == {"experts": 4, "top_k": 2}
    assert load[0]["value"] == pytest.approx(float(rows.max()) / (16 * 2 / 4))

    cfg = smoke_config(ARCHS["dbrx-132b"])
    params = tf.compute_params(cfg, tf.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    cache = tf.init_cache(cfg, 3, 8, device="cpu")
    lengths = torch.zeros(3, dtype=torch.int32)
    with obs.capture() as recs:
        for _ in range(2):
            _, cache = tf.decode_step_ragged(
                cfg, params, cache, torch.tensor([[1], [2], [3]]), lengths)
            lengths = cache.length
        obs.flush()
    load = [r for r in recs if r["metric"] == "moe.expert_load"]
    assert len(load) == 2 * cfg.n_layers
    assert all(1.0 <= r["value"] <= cfg.n_experts / cfg.moe_top_k
               for r in load)


def test_expert_load_gauge_dispatches_no_device_op():
    """The gauge is computed from the sizes the dispatch has already read
    to the host: with obs off the layer dispatches exactly what it
    dispatches with obs on, and records nothing."""
    moe, p, x = _smoke_moe(1)
    with _CountOps() as off:
        want = _apply(moe, p, x)
    with obs.capture() as recs:
        with _CountOps() as on:
            got = _apply(moe, p, x)
        obs.flush()
    assert torch.equal(got, want)
    assert off.ops == on.ops and off.ops
    assert [r["metric"] for r in recs].count("moe.expert_load") == 1
