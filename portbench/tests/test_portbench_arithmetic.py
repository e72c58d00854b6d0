"""The yardstick's arithmetic on inputs whose answers are known by hand:
percentile, rate, interval union, byte bound, FLOPs a token, the
profiled slice's reduction and the per-layer readers."""


import pytest

from portbench import harness, roofline, stats, trace

BENCH = harness.BENCH


def test_percentile_rate_spread_union():
    assert stats.percentile([4, 1, 3, 2], 50) == 2.5
    assert stats.percentile(range(101), 95) == 95
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([0, 10], 95) == pytest.approx(9.5)
    assert stats.rate(300, 10) == 30
    assert stats.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


def test_byte_bound():
    peaks = {"hbm_bytes_per_s": 3.35e12, "bf16_flop_per_s": 989e12}
    assert roofline.topk_bytes(32, 50280, 50) == 32 * (50280 * 4 + 50 * 8)
    assert roofline.byte_bound_s(3.35e12, peaks) == 1.0
    assert roofline.flop_bound_s(989e12, peaks) == 1.0


def _spec(name):
    return harness.config(name)


def test_flops_mamba2():
    f = harness.load_module("flops", "mamba2")
    layer = (2 * 2560 * 10576 + 2 * 4 * 5376 + 4 * 80 * 64 * 128
             + 2 * 80 * 64 * 128 + 2 * 5120 * 2560)
    want = 64 * layer + 2 * 2560 * 50288
    assert f.per_token(_spec("mamba2-2.7b"), 0) == want == 5_655_150_592
    assert f.per_token(_spec("mamba2-2.7b"), 127) == want


def test_flops_deepseek_v3():
    f = harness.load_module("flops", "deepseek_v3")
    params = (7168 * 1536 + 1536 * 128 * 192 + 7168 * 512 + 7168 * 64
              + 512 * 128 * 128 * 2 + 128 * 128 * 7168)
    attn = 2 * params + 2 * 128 * 192 * 65 + 2 * 128 * 128 * 65
    dense = 2 * 3 * 7168 * 18432
    moe = 2 * 7168 * 256 + 9 * 2 * 3 * 7168 * 2048
    want = 5 * attn + 3 * dense + 2 * moe + 2 * 7168 * 129280
    assert f.per_token(_spec("deepseek-v3-671b-5l"), 64) == want == 7_721_992_192


class _Ev:
    def __init__(self, kind, name, start, end, corr=0):
        self._k, self._n, self._s, self._e, self._c = kind, name, start, end, corr

    def activity_type(self):
        return self._k

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0


EVENTS = [
    _Ev("user_annotation", "portbench.sample", 0, 100),
    _Ev("cpu_op", "aten::topk", 10, 50),
    _Ev("cuda_runtime", "cudaLaunchKernel", 20, 22, 1),
    _Ev("kernel", "merge_kway_groups_kernel<int>", 200, 260, 1),
    _Ev("user_annotation", "portbench.decode", 100, 300),
    _Ev("cpu_op", "aten::mm", 120, 180),
    _Ev("cuda_runtime", "cudaLaunchKernel", 150, 152, 2),
    _Ev("kernel", "gemm", 300, 400, 2),
    _Ev("cuda_runtime", "cudaMemcpyAsync", 250, 251, 3),
    _Ev("gpu_memcpy", "Memcpy DtoH", 450, 460, 3),
    _Ev("gpu_user_annotation", "portbench.decode", 100, 500),
]


def test_device_busy_over_a_window():
    """Every kernel, copy and set counts once where they overlap; host
    events and the device's annotations do not count."""
    assert trace.device_busy_ns(EVENTS) == 170
    assert trace.device_busy_ns(EVENTS + [_Ev("kernel", "k", 350, 455)]) == 220
    assert trace.device_busy_ns(EVENTS[:3]) == 0


def test_slice_reduction():
    sl = trace.read(EVENTS, steps=2)
    assert [o.name for o in sl.kernels] == ["merge_kway_groups_kernel<int>", "gemm"]
    assert sl.busy_s == pytest.approx(170e-9)
    assert sl.span_s == pytest.approx(260e-9)
    assert [o.name for o in sl.in_span("sample")] == ["merge_kway_groups_kernel<int>"]
    assert dict(sl.idle_gaps) == pytest.approx({"decode:aten::mm": 40e-9,
                                                "decode:launch": 50e-9})
    assert sl.device_ops()[0] == ("gemm", pytest.approx(100e-9))
    assert trace.read([EVENTS[0], EVENTS[1]], steps=2) is None


def _view(**kw):
    base = dict(seconds=10.0, clients=32, vocab=50280, top_k=50,
                sampler="topk",
                peaks={"hbm_bytes_per_s": 3.35e12, "bf16_flop_per_s": 989e12},
                decode_ms=[2.0, 4.0], sample_ms=[3.0], fed_positions=[0, 1, 1],
                fed_rows=[32, 32, 10],
                flops_per_token=lambda pos: 1e9 * (pos + 1),
                slice=trace.read(EVENTS, steps=2))
    base.update(kw)
    return harness.View(**base)


def test_readers():
    rd = harness.readers()
    v = _view()
    assert rd["decode_ms"].read(v) == 3.0
    assert rd["sampler_ms"].read(v) == 3.0
    assert rd["kernels_per_step"].read(v) == 1.0
    assert rd["idle_share"].read(v) == pytest.approx(100 * (1 - 170 / 260))
    assert rd["step_mfu"].read(v) == pytest.approx(  # 10 rows need step 3
        100 * (32 * 1e9 + 32 * 2e9 + 10 * 2e9) / (10.0 * 989e12))
    least = 2 * 32 * (50280 * 4 + 50 * 8) / 3.35e12
    assert rd["sampler_roofline"].read(v) == pytest.approx(100 * least / 60e-9)


def test_host_readers_only_where_the_cell_leaves_them_out():
    """The host-bound rate and cadence are read per layer only in a cell
    whose end-to-end metrics do not carry them."""
    rd = harness.readers()
    gaps = [float(g) for g in range(1, 101)]
    device = ("device_ms_per_token", "setup_s")
    assert rd["host_decode_tok_s"].read(_view(tokens=500, gaps=gaps,
                                              end_to_end=device)) == 50.0
    assert rd["host_tpot_p95_ms"].read(_view(tokens=500, gaps=gaps,
                                             end_to_end=device)) == pytest.approx(95.05)
    for name in ("host_decode_tok_s", "host_tpot_p95_ms"):
        assert rd[name].read(_view(tokens=500, gaps=gaps)) is None


def test_readers_return_nothing_without_their_source():
    rd = harness.readers()
    empty = _view(decode_ms=[], sample_ms=[], fed_positions=[], fed_rows=[], slice=None,
                  peaks=None)
    for name, mod in rd.items():
        assert mod.read(empty) is None, name
    assert rd["sampler_roofline"].read(_view(sampler="greedy")) is None
    no_merge = trace.read([e for e in EVENTS if "merge" not in e.name()], 2)
    assert rd["sampler_roofline"].read(_view(slice=no_merge)) is None


class _OldEv(_Ev):
    """An event of a torch build without ``activity_type``."""

    activity_type = None

    def __getattribute__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return object.__getattribute__(self, name)

    def device_type(self):
        return ("DeviceType.CUDA" if self._k in ("kernel", "gpu_memcpy",
                                                 "gpu_user_annotation")
                else "DeviceType.CPU")

    def is_user_annotation(self):
        return self._k.endswith("user_annotation")


def test_slice_without_activity_type():
    old = [_OldEv(e._k, e._n, e._s, e._e, e._c) for e in EVENTS]
    assert not hasattr(old[0], "activity_type")
    new, got = trace.read(EVENTS, steps=2), trace.read(old, steps=2)
    assert got.ops == new.ops and got.idle_gaps == new.idle_gaps
