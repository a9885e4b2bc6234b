"""The trace reduction and each metric reader, on a canned profiler trace."""

from types import SimpleNamespace

import pytest

from h100bench import cells, devtrace

GROUPS = cells.kernel_groups()


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}


# A traced window of 100 us on the host's thread 1; the device (thread 9)
# runs a flash forward 10-30, a GEMM 20-40 overlapping it, an elementwise
# kernel 60-70, a memcpy 80-85, and a kernel outside the window.
EVENTS = [
    _x("user_annotation", devtrace.WINDOW, 0, 100),
    _x("cpu_op", "aten::mm", 5, 10),
    _x("cuda_runtime", "cudaGraphLaunch", 41, 4),
    _x("cpu_op", "aten::item", 45, 50),
    _x("cuda_runtime", "cudaStreamSynchronize", 46, 48),
    _x("cpu_op", "aten::add", 5, 10, tid=2),
    _x("kernel", "void flash_fwd_kernel<bf16, 64>(Params)", 10, 20, tid=9),
    _x("kernel", "nvjet_tst_256x128_64x4", 20, 20, tid=9),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4>", 60, 10, tid=9),
    _x("gpu_memcpy", "Memcpy DtoH", 80, 5, tid=9),
    _x("kernel", "void flash_bwd_dq_kernel<bf16>", 150, 30, tid=9),
    {"ph": "i", "cat": "instant", "name": "marker", "ts": 3, "pid": 7, "tid": 1},
]


@pytest.fixture
def tr():
    return devtrace.Trace.from_events(EVENTS)


def test_busy_is_the_union_not_the_sum(tr):
    # 10-40 (flash and GEMM overlap), 60-70, 80-85: 45 us of 100.
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(45e-6)
    assert tr.gaps() == [(0.0, 10.0), (40.0, 60.0), (70.0, 80.0), (85.0, 100.0)]


def test_groups_claim_kernels_in_order(tr):
    s = tr.group_seconds(GROUPS)
    assert s["flash"] == pytest.approx(20e-6)  # the backward lies outside the window
    assert s["matmul"] == pytest.approx(20e-6)
    assert s["other"] == pytest.approx(10e-6)
    assert devtrace.group_of("void int8_gemm_wgmma_kernel<...>", GROUPS) == "int8_linear"
    assert devtrace.group_of("cutlass_80_tensorop_gemm", GROUPS) == "matmul"
    assert devtrace.group_of("void norm_colsum_kernel", GROUPS) == "norm"


def test_gaps_are_named_by_the_innermost_host_op_of_the_window_thread(tr):
    assert tr.gap_owner((40.0, 60.0)) == "cudaStreamSynchronize"
    assert tr.gap_owner((0.0, 10.0)) == "aten::mm"
    assert tr.gap_owner((96.0, 100.0)) == "no host op"
    assert "aten::add" not in [name for name, _, _ in tr.host]  # another thread's
    b = tr.breakdown(GROUPS)
    assert b["device_ops"][0][0].startswith(("flash: ", "matmul: "))
    assert dict(b["idle_gaps"])["cudaStreamSynchronize"] == pytest.approx(45e-6)
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(55e-6)


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        devtrace.Trace.from_events(EVENTS[1:])


def _run(tr, **kw):
    dims = SimpleNamespace(layers=1, heads=1, head_size=4, n_params=110, n_embedding=10)
    runner = SimpleNamespace(B=1, T=3, flops_per_step=lambda: 100.0)
    base = dict(trace=tr, groups=GROUPS, peak={"bf16_flops": 1e9, "hbm_bytes_per_s": 1e8}, dims=dims, runner=runner,
                traced=1, window={"steps": 2, "elapsed_s": 1.0}, counters={}, spans={})
    base.update(kw)
    return SimpleNamespace(**base)


def test_trace_readers(tr):
    from h100bench import counts

    run = _run(tr)
    assert cells.metric_reader("device_idle_pct.train").read(run) == pytest.approx(55.0)
    assert cells.metric_reader("other_kernel_pct.score").read(run) == pytest.approx(100 * 10 / 50)
    bound = counts.attention_bound_s(run.dims, 1, 3, run.peak, backward=True)
    assert cells.metric_reader("flash_roofline.train").read(run) == pytest.approx(100 * bound / 20e-6)
    score = _run(tr, traced=[3, 2])
    bound = sum(counts.attention_bound_s(run.dims, 1, T, run.peak, backward=False) for T in (3, 2))
    assert cells.metric_reader("flash_roofline.score").read(score) == pytest.approx(100 * bound / 20e-6)


def test_readers_find_nothing_to_read_and_say_so():
    run = _run(None, peak=None)
    for name in ("device_idle_pct.train", "other_kernel_pct.train", "flash_roofline.train", "flash_roofline.score",
                 "mfu.train", "mfu.score", "compile_s", "build_s.train", "capture_s"):
        assert cells.metric_reader(name).read(run) is None, name
    empty = devtrace.Trace(window=(0.0, 100.0))
    assert cells.metric_reader("flash_roofline.train").read(_run(empty)) is None
    assert cells.metric_reader("other_kernel_pct.train").read(_run(empty)) is None


def test_host_readers():
    recs = [(3, 0.1, 20e-6, [1.0], 0), (2, 0.2, 40e-6, [1.0], 0), (3, 0.3, 30e-6, [1.0], 0)]
    run = _run(None, window={"steps": 4, "elapsed_s": 2.0, "records": recs},
               counters={"setup": {"thunder_tpu_compile_ms": {"count": 2, "sum": 2500.0}}, "window": {}},
               spans={"build_s": 1.5, "capture_s": 0.75})
    from h100bench import counts

    assert cells.metric_reader("mfu.train").read(run) == pytest.approx(100 * 100.0 * 4 / 2.0 / 1e9)
    flops = sum(counts.forward_flops(run.dims, 1, T) for T in (3, 2, 3))
    assert cells.metric_reader("mfu.score").read(run) == pytest.approx(100 * flops / 2.0 / 1e9)
    assert cells.metric_reader("dispatch_us.score").read(run) == pytest.approx(30.0)
    assert cells.metric_reader("compile_s").read(run) == 2.5
    assert cells.metric_reader("build_s.train").read(run) == 1.5
    assert cells.metric_reader("capture_s").read(run) == 0.75
