"""The observability layer (metrics, the event log and its replay, per-op
instrumentation, the monitor facade) through both packages, on the CPU.

The cases of ``tests/test_observability.py`` are written once over a
namespace ``P`` and run through the JAX package and the port, less
``test_lint_traces_cli`` (``scripts/`` belongs to the JAX package's tree).
For the same program the two write the same event kinds in the same order
with the same required fields, the same ``pass`` events (name, bound-symbol
count, trace), emit the same metric names, replay to the same findings, and
their NaN watch names the same symbol and line index.

Where they differ, by design, each case says so: the port's compile phases
are trace, transforms, claim, warmup (the entry's first call) and, on the
card, capture, where the JAX package has trace, transforms, claim,
static_analysis, codegen, staging, then xla_compile and its sub-spans and
hlo_audit after ``compile_end``; the port's executor is ``torch`` where the
JAX package's is ``jax``; an instrumented port entry is unstaged by
``StagingStats.reason``, where the JAX package drops ``jax.jit``.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import thunder_tpu as ttpu
import thunder_tpu.clang as jclang
import thunder_tpu.monitor as jmonitor
from thunder_tpu.analysis.events import replay_events as jreplay
from thunder_tpu.observability import events as jevents
from thunder_tpu.observability import instrument as jinstrument
from thunder_tpu.observability import metrics as jmetrics

import thunder_tpu_torch as tt
import thunder_tpu_torch.clang as tclang
import thunder_tpu_torch.monitor as tmonitor
from thunder_tpu_torch.analysis.events import replay_events as treplay
from thunder_tpu_torch.observability import events as tevents
from thunder_tpu_torch.observability import instrument as tinstrument
from thunder_tpu_torch.observability import metrics as tmetrics

JAX = SimpleNamespace(name="jax", pkg=ttpu, clang=jclang, monitor=jmonitor, events=jevents, metrics=jmetrics,
                      instrument=jinstrument, replay=jreplay, executor="jax",
                      jit=lambda f, **k: ttpu.jit(f, executors=["jax"], **k))
PORT = SimpleNamespace(name="port", pkg=tt, clang=tclang, monitor=tmonitor, events=tevents, metrics=tmetrics,
                       instrument=tinstrument, replay=treplay, executor="torch",
                       jit=lambda f, **k: tt.jit(f, executors=["torch"], device="cpu", **k))
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=lambda P: P.name)


@pytest.fixture(autouse=True)
def _metrics_isolation():
    """Each test starts with both packages' metrics off and zeroed, and
    leaves no global event log behind."""
    was = (jmonitor.enabled(), tmonitor.enabled())
    for m in (jmonitor, tmonitor):
        m.disable()
        m.reset()
    yield
    for m, on in zip((jmonitor, tmonitor), was):
        m.reset()
        (m.enable if on else m.disable)()
    jevents.set_global_path(None)
    tevents.set_global_path(None)


def _read_events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _runs(kinds):
    """The kinds with consecutive repeats collapsed."""
    return [k for i, k in enumerate(kinds) if i == 0 or kinds[i - 1] != k]


# =============================================================================
# Metrics registry
# =============================================================================


class TestMetricsRegistry:
    @BOTH
    def test_counter_disabled_is_noop(self, P):
        c = P.metrics.MetricsRegistry().counter("c_total", "help")
        c.inc()
        assert c.value() == 0

    @BOTH
    def test_counter_labels(self, P):
        P.monitor.enable()
        c = P.metrics.MetricsRegistry().counter("claims_total")
        c.inc(3, executor="jax")
        c.inc(1, executor="flash")
        c.inc(2, executor="jax")
        assert (c.value(executor="jax"), c.value(executor="flash"), c.value(executor="none")) == (5, 1, 0)

    @BOTH
    def test_gauge_set_max(self, P):
        P.monitor.enable()
        g = P.metrics.MetricsRegistry().gauge("hw_bytes")
        g.set_max(100)
        g.set_max(50)
        assert g.value() == 100
        g.set(10)
        assert g.value() == 10

    @BOTH
    def test_histogram_summary(self, P):
        P.monitor.enable()
        h = P.metrics.MetricsRegistry().histogram("lat_us")
        for v in (5.0, 50.0, 500.0):
            h.observe(v)
        s = h.summary()
        assert s["count"] == 3 and s["min"] == 5.0 and s["max"] == 500.0
        assert abs(s["mean"] - 185.0) < 1e-9
        by_le = dict(zip(h.buckets, s["bucket_counts"]))
        assert by_le[10.0] == 1 and by_le[100.0] == 2 and by_le[1e3] == 3

    @BOTH
    def test_kind_collision_raises(self, P):
        r = P.metrics.MetricsRegistry()
        r.counter("x")
        with pytest.raises(TypeError):
            r.gauge("x")

    @BOTH
    def test_report_and_prometheus(self, P):
        P.monitor.enable()
        r = P.metrics.MetricsRegistry()
        r.counter("a_total", "ha").inc(2)
        r.histogram("h_us").observe(7.0)
        rep = r.report()
        assert rep["a_total"]["kind"] == "counter" and rep["a_total"]["values"][""] == 2
        text = r.prometheus_text()
        assert "# TYPE a_total counter" in text and "a_total 2" in text
        assert 'h_us_bucket{le="10.0"} 1' in text and "h_us_count 1" in text

    @BOTH
    def test_reset_keeps_definitions(self, P):
        P.monitor.enable()
        r = P.metrics.MetricsRegistry()
        c = r.counter("n_total")
        c.inc(4)
        r.reset()
        assert c.value() == 0 and "n_total" in r.report()

    @BOTH
    def test_dump_json(self, P, tmp_path):
        P.monitor.enable()
        r = P.metrics.MetricsRegistry()
        r.counter("j_total").inc()
        p = tmp_path / "m.json"
        r.dump_json(str(p))
        assert json.loads(p.read_text())["metrics"]["j_total"]["values"][""] == 1

    @BOTH
    def test_jit_populates_framework_metrics(self, P):
        P.monitor.enable()
        jf = P.jit(lambda x: P.clang.sum(P.clang.tanh(x)))
        x = np.ones((4, 4), np.float32)
        jf(x)
        jf(x)
        m = P.metrics
        assert m.CACHE_MISSES.value() == 1
        assert m.CACHE_HITS.value(kind="fast") == 1
        assert m.COMPILES.value() >= 1
        assert m.CLAIMED_BSYMS.value(executor=P.executor) >= 2
        assert m.PASS_MS.summary(**{"pass": "Dead Code Elimination"})["count"] >= 1

    def test_port_metric_names_are_the_jax_packages(self):
        """Every series the port registers is one the JAX package registers,
        with the same kind, so scrapes of both join; for the same program
        (miss, fast hit, slow hit) the emitted names agree but for the XLA
        compile histogram, which the port has no counterpart of."""
        jrep, trep = jmetrics.REGISTRY.report(), tmetrics.REGISTRY.report()
        assert set(trep) <= set(jrep)
        assert all(trep[n]["kind"] == jrep[n]["kind"] for n in trep)

        def emitted(P):
            P.monitor.enable()
            jf = P.jit(lambda x: P.clang.sum(P.clang.tanh(x)))
            x = np.ones((4, 4), np.float32)
            jf(x)
            jf(x)
            P.pkg.compile_stats(jf).fast_cache.clear()
            jf(x)
            names = {k.split("{")[0] for k in P.monitor.report_compact()}
            P.monitor.disable()
            return names

        jnames, tnames = emitted(JAX), emitted(PORT)
        assert jnames - tnames == {"thunder_tpu_xla_compile_s"}
        assert tnames <= jnames
        assert {"thunder_tpu_cache_hits_total", "thunder_tpu_cache_misses_total", "thunder_tpu_compiles_total",
                "thunder_tpu_compile_ms", "thunder_tpu_pass_ms", "thunder_tpu_claimed_bsyms_total",
                "thunder_tpu_dispatch_us", "thunder_tpu_cache_lookup_us", "thunder_tpu_compile_phase_s"} <= tnames
        hits = {k: v for k, v in tmonitor.report_compact().items() if k.startswith("thunder_tpu_cache_hits_total")}
        assert hits == {'thunder_tpu_cache_hits_total{kind="fast"}': 1,
                        'thunder_tpu_cache_hits_total{kind="slow"}': 1}


# =============================================================================
# Event log: schema, kinds and order against the JAX package
# =============================================================================


class TestEventLog:
    def test_compile_event_schema_golden(self, tmp_path):
        """Every kind the port writes carries exactly the common envelope
        plus its schema fields; seq is the per-log line counter."""
        log = str(tmp_path / "ev.jsonl")
        jf = PORT.jit(lambda x: tclang.sum(tclang.mul(x, x)), events=log)
        jf(np.ones((2, 2), np.float32))
        recs = _read_events(log)
        kinds = [r["kind"] for r in recs]
        assert kinds[:2] == ["cache_miss", "compile_start"] and kinds[-1] == "compile_phase"
        assert kinds.index("compile_phase") < kinds.index("compile_end")
        envelope = {"v", "ts", "seq", "kind", "pid", "host"}
        golden = {
            "cache_miss": envelope | {"fn", "call"},
            "compile_start": envelope | {"compile_id", "fn", "cache_option", "call"},
            "pass": envelope | {"compile_id", "name", "ms", "n_bsyms", "trace"},
            "compile_end": envelope | {"compile_id", "fn", "ms", "n_bsyms", "claims", "collective_bytes",
                                       "symbolic", "recompile", "staged"},
            "compile_phase": envelope | {"compile_id", "phase", "s"},
        }
        for r in recs:
            assert set(r) == golden[r["kind"]], (r["kind"], sorted(set(r) ^ golden[r["kind"]]))
        assert all(r["v"] == 1 for r in recs)
        assert [r["seq"] for r in recs] == list(range(len(recs)))
        end = next(r for r in recs if r["kind"] == "compile_end")
        # On the CPU nothing stages; the port's claims are torch's.
        assert end["claims"].get("torch", 0) >= 1 and end["staged"] is False and end["symbolic"] is False
        phases = [r for r in recs if r["kind"] == "compile_phase"]
        assert [r["phase"] for r in phases] == ["trace", "transforms", "claim", "warmup"]
        assert {r["compile_id"] for r in phases} == {end["compile_id"]}

    @pytest.mark.parametrize("cache", ["constant values", "symbolic values"])
    def test_kinds_order_and_passes_match_the_jax_package(self, tmp_path, cache):
        """The same program through both packages: the same kinds in the
        same order (consecutive repeats collapsed: the port has fewer
        compile phases, listed in the module docstring), the same required
        fields, the same ``pass`` events, the same cache and bucket
        records."""
        opts = {} if cache == "constant values" else dict(cache=cache, symbolic_dims={0: (0,)})
        logs = {}
        for P in (JAX, PORT):
            logs[P.name] = log = str(tmp_path / f"{P.name}.jsonl")
            jf = P.jit(lambda x, P=P: P.clang.sum(P.clang.tanh(x)), events=log, **opts)
            jf(np.ones((3, 8), np.float32))
            jf(np.ones((3, 8), np.float32))
            jf(np.ones((5, 8), np.float32))
        j, t = _read_events(logs["jax"]), _read_events(logs["port"])
        assert _runs([r["kind"] for r in t]) == _runs([r["kind"] for r in j])
        # The JAX package's extra pass after claiming (the comm scheduler)
        # writes none on this program: the pass events are the same list.
        def passes(recs):  # compile ids are each package's own counter: numbered from 0 here
            ids = {}
            return [(ids.setdefault(r["compile_id"], len(ids)), r["name"], r["n_bsyms"], r["trace"], r["ms"] is None)
                    for r in recs if r["kind"] == "pass"]

        assert passes(t) == passes(j)
        for kind in ("cache_miss", "compile_start", "bucket_select"):
            strip = lambda r: {k: v for k, v in r.items() if k not in ("ts", "seq", "pid", "host", "compile_id")}  # noqa: E731
            assert [strip(r) for r in t if r["kind"] == kind] == [strip(r) for r in j if r["kind"] == kind]
        ends = lambda recs: [(r["symbolic"], r["recompile"], r["n_bsyms"]) for r in recs  # noqa: E731
                             if r["kind"] == "compile_end"]
        assert ends(t) == ends(j)
        schema = _schema()
        assert all(schema[r["kind"]] <= set(r) for r in j + t)

    @BOTH
    def test_bucket_select_and_recompile_events(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        jf = P.jit(lambda x: P.clang.sum(P.clang.tanh(x)), cache="symbolic values", symbolic_dims={0: (0,)},
                   events=log)
        jf(np.ones((2, 8), np.float32))
        jf(np.ones((3, 8), np.float32))  # the next pow2 bucket: a second compile
        recs = _read_events(log)
        buckets = [r for r in recs if r["kind"] == "bucket_select"]
        assert len(buckets) == 2 and "leaf0.dim0" in buckets[0]["buckets"]
        ends = [r for r in recs if r["kind"] == "compile_end"]
        assert [e["recompile"] for e in ends] == [False, True] and all(e["symbolic"] for e in ends)

    @BOTH
    def test_global_env_log(self, P, tmp_path):
        log = str(tmp_path / "glob.jsonl")
        P.events.set_global_path(log)
        try:
            P.jit(lambda x: P.clang.abs(x))(np.ones((2,), np.float32))
        finally:
            P.events.set_global_path(None)
        assert {"compile_start", "pass", "compile_end"} <= {r["kind"] for r in _read_events(log)}

    @BOTH
    def test_sharp_edge_event(self, P, tmp_path):
        log = str(tmp_path / "se.jsonl")
        P.events.set_global_path(log)
        try:
            P.jit(lambda x, o: P.clang.tanh(x))(np.ones((2, 2), np.float32), object())
        finally:
            P.events.set_global_path(None)
        edges = [r for r in _read_events(log) if r["kind"] == "sharp_edge"]
        assert edges and "cannot be guarded" in edges[0]["message"] and edges[0]["policy"] == "allow"

    @BOTH
    def test_no_log_is_silent(self, P):
        assert P.events.active_log() is None or os.environ.get("THUNDER_TPU_EVENTS")

    @BOTH
    def test_every_event_carries_pid_and_host(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        P.jit(lambda x: P.clang.sum(P.clang.tanh(x)), events=log)(np.ones((2, 4), np.float32))
        recs = _read_events(log)
        assert recs and all(r["pid"] == os.getpid() and r["host"] == 0 for r in recs)

    def test_module_frontend_compile_and_cache_events(self, tmp_path):
        """``jit(module, events=...)``: a miss, the compile bracket (the
        forward's claimed trace in ``compile_end``), then hits counted by
        kind="module" (thunder_tpu/frontend/module.py:494-560, :1238-1251)."""
        log = str(tmp_path / "m.jsonl")
        tmonitor.enable()
        tm = tt.jit(torch.nn.Linear(4, 4), device="cpu", events=log)
        x = torch.ones(2, 4)
        tm(x)
        tm(x)
        recs = _read_events(log)
        kinds = _runs([r["kind"] for r in recs])
        assert kinds == ["cache_miss", "compile_start", "pass", "compile_end"]
        start = next(r for r in recs if r["kind"] == "compile_start")
        end = next(r for r in recs if r["kind"] == "compile_end")
        assert start["fn"] == end["fn"] == "Linear" and start["cache_option"] == "module"
        assert end["compile_id"] == start["compile_id"] and end["recompile"] is False
        assert tmetrics.CACHE_HITS.value(kind="module") == 1 and tmetrics.CACHE_MISSES.value() == 1
        assert tmetrics.COMPILES.value() == 1


def _schema():
    from thunder_tpu_torch.analysis.events import SCHEMA

    return SCHEMA


# =============================================================================
# Instrumentation transform
# =============================================================================


def _tiny_gpt(P, planted: bool = False):
    """gpt-tiny in f32 through package P, the weights drawn by the JAX
    package and shared as numpy; ``planted``: a NaN in block 0's qkv
    weight."""
    from thunder_tpu.core import dtypes as jdtypes
    from thunder_tpu.models import gpt as jgpt

    import jax

    cfg = jgpt.name_to_config("gpt-tiny")
    params = jax.tree_util.tree_map(np.array, jgpt.init_params(cfg, dtype=jdtypes.float32, seed=0))
    if planted:
        params["blocks"][0]["attn"]["qkv_w"][0, 0] = np.nan
    idx = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    if P is JAX:
        return (lambda p, i: jgpt.forward(p, i, cfg)), params, idx
    from thunder_tpu_torch.models import gpt as tgpt

    tcfg = tgpt.name_to_config("gpt-tiny")
    return (lambda p, i: tgpt.forward(p, i, tcfg)), tgpt.params_from_jax(params, device="cpu"), idx


class TestInstrumentation:
    def test_nan_watch_gpt_block_attribution_matches(self):
        """The seeded-NaN GPT block: both packages raise NaNWatchError at the
        same bound symbol and line index, with its generated line and the
        pass that produced the executed trace."""
        errs = {}
        for P in (JAX, PORT):
            fwd, params, idx = _tiny_gpt(P, planted=True)
            with pytest.raises(P.instrument.NaNWatchError) as ei:
                P.jit(fwd, debug_watch="nan")(params, idx)
            errs[P.name] = ei.value
        j, t = errs["jax"], errs["port"]
        assert (t.sym_name, t.bsym_index, t.kind, t.provenance) == (j.sym_name, j.bsym_index, j.kind, j.provenance)
        assert t.trace_line and "=" in t.trace_line and "NaN" in str(t)

    @BOTH
    def test_nan_watch_clean_run_no_trip(self, P):
        fwd, params, idx = _tiny_gpt(P)
        out = P.jit(fwd, debug_watch="nan")(params, idx)
        assert np.isfinite(np.asarray(out)).all()

    def test_inf_watch_matches(self):
        errs = {}
        for P in (JAX, PORT):
            jf = P.jit(lambda x, P=P: P.clang.true_divide(P.clang.abs(x), P.clang.sub(x, x)), debug_watch="inf")
            with pytest.raises(P.instrument.NaNWatchError) as ei:
                jf(np.full((2, 2), 3.0, np.float32))
            errs[P.name] = ei.value
        assert errs["port"].kind == errs["jax"].kind == "Inf"
        assert (errs["port"].sym_name, errs["port"].bsym_index) == (errs["jax"].sym_name, errs["jax"].bsym_index)

    def test_noop_when_disabled(self):
        """No option: no instrumentation symbol in the final trace and no
        hooks; the entry's staging reason is the CPU's, not the hooks'."""
        jf = PORT.jit(lambda x: tclang.sum(tclang.tanh(x)))
        jf(np.ones((2, 2), np.float32))
        assert not any("instrument" in b.sym.name for b in tt.last_traces(jf)[-1].bound_symbols)
        assert tt.compile_data(jf).instrument_hooks == ()
        assert "cpu" in tt.last_staging(jf).reason

    def test_instrumented_entry_is_unstaged_by_reason(self):
        jf = PORT.jit(lambda x: tclang.sum(tclang.tanh(x)), instrument="time")
        jf(np.ones((2, 2), np.float32))
        assert "debug_watch" in tt.last_staging(jf).reason

    @BOTH
    def test_instrumented_matches_staged_result(self, P):
        f = lambda x: P.clang.sum(P.clang.mul(P.clang.tanh(x), x))  # noqa: E731
        x = np.random.RandomState(0).randn(8, 8).astype(np.float32)
        np.testing.assert_allclose(np.asarray(P.jit(f)(x)), np.asarray(P.jit(f, instrument=P.instrument.OpTimer())(x)),
                                   rtol=1e-6)

    @BOTH
    def test_op_timer_report(self, P):
        jf = P.jit(lambda x: P.clang.sum(P.clang.tanh(x)), instrument=P.instrument.OpTimer())
        jf(np.ones((16, 16), np.float32))
        jf(np.ones((16, 16), np.float32))
        rep = P.instrument.instrument_reports(jf)
        assert rep and rep[0]["hook"] == "OpTimer"
        ops = {o["symbol"]: o for o in rep[0]["ops"]}
        assert ops["tanh"]["calls"] == 2 and ops["sum"]["calls"] == 2 and rep[0]["total_s"] > 0

    def test_op_timer_sleep_stops_at_its_cap(self, monkeypatch):
        """On the card an op that synchronizes inside (a host read) outruns
        every sleep: the sleep doubles up to ``OpTimer.MAX_SLEEP_S`` and no
        further, and each such op counts a host gap. The card's events are
        stood in for by ones that have completed when the op ends."""
        from thunder_tpu_torch.observability.instrument import OpRecord, OpTimer

        class Event:
            def __init__(self, enable_timing=False):
                pass

            def record(self):
                pass

            def query(self):
                return True

            def synchronize(self):
                pass

            def elapsed_time(self, other):
                return 1.0

        slept = []
        monkeypatch.setattr(torch.cuda, "_sleep", slept.append)
        monkeypatch.setattr(torch.cuda, "Event", Event)
        timer = OpTimer()
        rec = OpRecord(0, "item", None, "t0 = item(x)", None, "computation", device="cuda")
        for _ in range(40):
            timer.on_op_start(rec)
            timer.on_op_end(rec, ())
        assert slept[:2] == [int(2e-4 * 2e9), int(4e-4 * 2e9)]
        assert max(slept) == slept[-1] == int(OpTimer.MAX_SLEEP_S * 2e9)
        assert timer.host_gaps == 40 and timer.report()["ops"][0]["calls"] == 40

    @BOTH
    def test_instrument_shorthand_persists_across_entries(self, P):
        jf = P.jit(lambda x: P.clang.sum(P.clang.tanh(x)), instrument="time")
        jf(np.ones((4, 4), np.float32))
        jf(np.ones((8, 8), np.float32))
        assert P.pkg.cache_misses(jf) == 2
        rep = P.instrument.instrument_reports(jf)
        assert len(rep) == 1 and {o["symbol"]: o for o in rep[0]["ops"]}["tanh"]["calls"] == 2

    @BOTH
    def test_custom_callback_hook(self, P):
        seen = []
        P.jit(lambda x: P.clang.tanh(x), instrument=lambda rec, outs: seen.append((rec.sym_name, len(outs))))(
            np.ones((2, 2), np.float32))
        assert ("tanh", 1) in seen

    @BOTH
    def test_memory_high_water_hook(self, P):
        h = P.instrument.MemoryHighWater()
        jf = P.jit(lambda x: P.clang.sum(P.clang.mul(x, x)), instrument=h)
        jf(np.ones((32, 32), np.float32))
        rep = P.instrument.instrument_reports(jf)[0]
        assert rep["peak_bytes"] > 0 and rep["peak_op"]

    def test_memory_high_water_estimate_matches(self):
        """Off the card both packages estimate from the outputs' bytes: the
        same peak and op for the same program."""
        reps = []
        for P in (JAX, PORT):
            h = P.instrument.MemoryHighWater()
            P.jit(lambda x, P=P: P.clang.sum(P.clang.mul(x, x)), instrument=h)(np.ones((32, 32), np.float32))
            reps.append((h.peak_bytes, h.peak_op, h.exact))
        assert reps[1] == (32 * 32 * 4 + 4, "sum", False)
        if not reps[0][2]:  # the JAX package reads the device's own counter where it has one
            assert reps[0][:2] == reps[1][:2]

    @BOTH
    def test_watch_events_logged_with_warn_action(self, P, tmp_path):
        log = str(tmp_path / "w.jsonl")
        P.events.set_global_path(log)
        try:
            watcher = P.instrument.NaNWatcher(mode="nan", action="warn")
            jf = P.jit(lambda x: P.clang.true_divide(x, x), instrument=watcher)
            with pytest.warns(RuntimeWarning):
                jf(np.zeros((2, 2), np.float32))
        finally:
            P.events.set_global_path(None)
        assert watcher.trips and watcher.trips[0]["kind"] == "NaN"
        trips = [r for r in _read_events(log) if r["kind"] == "nan_watch"]
        assert trips and trips[0]["symbol"] == watcher.trips[0]["symbol"]

    @BOTH
    def test_module_frontend_rejects_debug_watch(self, P):
        kw = {"device": "cpu"} if P is PORT else {}
        with pytest.raises(NotImplementedError):
            P.pkg.jit(torch.nn.Linear(4, 4), debug_watch="nan", **kw)
        with pytest.raises(NotImplementedError):
            P.pkg.jit(torch.nn.Linear(4, 4), instrument="time", **kw)


# =============================================================================
# Dispatch metrics: padding waste, and the hit path's one flag check
# =============================================================================


class TestDispatchMetrics:
    @BOTH
    def test_waste_counted(self, P):
        P.monitor.enable()
        jf = P.jit(lambda x: P.clang.sum(P.clang.tanh(x)), cache="symbolic values", symbolic_dims={0: (0,)},
                   buckets={"batch": "pow2"})
        jf(np.ones((4, 8), np.float32))  # at the bucket ceiling: no waste
        before = P.metrics.PADDING_WASTE_ELEMENTS.value()
        jf(np.ones((3, 8), np.float32))  # padded 3 -> 4: one row of 8 wasted
        assert P.metrics.PADDING_WASTE_ELEMENTS.value() - before == 8
        assert P.metrics.BUCKET_COMPILES.value() >= 1

    @pytest.mark.parametrize("cache", ["constant values", "same input", "symbolic values"])
    def test_hit_path_does_one_flag_check(self, monkeypatch, tmp_path, cache):
        """With metrics and events off, a cache hit calls ``enabled()`` once
        and touches no event sink; with a per-function log it emits nothing
        on a hit either (the JAX package's hit path writes no event)."""
        import thunder_tpu_torch.api as tapi

        calls = {"enabled": 0, "active_log": 0, "emit": 0}
        real_enabled, real_active, real_emit = tmetrics.enabled, tevents.active_log, tevents.emit_event

        def count(name, fn):
            def wrapped(*a, **k):
                calls[name] += 1
                return fn(*a, **k)
            return wrapped

        opts = {"symbolic_dims": {0: (0,)}} if cache == "symbolic values" else {}
        for log in (None, str(tmp_path / "ev.jsonl")):
            jf = PORT.jit(lambda x: tclang.sum(tclang.tanh(x)), cache=cache, events=log, **opts)
            x = np.ones((3, 8), np.float32)
            jf(x)
            assert tapi.obsm is tmetrics
            monkeypatch.setattr(tmetrics, "enabled", count("enabled", real_enabled))
            monkeypatch.setattr(tevents, "active_log", count("active_log", real_active))
            monkeypatch.setattr(tevents, "emit_event", count("emit", real_emit))
            for k in calls:
                calls[k] = 0
            for _ in range(5):
                jf(x)
            assert calls == {"enabled": 5, "active_log": 0, "emit": 0}, (log, calls)
            assert tt.cache_hits(jf) == 5
            monkeypatch.undo()


# =============================================================================
# Profiler bracketing and annotated codegen
# =============================================================================


class TestProfile:
    def test_profile_smoke(self, tmp_path):
        jf = PORT.jit(lambda x: tclang.sum(tclang.mul(x, x)))
        x = np.ones((8, 8), np.float32)
        res = tt.profile(jf, x, trace_dir=str(tmp_path / "prof"), steps=2, warmup=1)
        assert set(res) == {"trace_dir", "steps", "avg_s", "total_s", "profiler", "attribution"}
        assert res["steps"] == 2 and res["avg_s"] > 0 and res["profiler"] is True
        assert any(n.endswith(".trace.json") for n in os.listdir(res["trace_dir"]))

    @BOTH
    def test_profile_emits_events(self, P, tmp_path):
        log = str(tmp_path / "p.jsonl")
        P.events.set_global_path(log)
        try:
            P.pkg.profile(P.jit(lambda x: P.clang.abs(x)), np.ones((2,), np.float32),
                          trace_dir=str(tmp_path / "prof"), steps=1, warmup=0)
        finally:
            P.events.set_global_path(None)
        recs = [r for r in _read_events(log) if r["kind"].startswith("profile_")]
        assert [r["kind"] for r in recs] == ["profile_start", "profile_stop"]
        assert _schema()["profile_stop"] <= set(recs[1])

    def test_profile_counts_captures(self, tmp_path):
        tt.profile(lambda x: x + 1, torch.ones(2), trace_dir=str(tmp_path / "p"), steps=1, warmup=0)
        assert tmetrics.PROFILE_CAPTURES.value(ok="true") == 1


class TestAnnotatedCodegen:
    @BOTH
    def test_annotate_carries_line_and_pass(self, P):
        jf = P.jit(lambda x: P.clang.sum(P.clang.tanh(x)))
        jf(np.ones((2, 2), np.float32))
        src = P.pkg.last_traces(jf)[-1].python(annotate=True)
        assert "__annotate_scope('L0.tanh#Delete_Last_Used')" in src
        assert "L2.sum#Delete_Last_Used" in src

    @pytest.mark.parametrize("var", ["THUNDER_ANNOTATE_TRACES", "THUNDER_TPU_ANNOTATE_TRACES"])
    def test_both_spellings_annotate(self, monkeypatch, var):
        monkeypatch.setenv(var, "1")
        jf = PORT.jit(lambda x: tclang.sum(tclang.tanh(x)))
        jf(np.ones((2, 2), np.float32))
        fn = tt.compile_stats(jf).cache_entries[-1].computation_fn
        assert "__annotate_scope" in fn.__code__.co_names or "__annotate_scope" in fn.__globals__

    def test_split_step_traces_keep_their_lines_apart(self):
        """A split step's forward and backward tag their scopes with the
        trace's name, so that line L3 of one is not line L3 of the other."""
        from thunder_tpu_torch.benchmarks.train import build_train
        from thunder_tpu_torch.models import gpt

        tr = build_train(gpt.name_to_config("llama-tiny"), 1, 8, device="cpu")
        assert tr.fw_trace._annotate_tag() == "augmented_forward_Delete_Last_Used"
        assert tr.bw_trace._annotate_tag() == "backward_Delete_Last_Used"
        assert tr.sgd_scope is None


# =============================================================================
# Event replay
# =============================================================================


class TestEventReplay:
    @BOTH
    def test_roundtrip_clean(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")

        def f(x):
            return P.clang.sum(P.clang.tanh(x))

        P.jit(f, events=log)(np.ones((2, 4), np.float32))
        summary, diags = P.replay(log)
        assert not diags
        assert summary["kinds"]["compile_start"] == 1 and summary["compiles_by_fn"] == {"f": 1}
        assert summary["pass_ms_total"].get("Transform for execution", 0) > 0

    @BOTH
    def test_recompile_storm_flagged(self, P, tmp_path):
        log = str(tmp_path / "storm.jsonl")
        jf = P.jit(lambda x: P.clang.sum(P.clang.tanh(x)), events=log)
        for n in range(2, 9):  # 7 distinct exact shapes -> 7 compiles
            jf(np.ones((n, 4), np.float32))
        _, diags = P.replay(log, storm_threshold=4)
        storms = [d for d in diags if d.rule == "events.recompile-storm"]
        assert storms and storms[0].severity.name == "ERROR" and "7 times" in storms[0].message

    @BOTH
    def test_healthy_bucket_sweep_not_flagged_as_storm(self, P, tmp_path):
        log = str(tmp_path / "buckets.jsonl")
        jf = P.jit(lambda x: P.clang.sum(P.clang.tanh(x)), cache="symbolic values", symbolic_dims={0: (0,)},
                   buckets={"batch": "pow2"}, events=log)
        for b in (1, 2, 3, 5, 9, 17, 33):
            jf(np.ones((b, 4), np.float32))
        summary, diags = P.replay(log, storm_threshold=4)
        assert summary["kinds"]["compile_end"] == 7
        assert not [d for d in diags if d.rule == "events.recompile-storm"]

    @BOTH
    def test_schema_violations_flagged(self, P, tmp_path):
        p = tmp_path / "bad.jsonl"
        p.write_text(
            "not json at all\n"
            '{"v": 1, "ts": 0, "seq": 0, "kind": "pass"}\n'
            '{"v": 99, "ts": 0, "seq": 1, "kind": "compile_start"}\n'
            '{"v": 1, "ts": 0, "seq": 2, "kind": "mystery"}\n'
        )
        _, diags = P.replay(str(p))
        assert sorted(d.rule for d in diags) == ["events.malformed-line", "events.missing-fields",
                                                 "events.schema-version", "events.unknown-kind"]
        by_rule = {d.rule: d for d in diags}
        assert by_rule["events.unknown-kind"].severity.name == "WARNING"
        assert by_rule["events.missing-fields"].severity.name == "ERROR"

    @pytest.mark.parametrize("case", ["clean", "storm", "buckets", "unclosed"])
    def test_replays_give_the_same_findings(self, tmp_path, case):
        """Each package's log replayed by both replays: the same findings
        (rule, severity, message) and compile counts."""
        logs = []
        for P in (JAX, PORT):
            log = str(tmp_path / f"{P.name}.jsonl")
            opts = dict(cache="symbolic values", symbolic_dims={0: (0,)}) if case == "buckets" else {}
            jf = P.jit(lambda x, P=P: P.clang.sum(P.clang.tanh(x)), events=log, **opts)
            shapes = {"clean": (2,), "storm": range(2, 9), "buckets": (3, 3, 3), "unclosed": (2,)}[case]
            for n in shapes:
                if case == "buckets":
                    P.pkg.compile_stats(jf).cache_entries.clear()  # the same bucket compiled again
                    P.pkg.compile_stats(jf).fast_cache.clear()
                jf(np.ones((n, 4), np.float32))
            if case == "unclosed":
                with open(log, "a") as f:
                    f.write(json.dumps({"v": 1, "ts": 0.0, "seq": 99, "kind": "compile_start", "pid": 1, "host": 0,
                                        "compile_id": 77, "fn": "g", "cache_option": "constant_values",
                                        "call": 1}) + "\n")
            logs.append(log)
        found = []
        for log in logs:
            for replay in (jreplay, treplay):
                summary, diags = replay(log, storm_threshold=4)
                found.append(([(d.rule, d.severity.name, d.message) for d in diags], summary["compiles_by_fn"]))
        assert all(f == found[0] for f in found), found
        if case != "clean":
            assert found[0][0]

    def test_merged_replay_stable_order_and_scoped_cids(self, tmp_path):
        from thunder_tpu_torch.analysis.events import merge_event_logs

        log0 = str(tmp_path / "h0.jsonl")
        PORT.jit(lambda x: tclang.sum(tclang.tanh(x)), events=log0)(np.ones((2, 4), np.float32))
        recs = _read_events(log0)
        log1 = str(tmp_path / "h1.jsonl")
        with open(log1, "w") as f:
            for r in recs:
                f.write(json.dumps(dict(r, host=1)) + "\n")
        merged, diags = merge_event_logs([log1, log0])
        assert not diags and len(merged) == 2 * len(recs)
        keys = [(r["ts"], r["host"], r["pid"], r["seq"]) for r in merged]
        assert keys == sorted(keys) and merge_event_logs([log0, log1])[0] == merged
        summary, rdiags = treplay([log0, log1])
        assert not rdiags and summary["lines"] == 2 * len(recs)
        assert any(k.startswith("h0:") for k in summary["compiles_by_fn"])
        assert any(k.startswith("h1:") for k in summary["compiles_by_fn"])

    def test_host_health_matches(self, tmp_path):
        """Per-host step times over merged logs: the same summary and
        straggler finding from both packages' ``host_health``."""
        from thunder_tpu.analysis.events import host_health as jhh
        from thunder_tpu_torch.analysis.events import host_health as thh

        recs = [{"v": 1, "ts": float(i), "seq": i, "kind": "step_time", "pid": 1, "host": h, "fn": "step",
                 "step": i, "s": 0.1 if h < 2 else 0.4} for i in range(6) for h in range(3)]
        got = [hh(recs) for hh in (jhh, thh)]
        assert got[0][0] == got[1][0] and got[1][0]["stragglers"] == [2]
        assert [d.rule for d in got[0][1]] == [d.rule for d in got[1][1]] == ["events.straggler-suspect"]


# =============================================================================
# monitor facade and examine
# =============================================================================


class TestMonitor:
    @BOTH
    def test_enable_report_reset(self, P):
        P.monitor.enable()
        P.metrics.CACHE_MISSES.inc()
        assert P.monitor.report()["thunder_tpu_cache_misses_total"]["values"][""] == 1
        assert "thunder_tpu_cache_misses_total 1" in P.monitor.prometheus_text()
        P.monitor.reset()
        assert P.monitor.report()["thunder_tpu_cache_misses_total"]["values"] == {}

    @BOTH
    def test_dump_json(self, P, tmp_path):
        P.monitor.enable()
        P.metrics.COMPILES.inc(2)
        p = tmp_path / "snap.json"
        P.monitor.dump_json(str(p))
        assert json.loads(p.read_text())["metrics"]["thunder_tpu_compiles_total"]["values"][""] == 2

    @BOTH
    def test_host_labels_and_event_log_setter(self, P, tmp_path):
        P.monitor.enable()
        P.metrics.COMPILES.inc()
        assert f'pid="{os.getpid()}"' in P.monitor.prometheus_text(include_host=True)
        assert P.monitor.report(include_host=True)["host_identity"]["host"] == "0"
        log = str(tmp_path / "g.jsonl")
        P.monitor.set_event_log(log)
        try:
            P.jit(lambda x: P.clang.abs(x))(np.ones((2,), np.float32))
        finally:
            P.monitor.set_event_log(None)
        assert _read_events(log)

    def test_always_export_counters_on_the_wire(self):
        text = tmonitor.prometheus_text()
        for name in ("thunder_tpu_event_log_dropped_total", "thunder_tpu_profile_captures_total",
                     "thunder_tpu_roofline_probes_total"):
            assert f"{name} 0" in text

    def test_format_metrics_report_matches(self, capsys):
        """``examine.format_metrics_report`` and ``lint``'s summary line up
        with the JAX package's for the same program."""
        import thunder_tpu.examine as jexamine
        import thunder_tpu_torch.examine as texamine

        assert jexamine.format_metrics_report() == texamine.format_metrics_report() == \
            "metrics: enabled, no samples yet"
        outs = []
        for P, ex in ((JAX, jexamine), (PORT, texamine)):
            P.monitor.enable()
            jf = P.jit(lambda x, P=P: P.clang.sum(P.clang.tanh(x)))
            x = np.ones((4, 4), np.float32)
            jf(x)
            jf(x)
            text = ex.format_metrics_report()
            outs.append({line.split(":")[0].strip() for line in text.splitlines()[1:]})
            ex.lint(jf, x)
            assert "metrics (process-wide" in capsys.readouterr().out
            P.monitor.disable()
        shared = {"thunder_tpu_cache_misses_total", 'thunder_tpu_cache_hits_total{kind="fast"}',
                  "thunder_tpu_compiles_total"}
        assert shared <= outs[0] and shared <= outs[1]
