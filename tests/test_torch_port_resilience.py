"""The recovery layer through both packages, on the CPU.

The cases of ``tests/test_resilience.py``, written once over a namespace
``P`` and run through the JAX package and the port
(``thunder_tpu_torch/resilience``), less ``TestJaxexDonationSatellite`` (the
JAX executor's donation probe: the port donates nothing, so it has no seat):
the chaos spec grammar, executor demotion, the de-opt ladder, the NaN guard,
the straggler seam, the checkpoint manager, preemption and resume, the
replay's fault correlation, the event-log drop counter and the quarantine
metrics. Where the two differ, by design: the JAX package's terminal
executor is ``jax``, the port's ``torch``; the port's injected OOM carries
the CUDA allocator's message where the JAX package's carries XLA's
``RESOURCE_EXHAUSTED``.

The port's compile cache is its kernel build directory
(``executors/_build.py``), so the compile-cache cases sweep a build
directory, and of the JAX package's ``TestPersistentCacheConfig``
(``tests/test_symbolic_cache.py``) only the logged-once case has a seat.
The two ``sched_bad``/ladder cases of ``tests/test_comm_schedule.py`` run
here on the port's scheduler.

Across the packages, on the same inputs made from a numpy seed:
- chaos firing sequences are equal, draw for draw, over 1000 seeded draws;
- the de-opt ladder's levels and ``skipped_levels`` are equal for the same
  gpt-tiny program and the same ``THUNDER_TPU_HBM_BYTES``;
- the NaN guard's re-run names the same symbol;
- a demoted gpt-tiny step's loss equals the torch executor's, bit for bit,
  and is within 1e-5 of the JAX package's in float32 (the fused executor
  demoted) and within 1e-4 in bfloat16 (the flash executor, which claims
  only half precision, demoted; the two packages' bf16 losses differ by
  4e-5 here, rounding of bf16 intermediates);
- a preempted and resumed gpt-tiny SGD run in float32 gives the losses of
  the uninterrupted run bit for bit, and within 1e-5 of the JAX package's;
- an event log of the same chaos run replays to the same findings through
  either package's replay.
"""

import dataclasses
import json
import os
import signal
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import thunder_tpu as ttpu
import thunder_tpu.monitor as jmonitor
from thunder_tpu.analysis import Severity
from thunder_tpu.analysis.events import replay_events as jreplay
from thunder_tpu.core.prims import PrimIDs as JPrimIDs
from thunder_tpu.extend import OperatorExecutor as JOperatorExecutor
from thunder_tpu.extend import get_executor as jget_executor
from thunder_tpu.extend import register_executor as jregister_executor
from thunder_tpu.observability import events as jevents
from thunder_tpu.observability import metrics as jmetrics
from thunder_tpu.resilience import chaos as jchaos
from thunder_tpu.resilience import deopt as jdeopt
from thunder_tpu.resilience import demotion as jdemotion
from thunder_tpu.resilience import preemption as jpreemption

import thunder_tpu_torch as tt
import thunder_tpu_torch.monitor as tmonitor
from thunder_tpu_torch.analysis.events import replay_events as treplay
from thunder_tpu_torch.core.prims import PrimIDs as TPrimIDs
from thunder_tpu_torch.extend import OperatorExecutor as TOperatorExecutor
from thunder_tpu_torch.extend import get_executor as tget_executor
from thunder_tpu_torch.extend import register_executor as tregister_executor
from thunder_tpu_torch.observability import events as tevents
from thunder_tpu_torch.observability import metrics as tmetrics
from thunder_tpu_torch.resilience import chaos as tchaos
from thunder_tpu_torch.resilience import deopt as tdeopt
from thunder_tpu_torch.resilience import demotion as tdemotion
from thunder_tpu_torch.resilience import preemption as tpreemption

X = np.random.RandomState(0).randn(4, 4).astype(np.float32)


def _jax_arange(n):
    import jax.numpy as jnp

    return jnp.arange(n, dtype=jnp.float32)


def _jax_sum_sq(p):
    import jax.numpy as jnp

    return float(jnp.sum(p * p))


JAX = SimpleNamespace(
    name="jax", pkg=ttpu, monitor=jmonitor, replay=jreplay, events=jevents, metrics=jmetrics, chaos=jchaos,
    deopt=jdeopt, demotion=jdemotion, preemption=jpreemption, terminal="jax", PrimIDs=JPrimIDs,
    OperatorExecutor=JOperatorExecutor, get_executor=jget_executor, register_executor=jregister_executor,
    jit=lambda f, **k: ttpu.jit(f, **k), arange=_jax_arange, sum_sq=_jax_sum_sq,
    input=lambda x: x, asarray=np.asarray)
PORT = SimpleNamespace(
    name="port", pkg=tt, monitor=tmonitor, replay=treplay, events=tevents, metrics=tmetrics, chaos=tchaos,
    deopt=tdeopt, demotion=tdemotion, preemption=tpreemption, terminal="torch", PrimIDs=TPrimIDs,
    OperatorExecutor=TOperatorExecutor, get_executor=tget_executor, register_executor=tregister_executor,
    jit=lambda f, **k: tt.jit(f, device="cpu", **k), arange=lambda n: torch.arange(n, dtype=torch.float32),
    sum_sq=lambda p: float(torch.sum(p * p)), input=torch.from_numpy, asarray=lambda x: np.asarray(x.detach()))
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=lambda P: P.name)


@pytest.fixture(autouse=True)
def _resilience_isolation(monkeypatch):
    """Zero backoff, no ambient chaos, empty quarantine, metrics reset, in
    both packages."""
    monkeypatch.setenv("THUNDER_TPU_RETRY_BACKOFF_S", "0")
    monkeypatch.delenv("THUNDER_TPU_CHAOS", raising=False)
    was = (jmonitor.enabled(), tmonitor.enabled())
    for P in (JAX, PORT):
        P.chaos.reset_env_config()
        P.demotion.clear_quarantine()
        P.monitor.disable()
        P.monitor.reset()
    yield
    for P, on in zip((JAX, PORT), was):
        P.monitor.reset()
        (P.monitor.enable if on else P.monitor.disable)()
        P.demotion.clear_quarantine()
        P.chaos.reset_env_config()


def _events(path):
    return [json.loads(line) for line in open(path)]


def _kinds(path):
    return [r["kind"] for r in _events(path)]


def _toy_executor(P):
    """A chaos-armed executor claiming the tanh prim, registered once. Its
    impl delegates to the terminal executor's, so an un-demoted claim stays
    bitwise-identical to the baseline. Named apart from
    ``tests/test_resilience.py``'s ``toyex``: the two files may share a
    process, and with it the JAX package's executor registry."""
    ex = P.get_executor("mirror_toyex")
    if ex is not None:
        return ex
    ex = P.OperatorExecutor("mirror_toyex")
    P.register_executor(ex)
    base = P.get_executor(P.terminal).get_impl(P.PrimIDs.TANH)
    chaos = P.chaos

    def _toy_tanh(a, _base=base):
        chaos.kernel_seam("mirror_toyex", "tanh")
        return _base(a)

    ex.register_implementation(P.PrimIDs.TANH, fn=_toy_tanh)
    return ex


def _fn(a):
    return (a.tanh() * 2.0 + 1.0).sum()


def _baseline(P):
    return P.asarray(P.jit(_fn, executors=[P.terminal])(P.input(X)))


# =============================================================================
# Chaos spec grammar
# =============================================================================


@BOTH
class TestChaosSpec:
    def test_parse_components(self, P):
        cfg = P.chaos.parse_spec("kernel_raise@flash*2;oom%0.5;seed=7")
        assert cfg.seed == 7
        kr, oom = cfg.rules
        assert (kr.seam, kr.target, kr.count) == ("kernel_raise", "flash", 2)
        assert (oom.seam, oom.target, oom.prob) == ("oom", None, 0.5)

    def test_suffix_order_insensitive(self, P):
        a = P.chaos.parse_spec("straggler@any*2~0.05").rules[0]
        b = P.chaos.parse_spec("straggler@any~0.05*2").rules[0]
        assert (a.count, a.delay_s) == (b.count, b.delay_s) == (2, 0.05)

    def test_unknown_seam_raises(self, P):
        with pytest.raises(ValueError, match="unknown seam"):
            P.chaos.parse_spec("explode*1")

    def test_bad_prob_raises(self, P):
        with pytest.raises(ValueError, match="prob"):
            P.chaos.parse_spec("oom%1.5")

    def test_count_inf(self, P):
        assert P.chaos.parse_spec("oom*inf").rules[0].count == float("inf")

    def test_count_exhausts(self, P):
        with P.chaos.chaos_scope("oom*2"):
            fired = [P.chaos._should_fire("oom") is not None for _ in range(4)]
        assert fired == [True, True, False, False]

    def test_seeded_probability_is_deterministic(self, P):
        def draw(spec):
            with P.chaos.chaos_scope(spec):
                return [P.chaos._should_fire("oom") is not None for _ in range(12)]

        a = draw("oom*inf%0.5;seed=42")
        b = draw("oom*inf%0.5;seed=42")
        c = draw("oom*inf%0.5;seed=9")
        assert a == b
        assert a != c

    def test_env_activation(self, P, monkeypatch):
        monkeypatch.setenv("THUNDER_TPU_CHAOS", "oom*1")
        P.chaos.reset_env_config()
        assert P.chaos.enabled()
        assert P.chaos.active().rules[0].seam == "oom"

    def test_injected_errors_name_their_seam(self, P):
        assert P.chaos.InjectedKernelError("flash", "sdpa").seam == "kernel_raise"
        assert P.chaos.InjectedOOMError().seam == "oom"
        assert ("RESOURCE_EXHAUSTED" if P is JAX else "CUDA out of memory") in str(P.chaos.InjectedOOMError())
        assert P.chaos.InjectedCompileTimeout("f").seam == "compile_timeout"


@pytest.mark.parametrize("spec", [
    "oom*inf%0.5;seed=42", "oom*inf%0.25;seed=7", "kernel_raise@flash*inf%0.7;seed=3",
    "straggler@any*inf%0.1;seed=11", "oom*300%0.5;seed=5",
])
@pytest.mark.parametrize("host", [0, 3])
def test_firing_sequences_equal_across_packages(spec, host, monkeypatch):
    """The same spec fires on the same draws in both packages: the RNG is
    ``random.Random`` seeded by the blake2s of (seed, slice, host) in both,
    and the fire protocol is the same."""
    monkeypatch.setenv("THUNDER_TPU_CHAOS_PROCESS_INDEX", str(host))
    seam = spec.split("@")[0].split("*")[0]
    target = "flash:sdpa" if seam == "kernel_raise" else "any" if seam == "straggler" else None
    seqs = []
    for P in (JAX, PORT):
        with P.chaos.chaos_scope(spec):
            seqs.append([P.chaos._should_fire(seam, target) is not None for _ in range(1000)])
    assert seqs[0] == seqs[1]
    assert 0 < sum(seqs[1]) < 1000
    assert JAX.chaos._derive_seed(42, 0, host) == PORT.chaos._derive_seed(42, 0, host)


# =============================================================================
# Executor demotion (kernel_raise -> quarantine -> re-claim)
# =============================================================================


@BOTH
class TestExecutorDemotion:
    def test_kernel_raise_recovers_bitwise_equal(self, P, tmp_path):
        _toy_executor(P)
        baseline = _baseline(P)
        log = str(tmp_path / "ev.jsonl")
        jf = P.jit(_fn, executors=["mirror_toyex", P.terminal], chaos="kernel_raise@mirror_toyex*1", events=log)
        out = jf(P.input(X))
        assert np.array_equal(P.asarray(out), baseline)
        assert any(k == (P.PrimIDs.TANH, "mirror_toyex") for k in P.demotion.quarantine_snapshot())
        claims = P.pkg.last_traces(jf)[-1].tags.get("claim_breakdown") or {}
        assert "mirror_toyex" not in claims
        kinds = _kinds(log)
        assert "fault_injected" in kinds and "executor_demoted" in kinds
        assert kinds.index("fault_injected") < kinds.index("executor_demoted")
        assert np.array_equal(P.asarray(jf(P.input(X))), baseline)

    def test_warm_entry_failure_demotes(self, P):
        _toy_executor(P)
        baseline = _baseline(P)
        jf = P.jit(_fn, executors=["mirror_toyex", P.terminal], disable_jit_staging=True)
        assert np.array_equal(P.asarray(jf(P.input(X))), baseline)
        with P.chaos.chaos_scope("kernel_raise@mirror_toyex*1"):
            out = jf(P.input(X))
        assert np.array_equal(P.asarray(out), baseline)
        assert P.demotion.quarantine_snapshot()
        cs = P.pkg.compile_stats(jf)
        assert cs.cache_hits + cs.cache_misses == cs.calls

    def test_quarantine_ttl_expires(self, P):
        P.demotion.quarantine("some.sym", "mirror_toyex", ttl=0.05)
        assert P.demotion.is_quarantined("some.sym", "mirror_toyex")
        time.sleep(0.06)
        assert not P.demotion.is_quarantined("some.sym", "mirror_toyex")

    def test_terminal_executors_never_quarantined(self, P):
        assert not P.demotion.quarantine("s", P.terminal)
        assert not P.demotion.quarantine("s", "python")
        assert not P.demotion.is_quarantined("s", P.terminal)

    def test_wildcard_quarantine(self, P):
        P.demotion.quarantine("*", "mirror_toyex", ttl=10)
        assert P.demotion.is_quarantined("anything.at.all", "mirror_toyex")

    def test_unrecognized_error_propagates(self, P):
        class Boom(RuntimeError):
            pass

        ex = P.get_executor("mirror_boomex")
        if ex is None:
            ex = P.OperatorExecutor("mirror_boomex")
            P.register_executor(ex)

            def _boom(a):
                raise Boom("user bug, not a fault class")

            ex.register_implementation(P.PrimIDs.TANH, fn=_boom)
        jf = P.jit(_fn, executors=["mirror_boomex", P.terminal])
        with pytest.raises(RuntimeError, match="user bug"):
            jf(P.input(X))
        assert not P.demotion.quarantine_snapshot()


def test_demotion_is_logged_as_a_warning(caplog):
    """Every demotion of the port is loud: a WARNING naming the symbol, the
    executor and the TTL, beside the event and the counter."""
    tmonitor.enable()
    with caplog.at_level("WARNING", logger="thunder_tpu_torch"):
        assert tdemotion.quarantine("torch.scaled_dot_product_attention", "flash", ttl=7, reason="test")
    msgs = [r.getMessage() for r in caplog.records if r.levelname == "WARNING"]
    assert any("flash" in m and "torch.scaled_dot_product_attention" in m and "7s" in m for m in msgs)
    assert tmetrics.EXECUTOR_DEMOTIONS.value(executor="flash") == 1


def test_only_injected_kernel_faults_classify_as_kernel():
    """The port's policy: an injected kernel fault demotes; a real kernel
    failure's messages (a failed build, a launch status, the JAX package's
    Pallas/Mosaic markers) classify as nothing and propagate; an OOM is an
    OOM; a torn library is cache corruption."""
    assert tdemotion.classify_failure(tchaos.InjectedKernelError("flash", "sdpa")) == tdemotion.KERNEL
    for msg in ("CUDA kernel build failed", "CUDA kernel flash_fwd failed to launch: misaligned address (error 716)",
                "pallas kernel lowering failed", "mosaic: splash"):
        assert tdemotion.classify_failure(RuntimeError(msg)) is None
    assert tdemotion.classify_failure(torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")) == tdemotion.OOM
    assert tdemotion.classify_failure(RuntimeError("CUDA out of memory")) == tdemotion.OOM
    assert tdemotion.classify_failure(tdemotion.KernelCacheCorrupt("torn")) == tdemotion.CACHE_CORRUPT
    try:
        try:
            raise tchaos.InjectedOOMError()
        except Exception as e:
            raise RuntimeError("staging f: the CUDA graph capture failed") from e
    except RuntimeError as wrapped:
        assert tdemotion.classify_failure(wrapped) == tdemotion.OOM


def test_real_build_failure_propagates_out_of_jit(monkeypatch):
    """A real failure of a port kernel raises out of ``jit`` untouched: here
    the build (``_build.build``, monkeypatched to fail as a broken nvcc
    would), reached from a kernel wrapper; nothing is quarantined and no
    entry is left behind."""
    from thunder_tpu_torch.executors import _build, fusedex

    def broken_build():
        raise RuntimeError("CUDA kernel build failed:\n$ nvcc ... error: expected a ';'")

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", broken_build)
    # The CPU route runs the plain version; make it reach the library, as a
    # CUDA call does, so that the build is on the path.
    monkeypatch.setattr(fusedex, "cross_entropy_rows", lambda *a, **k: _build.lib())
    logits = torch.from_numpy(np.random.RandomState(0).randn(8, 16).astype(np.float32))
    target = torch.from_numpy(np.random.RandomState(1).randint(0, 16, (8,)))
    jf = tt.jit(lambda x, t: torch.nn.functional.cross_entropy(x, t), executors=["fused", "torch"], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA kernel build failed"):
        jf(logits, target)
    assert not tdemotion.quarantine_snapshot()
    assert tt.compile_stats(jf).cache_entries == [] and tt.compile_stats(jf).fast_cache == {}


def test_real_load_and_launch_failures_propagate(monkeypatch):
    """A library that fails to load for another reason than a torn file,
    and a non-zero launch status, raise as they are (not as cache
    corruption, not as a demotion)."""
    import ctypes

    from thunder_tpu_torch.executors import _build

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda: _build.BuildInfo(_build.BUILD_ROOT / "x.so", 0.0, ""))

    def bad_load(path):
        raise OSError(f"{path}: undefined symbol: thunder_flash_fwd")

    monkeypatch.setattr(ctypes, "CDLL", bad_load)
    with pytest.raises(OSError, match="undefined symbol") as info:
        _build.lib()
    assert tdemotion.classify_failure(info.value) is None

    def torn_load(path):
        raise OSError(f"{path}: file too short")

    monkeypatch.setattr(ctypes, "CDLL", torn_load)
    with pytest.raises(tdemotion.KernelCacheCorrupt):
        _build.lib()


@pytest.mark.parametrize("dtype,executor", [("float32", "fused"), ("bfloat16", "flash")])
def test_demoted_gpt_tiny_matches_torch_and_jax(dtype, executor, tmp_path):
    """``kernel_raise`` on a kernel executor of gpt-tiny's value_and_grad:
    the first call demotes that executor's claims (the attention-residual
    pair with the attention it came from), recompiles, and its loss and
    grads equal an undemoted run through ``executors=["torch"]`` bit for
    bit; the loss is within the stated tolerance of the JAX package's."""
    import jax

    from thunder_tpu.core import dtypes as jdtypes
    from thunder_tpu.models import gpt as jgpt

    from thunder_tpu_torch.models import gpt as tgpt

    tcfg = tgpt.name_to_config("gpt-tiny")
    jcfg = jgpt.GPTConfig(**dataclasses.asdict(tcfg))
    jparams = jgpt.init_params(jcfg, dtype=getattr(jdtypes, dtype), seed=0)
    tparams = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    idx = np.random.RandomState(0).randint(0, tcfg.vocab_size, (2, 64))
    tgt = np.roll(idx, -1, axis=1)
    ti, tg = torch.from_numpy(idx), torch.from_numpy(tgt)

    def loss(p, i, t):
        return tgpt.loss_fn(p, i, t, tcfg)

    log = str(tmp_path / "ev.jsonl")
    demoted = tt.value_and_grad(loss, executors=[executor, "torch"], device="cpu",
                                chaos=f"kernel_raise@{executor}*1", events=log)
    l1, g1 = demoted(tparams, ti, tg)
    assert {ex for _, ex in tdemotion.quarantine_snapshot()} == {executor}
    assert executor not in (tt.last_traces(demoted)[-1].tags.get("claim_breakdown") or {})
    kinds = _kinds(log)
    assert kinds.index("fault_injected") < kinds.index("executor_demoted")
    l0, g0 = tt.value_and_grad(loss, executors=["torch"], device="cpu")(tparams, ti, tg)
    assert torch.equal(l1, l0)
    assert len(g1) == len(g0) and all(torch.equal(a, b) for a, b in zip(g1, g0))
    jl, _ = ttpu.value_and_grad(lambda p, i, t: jgpt.loss_fn(p, i, t, jcfg), executors=["jax"])(
        jparams, idx.astype(np.int32), tgt.astype(np.int32))
    assert abs(float(l1) - float(jl)) <= (1e-5 if dtype == "float32" else 1e-4)


# =============================================================================
# Compile de-opt ladder
# =============================================================================


@BOTH
class TestDeoptLadder:
    def test_compile_fail_recovers_at_level_1(self, P, tmp_path):
        baseline = _baseline(P)
        log = str(tmp_path / "ev.jsonl")
        jf = P.jit(_fn, executors=[P.terminal], chaos="compile_fail*1", events=log)
        assert np.array_equal(P.asarray(jf(P.input(X))), baseline)
        info = P.pkg.cache_info(jf)
        assert info["degradation_level"] == 1
        assert [e["degradation_level"] for e in info["entries"]] == [1]
        kinds = _kinds(log)
        assert kinds.index("fault_injected") < kinds.index("compile_deopt")

    def test_compile_timeout_recovers(self, P):
        baseline = _baseline(P)
        jf = P.jit(_fn, executors=[P.terminal], chaos="compile_timeout*1")
        assert np.array_equal(P.asarray(jf(P.input(X))), baseline)
        assert P.pkg.cache_info(jf)["degradation_level"] == 1

    def test_oom_at_first_run_recovers(self, P, tmp_path):
        baseline = _baseline(P)
        log = str(tmp_path / "ev.jsonl")
        jf = P.jit(_fn, executors=[P.terminal], chaos="oom*1", events=log)
        assert np.array_equal(P.asarray(jf(P.input(X))), baseline)
        info = P.pkg.cache_info(jf)
        assert len(info["entries"]) == 1
        assert info["entries"][0]["degradation_level"] == 1
        kinds = _kinds(log)
        assert kinds.index("fault_injected") < kinds.index("compile_deopt")

    def test_repeated_oom_climbs_to_exact_shapes(self, P):
        jf = P.jit(_fn, executors=[P.terminal], cache="symbolic values", symbolic_dims={0: (0,)}, chaos="oom*3")
        out = jf(P.input(X))
        assert np.array_equal(P.asarray(out), _baseline(P))
        info = P.pkg.cache_info(jf)
        assert info["degradation_level"] == 3
        assert info["entries"][-1]["buckets"] == "exact"

    def test_ladder_exhausted_raises_typed_error(self, P):
        jf = P.jit(_fn, executors=[P.terminal], chaos="oom*inf")
        with pytest.raises(P.chaos.InjectedOOMError):
            jf(P.input(X))

    def test_compile_failures_exhaust_loudly(self, P):
        jf = P.jit(_fn, executors=[P.terminal], chaos="compile_fail*inf")
        with pytest.raises(P.chaos.InjectedCompileError):
            jf(P.input(X))

    def test_aggressive_remat_scope(self, P):
        remat = (__import__("thunder_tpu.transforms.rematerialization", fromlist=["x"]) if P is JAX
                 else __import__("thunder_tpu_torch.transforms.rematerialization", fromlist=["x"]))
        assert remat.aggressiveness() == "normal"
        with remat.aggressive_remat():
            assert remat.aggressiveness() == "aggressive"
        assert remat.aggressiveness() == "normal"


def _gpt_tiny_step(P, dtype="float32"):
    """gpt-tiny's value_and_grad and its inputs, the same weights and tokens
    in both packages."""
    import jax

    from thunder_tpu.core import dtypes as jdtypes
    from thunder_tpu.models import gpt as jgpt

    from thunder_tpu_torch.models import gpt as tgpt

    tcfg = tgpt.name_to_config("gpt-tiny")
    jcfg = jgpt.GPTConfig(**dataclasses.asdict(tcfg))
    jparams = jgpt.init_params(jcfg, dtype=getattr(jdtypes, dtype), seed=0)
    idx = np.random.RandomState(0).randint(0, tcfg.vocab_size, (2, 64))
    tgt = np.roll(idx, -1, axis=1)
    if P is JAX:
        return (lambda **k: ttpu.value_and_grad(lambda p, i, t: jgpt.loss_fn(p, i, t, jcfg), executors=["jax"], **k),
                (jparams, idx.astype(np.int32), tgt.astype(np.int32)))
    tparams = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return (lambda **k: tt.value_and_grad(lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg), executors=["torch"],
                                          device="cpu", **k),
            (tparams, torch.from_numpy(idx), torch.from_numpy(tgt)))


def _ladder(P, spec, tmp_path, hbm):
    make, args = _gpt_tiny_step(P)
    log = str(tmp_path / f"{P.name}-{abs(hash((spec, hbm)))}.jsonl")
    jf = make(chaos=spec, events=log)
    try:
        jf(*args)
        outcome = "ok"
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        outcome = type(e).__name__
    deopts = [r for r in _events(log) if r["kind"] == "compile_deopt"]
    return outcome, [(r["level"], r.get("skipped_levels"), "predicted_peak_bytes" in r) for r in deopts]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_level_two_rematerializes_the_joint_program(dtype):
    """Level 2 runs ``rematerialize_joint`` on gpt-tiny's value_and_grad:
    the program differs from level 1's (forward values recomputed in the
    backward), its planned peak is lower, it is what ``predict_level_peaks``
    prices as L2, and its loss and grads equal level 0's bit for bit (the
    same ops on the same inputs) and the JAX package's within 1e-5 (f32)
    or 1e-4 (bf16)."""
    from thunder_tpu_torch.analysis.liveness import plan_liveness, predict_level_peaks
    from thunder_tpu_torch.core.pytree import tree_flatten

    make, args = _gpt_tiny_step(PORT, dtype)
    runs = {}
    for level in (0, 1, 2):
        jf = make()
        jf._lc_cd._deopt_level = level
        loss, grads = jf(*args)
        trc = tt.last_traces(jf)[-1]
        runs[level] = (loss, tree_flatten(grads)[0], trc, plan_liveness(trc, include_rows=False).peak_bytes)
    remat = runs[2][2].tags.get("remat_joint")
    assert runs[1][2].tags.get("remat_joint") is None
    assert remat["mode"] == "aggressive" and remat["recomputed"] > 0 and remat["ops"] > 0
    assert runs[2][3] < runs[1][3]
    peaks = predict_level_peaks(runs[1][2])
    assert peaks[1] == runs[1][3] and peaks[2] == peaks[3] == runs[2][3]
    for level in (1, 2):
        assert torch.equal(runs[level][0], runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(runs[level][1], runs[0][1]))
    jmake, jargs = _gpt_tiny_step(JAX, dtype)
    jloss, _ = jmake()(*jargs)
    tol = 1e-5 if dtype == "float32" else 1e-4
    assert abs(float(runs[2][0].float()) - float(np.asarray(jloss, dtype=np.float32))) <= tol


def _oom_executor(budget: dict):
    """A port executor whose tanh raises a real (not injected)
    ``torch.OutOfMemoryError`` while ``budget["n"]`` is positive."""
    ex = tget_executor("mirror_oomex")
    if ex is None:
        ex = TOperatorExecutor("mirror_oomex")
        tregister_executor(ex)
    base = tget_executor("torch").get_impl(TPrimIDs.TANH)

    def _tanh(a):
        if budget["n"] > 0:
            budget["n"] -= 1
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return base(a)

    ex.register_implementation(TPrimIDs.TANH, fn=_tanh)
    return ex


@pytest.mark.parametrize("grad,fails,want", [
    (False, 1, ("ok", [1])),
    (False, 2, ("OutOfMemoryError", [1])),
    (True, 2, ("ok", [1, 2])),
    (True, 3, ("OutOfMemoryError", [1, 2])),
])
def test_real_oom_skips_levels_that_repeat_the_program(grad, fails, want, tmp_path):
    """A real out-of-memory (no chaos rule) never retries a program that
    just ran out: a forward-only program has no L2 (the joint remat has
    nothing to cut) and, with no bucket padding, no L3, so after L1 the
    ladder is exhausted and the real error propagates; a joint program
    climbs to L2, whose program differs, and then stops. A chaos OOM climbs
    every level, as in the JAX package
    (``test_ladder_levels_equal_across_packages``)."""
    budget = {"n": fails}
    _oom_executor(budget)
    log = str(tmp_path / "ev.jsonl")
    opts = dict(executors=["mirror_oomex", "torch"], device="cpu", disable_jit_staging=True, events=log)
    jf = tt.value_and_grad(_fn, **opts) if grad else tt.jit(_fn, **opts)
    try:
        jf(torch.from_numpy(X))
        outcome = "ok"
    except torch.OutOfMemoryError:
        outcome = "OutOfMemoryError"
    deopts = [r for r in _events(log) if r["kind"] == "compile_deopt"]
    assert (outcome, [r["level"] for r in deopts]) == want
    assert all(r.get("repeated_levels") is None for r in deopts)
    if outcome == "ok":
        assert tt.cache_info(jf)["degradation_level"] == deopts[-1]["level"]
    assert budget["n"] == 0


@pytest.mark.parametrize("hbm", [None, "1", "1e15"])
@pytest.mark.parametrize("spec", ["compile_fail*1", "compile_timeout*1", "oom@<3*inf", "oom*inf"])
def test_ladder_levels_equal_across_packages(spec, hbm, tmp_path, monkeypatch):
    """The ladder's levels, ``skipped_levels`` and whether the planner
    guided each step are the same in both packages for gpt-tiny's
    value_and_grad under the same chaos spec and ``THUNDER_TPU_HBM_BYTES``
    (unset: the CPU has no capacity and the ladder climbs blind; 1 byte:
    nothing fits, a blind climb; 1e15: the first level fits, a guided
    one). ``oom*inf`` exhausts the ladder into the typed error."""
    if hbm is None:
        monkeypatch.delenv("THUNDER_TPU_HBM_BYTES", raising=False)
    else:
        monkeypatch.setenv("THUNDER_TPU_HBM_BYTES", hbm)
    j = _ladder(JAX, spec, tmp_path, hbm)
    p = _ladder(PORT, spec, tmp_path, hbm)
    assert p == j
    want = {"compile_fail*1": ("ok", 1), "compile_timeout*1": ("ok", 1), "oom@<3*inf": ("ok", 3),
            "oom*inf": ("InjectedOOMError", 3)}[spec]
    assert (p[0], len(p[1])) == want


def test_chaos_sched_bad_falls_back():
    """``tests/test_comm_schedule.py``'s case on the port's scheduler: a
    corrupted placement is caught by the pass's own validation, which falls
    back to the unscheduled trace and its certified order."""
    import sys

    from thunder_tpu_torch.analysis import schedule as sched_mod
    from thunder_tpu_torch.transforms.comm_schedule import schedule_collectives

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _torch_port_dist_worker import mlp_extrace

    extrace = mlp_extrace()
    order = sched_mod.certify(extrace).axis_order
    with tchaos.chaos_scope("sched_bad*1"):
        new, rep = schedule_collectives(extrace, device="cpu")
    assert new is extrace and rep is None
    assert sched_mod.certify(new).axis_order == order


def test_static_planner_schedule_gated_by_deopt():
    """The compile pipeline schedules collectives at ladder level 0 and not
    from level 1 (``api._compile_entry_impl`` passes
    ``comm_schedule=deopt_level < 1`` to the claiming pass)."""
    import inspect
    import sys

    from thunder_tpu_torch import api
    from thunder_tpu_torch.executors.passes import transform_for_execution
    from thunder_tpu_torch.extend import resolve_executors

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _torch_port_dist_worker import mlp_extrace

    src = inspect.getsource(api._compile_entry_impl)
    assert "comm_schedule=deopt_level < 1" in src
    # The claiming pass over the MLP's program, as the pipeline runs it at
    # level 0 and at level 1.
    from thunder_tpu_torch.core.trace import from_trace

    claimed = mlp_extrace()
    program = from_trace(claimed)
    program.bound_symbols = list(claimed.bound_symbols)
    at0 = transform_for_execution(program, resolve_executors(["torch"]), comm_schedule=0 < 1)
    assert at0.tags.get("comm_schedule", {}).get("moves", 0) >= 1
    at1 = transform_for_execution(program, resolve_executors(["torch"]), comm_schedule=1 < 1)
    assert "comm_schedule" not in at1.tags


# =============================================================================
# NaN poisoning + post-step isfinite guard
# =============================================================================


@BOTH
class TestNaNGuard:
    def test_poison_plus_raise(self, P):
        jf = P.jit(_fn, executors=[P.terminal], chaos="nan@tanh*1", on_nan="raise")
        with pytest.raises(P.deopt.NonFiniteOutputError):
            jf(P.input(X))

    def test_rerun_instrumented_attributes_producer(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        jf = P.jit(_fn, executors=[P.terminal], chaos="nan@tanh*1", on_nan="rerun-instrumented", events=log)
        with pytest.raises(P.deopt.NonFiniteOutputError) as exc_info:
            jf(P.input(X))
        assert exc_info.value.symbol == "chaos_nan_poison"
        assert exc_info.value.line is not None
        kinds = _kinds(log)
        assert kinds.index("fault_injected") < kinds.index("nan_guard")
        assert "nan_watch" in kinds

    def test_on_nan_warn_returns_result(self, P):
        jf = P.jit(_fn, executors=[P.terminal], chaos="nan@tanh*1", on_nan="warn")
        with pytest.warns(RuntimeWarning, match="non-finite"):
            out = jf(P.input(X))
        assert not np.isfinite(P.asarray(out)).all()

    def test_guard_passes_clean_runs(self, P):
        jf = P.jit(_fn, executors=[P.terminal], on_nan="raise")
        out = jf(P.input(X))
        assert np.array_equal(P.asarray(out), _baseline(P))
        assert np.array_equal(P.asarray(jf(P.input(X))), _baseline(P))

    def test_invalid_on_nan_rejected(self, P):
        with pytest.raises(ValueError, match="on_nan"):
            P.jit(_fn, on_nan="explode")

    def test_real_nan_input_trips_guard(self, P):
        jf = P.jit(lambda a: (a / a).sum(), executors=[P.terminal], on_nan="raise")
        with pytest.raises(P.deopt.NonFiniteOutputError):
            jf(P.input(np.zeros(4, np.float32)))

    def test_guard_ignores_nonfinite_padding_lanes(self, P):
        jf = P.jit(lambda a: 1.0 / a, executors=[P.terminal], cache="symbolic values", symbolic_dims={0: (0,)},
                   on_nan="raise")
        x = np.arange(1, 7, dtype=np.float32).reshape(6, 1)
        out = jf(P.input(x))
        assert tuple(out.shape) == (6, 1)
        assert np.isfinite(P.asarray(out)).all()


@pytest.mark.parametrize("spec,fn,x", [
    ("nan@tanh*1", _fn, X),
    ("nan@L1*1", _fn, X),
    (None, lambda a: (a / a).sum(), np.zeros(4, np.float32)),
    (None, lambda a: (a.log() * 2.0).sum(), -np.ones(4, np.float32)),
], ids=["poisoned-tanh", "poisoned-L1", "real-div", "real-log"])
def test_nan_attribution_equal_across_packages(spec, fn, x):
    """``on_nan="rerun-instrumented"`` names the same symbol, at the same
    line of the program (its executor prefix aside), in both packages."""
    named = []
    for P in (JAX, PORT):
        jf = P.jit(fn, executors=[P.terminal], chaos=spec, on_nan="rerun-instrumented")
        with pytest.raises(P.deopt.NonFiniteOutputError) as info:
            jf(P.input(x))
        named.append((info.value.symbol, info.value.line.replace(f"{P.terminal}_", "")))
    assert named[0] == named[1]


# =============================================================================
# Collective straggler
# =============================================================================


@BOTH
class TestStraggler:
    def test_straggler_delays_but_completes(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        jf = P.jit(_fn, executors=[P.terminal], chaos="straggler@any~0.05*2", events=log)
        jf(P.input(X))
        t0 = time.perf_counter()
        out = jf(P.input(X))
        dt = time.perf_counter() - t0
        assert dt >= 0.05
        assert np.array_equal(P.asarray(out), _baseline(P))
        assert "fault_injected" in _kinds(log)
        t0 = time.perf_counter()
        jf(P.input(X))
        assert time.perf_counter() - t0 < 0.05


# =============================================================================
# Checkpoint manager (retry, corruption fallback)
# =============================================================================


def _state(P):
    return {"p": P.arange(6), "step": 3}


@BOTH
class TestCheckpointManager:
    def test_roundtrip(self, P, tmp_path):
        mgr = P.preemption.CheckpointManager(str(tmp_path / "ck"), backoff_s=0)
        mgr.save(_state(P), 7, rng_seed=11)
        state, meta = mgr.restore()
        assert meta["step"] == 7 and meta["rng_seed"] == 11
        assert np.array_equal(P.asarray(state["p"]), np.arange(6, dtype=np.float32))

    def test_transient_io_error_retries(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        mgr = P.preemption.CheckpointManager(str(tmp_path / "ck"), retries=3, backoff_s=0)
        with P.events.event_scope(P.events.log_for_path(log)):
            with P.chaos.chaos_scope("ckpt_io*2"):
                mgr.save(_state(P), 1)
        assert mgr.latest_complete_step() == 1
        saves = [r for r in _events(log) if r["kind"] == "checkpoint_save"]
        assert [s["ok"] for s in saves] == [False, False, True]
        assert [r["kind"] for r in _events(log)].count("fault_injected") == 2

    def test_exhausted_retries_raise_typed_error(self, P, tmp_path):
        mgr = P.preemption.CheckpointManager(str(tmp_path / "ck"), retries=1, backoff_s=0)
        with P.chaos.chaos_scope("ckpt_io*inf"):
            with pytest.raises(P.preemption.CheckpointWriteError, match="ckpt_io"):
                mgr.save(_state(P), 1)
        assert mgr.latest_complete_step() is None

    def test_corrupted_newest_falls_back(self, P, tmp_path):
        mgr = P.preemption.CheckpointManager(str(tmp_path / "ck"), backoff_s=0)
        mgr.save(_state(P), 1)
        mgr.save(_state(P), 2)
        os.remove(os.path.join(mgr._step_dir(2), mgr.META))
        _, meta = mgr.restore()
        assert meta["step"] == 1

    def test_corrupted_payload_quarantined(self, P, tmp_path):
        import shutil

        mgr = P.preemption.CheckpointManager(str(tmp_path / "ck"), backoff_s=0)
        mgr.save(_state(P), 1)
        mgr.save(_state(P), 2)
        step2 = mgr._step_dir(2)

        def corrupt(step_dir):
            for name in os.listdir(step_dir):
                if name != mgr.META:
                    p = os.path.join(step_dir, name)
                    shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)

        corrupt(step2)
        _, meta = mgr.restore()
        assert meta["step"] == 1
        assert os.path.isdir(step2 + ".corrupt")
        mgr.save(_state(P), 2)
        corrupt(mgr._step_dir(2))
        _, meta = mgr.restore()
        assert meta["step"] == 1
        assert os.path.isdir(step2 + ".corrupt.1")

    def test_no_complete_checkpoint_raises(self, P, tmp_path):
        mgr = P.preemption.CheckpointManager(str(tmp_path / "ck"), backoff_s=0)
        with pytest.raises(P.preemption.CheckpointRestoreError):
            mgr.restore()

    def test_retention(self, P, tmp_path):
        mgr = P.preemption.CheckpointManager(str(tmp_path / "ck"), backoff_s=0, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(_state(P), s)
        assert mgr.steps_on_disk() == [3, 4]


# =============================================================================
# Preemption-safe training
# =============================================================================


def _make_step(P):
    def step(state):
        p = state["p"]
        p = p - 0.1 * (2.0 * p)
        return {"p": p}, P.sum_sq(p)

    return step


def _init_state(P):
    return {"p": P.arange(8)}


@BOTH
class TestPreemption:
    def test_sigterm_sets_flag_and_restores_handler(self, P):
        before = signal.getsignal(signal.SIGTERM)
        with P.preemption.PreemptionGuard() as guard:
            assert not guard.requested_local()
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.requested_local()
            assert guard.should_checkpoint()
        assert signal.getsignal(signal.SIGTERM) is before

    def test_sigterm_event_emitted_at_poll_not_in_handler(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        with P.events.event_scope(P.events.log_for_path(log)):
            with P.preemption.PreemptionGuard() as guard:
                os.kill(os.getpid(), signal.SIGTERM)
                while not guard._flag:
                    time.sleep(0.001)
                assert not os.path.exists(log) or "preemption" not in _kinds(log)
                assert guard.requested_local(step=5)
                assert _kinds(log).count("preemption") == 1
                guard.requested_local(step=6)
                assert _kinds(log).count("preemption") == 1

    def test_preempt_save_resume_matches_uninterrupted(self, P, tmp_path):
        uninterrupted_mgr = P.preemption.CheckpointManager(str(tmp_path / "a"), backoff_s=0)
        _, losses_all = P.preemption.run_training(_make_step(P), _init_state(P), 8, manager=uninterrupted_mgr)
        assert len(losses_all) == 8
        mgr = P.preemption.CheckpointManager(str(tmp_path / "b"), backoff_s=0)
        with P.chaos.chaos_scope("preempt@3"):
            with pytest.raises(P.preemption.Preempted) as exc_info:
                P.preemption.run_training(_make_step(P), _init_state(P), 8, manager=mgr)
        assert exc_info.value.step == 3
        assert mgr.latest_complete_step() == 3
        _, losses_resumed = P.preemption.run_training(_make_step(P), _init_state(P), 8, manager=mgr)
        assert losses_resumed == losses_all[3:]

    def test_preemption_events_logged(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        mgr = P.preemption.CheckpointManager(str(tmp_path / "ck"), backoff_s=0)
        with P.events.event_scope(P.events.log_for_path(log)):
            with P.chaos.chaos_scope("preempt@2"):
                with pytest.raises(P.preemption.Preempted):
                    P.preemption.run_training(_make_step(P), _init_state(P), 5, manager=mgr)
        kinds = _kinds(log)
        assert "fault_injected" in kinds and "preemption" in kinds
        assert "checkpoint_save" in kinds

    def test_save_every_cadence_supports_resume(self, P, tmp_path):
        mgr = P.preemption.CheckpointManager(str(tmp_path / "ck"), backoff_s=0)
        _, losses_all = P.preemption.run_training(
            _make_step(P), _init_state(P), 6,
            manager=P.preemption.CheckpointManager(str(tmp_path / "ref"), backoff_s=0))
        P.preemption.run_training(_make_step(P), _init_state(P), 4, manager=mgr, save_every=2)
        assert mgr.latest_complete_step() == 2
        _, tail = P.preemption.run_training(_make_step(P), _init_state(P), 6, manager=mgr)
        assert tail == losses_all[2:]


def _gpt_sgd_step(P, lr=0.05):
    """gpt-tiny SGD in float32 as ``step(state) -> (state, loss)``: the same
    weights and tokens in both packages; the state is the params and the
    step counter, which picks the step's batch (the data order)."""
    make, (params, idx, tgt) = _gpt_tiny_step(P)
    vg = make()
    rng = np.random.RandomState(1)
    batches = [rng.randint(0, 96, (2, 64)) for _ in range(6)]

    def step(state):
        k = int(state["k"])
        b = batches[k % len(batches)]
        i = b.astype(np.int32) if P is JAX else torch.from_numpy(b)
        t = np.roll(b, -1, axis=1)
        t = t.astype(np.int32) if P is JAX else torch.from_numpy(t)
        loss, grads = vg(state["params"], i, t)
        if P is JAX:
            import jax

            leaves, spec = jax.tree_util.tree_flatten(state["params"])
            new = jax.tree_util.tree_unflatten(spec, [p - lr * g for p, g in zip(leaves, grads)])
        else:
            import torch.utils._pytree as pt

            leaves, spec = pt.tree_flatten(state["params"])
            new = pt.tree_unflatten([p - lr * g for p, g in zip(leaves, grads)], spec)
        return {"params": new, "k": state["k"] + 1}, float(loss)

    init = {"params": params, "k": (np.int32(0) if P is JAX else torch.tensor(0))}
    return step, init


def test_gpt_tiny_preempted_and_resumed_bitwise(tmp_path):
    """gpt-tiny SGD in float32, preempted at step 3 and resumed by a fresh
    manager: the port's losses equal its uninterrupted run's bit for bit,
    and the JAX package's trajectory within 1e-5."""
    runs = {}
    for P in (JAX, PORT):
        step, init = _gpt_sgd_step(P)
        _, full = P.preemption.run_training(step, init, 6,
                                            manager=P.preemption.CheckpointManager(str(tmp_path / f"{P.name}a"),
                                                                                   backoff_s=0))
        mgr = P.preemption.CheckpointManager(str(tmp_path / f"{P.name}b"), backoff_s=0)
        with P.chaos.chaos_scope("preempt@3"):
            with pytest.raises(P.preemption.Preempted):
                P.preemption.run_training(step, init, 6, manager=mgr)
        step2, init2 = _gpt_sgd_step(P)
        _, tail = P.preemption.run_training(step2, init2, 6,
                                            manager=P.preemption.CheckpointManager(str(tmp_path / f"{P.name}b"),
                                                                                   backoff_s=0))
        runs[P.name] = (full, tail)
    full, tail = runs["port"]
    assert len(full) == 6 and tail == full[3:]
    np.testing.assert_allclose(full, runs["jax"][0], rtol=0, atol=1e-5)


# =============================================================================
# Event-log replay: fault -> recovery correlation
# =============================================================================


def _write_log(path, records):
    with open(path, "w") as f:
        for i, rec in enumerate(records):
            rec = dict({"v": 1, "ts": float(i), "seq": i, "pid": 1, "host": 0}, **rec)
            f.write(json.dumps(rec) + "\n")


@BOTH
class TestReplayCorrelation:
    def test_unrecovered_fault_flagged(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        _write_log(log, [{"kind": "fault_injected", "seam": "kernel_raise", "target": "flash", "n": 1}])
        summary, diags = P.replay(log)
        assert summary["unrecovered_faults"] == ["kernel_raise@flash"]
        assert any(d.rule == "events.unrecovered-fault" and d.severity >= Severity.ERROR for d in diags)

    def test_recovered_fault_clean(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        _write_log(log, [
            {"kind": "fault_injected", "seam": "kernel_raise", "target": "flash", "n": 1},
            {"kind": "executor_demoted", "sym": "torch.sdpa", "executor": "flash", "ttl_s": 300.0,
             "reason": "InjectedKernelError"},
            {"kind": "fault_injected", "seam": "ckpt_io", "target": None, "n": 1},
            {"kind": "checkpoint_save", "path": "/x", "step": 1, "ok": True, "attempt": 1},
        ])
        summary, diags = P.replay(log)
        assert summary["unrecovered_faults"] == []
        assert not [d for d in diags if d.rule == "events.unrecovered-fault"]

    def test_failed_save_does_not_count_as_recovery(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        _write_log(log, [
            {"kind": "fault_injected", "seam": "ckpt_io", "target": None, "n": 1},
            {"kind": "checkpoint_save", "path": "/x", "step": 1, "ok": False, "attempt": 0},
        ])
        summary, _ = P.replay(log)
        assert summary["unrecovered_faults"] == ["ckpt_io@None"]


def _findings(replay, log):
    summary, diags = replay(log)
    return (summary["faults_injected"], summary["unrecovered_faults"],
            sorted((d.rule, int(d.severity)) for d in diags if d.rule.startswith("events.unrecovered")))


@pytest.mark.parametrize("spec,runs", [
    ("kernel_raise@mirror_toyex*1", 1), ("compile_fail*1;oom*1", 1), ("nan@tanh*1", 1), ("ckpt_io*2", 0),
])
def test_replays_of_the_same_chaos_run_agree(spec, runs, tmp_path):
    """A chaos run through each package writes its log; each log replays to
    the same findings through both replays, and the two logs to the same
    findings as each other."""
    findings = []
    for P in (JAX, PORT):
        _toy_executor(P)
        log = str(tmp_path / f"{P.name}.jsonl")
        if runs:
            jf = P.jit(_fn, executors=["mirror_toyex", P.terminal], chaos=spec, events=log,
                       on_nan="warn" if spec.startswith("nan") else None)
            if spec.startswith("nan"):
                with pytest.warns(RuntimeWarning):
                    jf(P.input(X))
            else:
                jf(P.input(X))
        else:
            mgr = P.preemption.CheckpointManager(str(tmp_path / f"{P.name}ck"), backoff_s=0)
            with P.events.event_scope(P.events.log_for_path(log)), P.chaos.chaos_scope(spec):
                mgr.save(_state(P), 1)
        findings.append([_findings(r, log) for r in (jreplay, treplay)])
    assert findings[0][0] == findings[0][1] == findings[1][0] == findings[1][1]
    assert findings[0][0][0] and findings[0][0][1] == []


# =============================================================================
# Satellites
# =============================================================================


@BOTH
class TestEventLogDropSatellite:
    def test_sink_failure_increments_counter_without_metrics(self, P, tmp_path):
        assert not P.monitor.enabled()
        before = P.metrics.EVENT_LOG_DROPPED.value()
        log = P.events.EventLog(str(tmp_path / "nope" / "deep"))
        (tmp_path / "nope").write_text("a file, not a dir")
        with pytest.warns(UserWarning, match="disabled after I/O failure"):
            log.emit("cache_miss", fn="f", call=1)
        assert P.metrics.EVENT_LOG_DROPPED.value() == before + 1
        rep = P.monitor.report()["thunder_tpu_event_log_dropped_total"]
        assert sum(rep["values"].values()) >= 1


class TestCompileCacheSatellite:
    """The port's compile cache is its kernel build directory: an entry is
    an object or the linked library."""

    def test_sweep_removes_torn_entries_only(self, tmp_path, caplog):
        from thunder_tpu_torch.resilience.compile_cache import sweep_corrupt_entries

        good = tmp_path / "entry_good.o"
        good.write_bytes(b"x" * 64)
        torn = tmp_path / "libthunder_kernels.so"
        torn.write_bytes(b"")
        lock = tmp_path / "lock"
        lock.write_bytes(b"")  # not an entry: never swept
        with caplog.at_level("WARNING", logger="thunder_tpu_torch"):
            removed = sweep_corrupt_entries(str(tmp_path))
        assert removed == [str(torn)]
        assert good.exists() and not torn.exists() and lock.exists()
        assert any("corrupt entry" in r.getMessage() for r in caplog.records)

    def test_chaos_corrupt_then_sweep(self, tmp_path):
        from thunder_tpu_torch.resilience.compile_cache import sweep_corrupt_entries

        (tmp_path / "entry.o").write_bytes(b"y" * 32)
        with tchaos.chaos_scope("cache_corrupt*1"):
            victim = tchaos.corrupt_cache_seam(str(tmp_path))
        assert victim is not None and os.path.getsize(victim) == 0
        assert sweep_corrupt_entries(str(tmp_path)) == [victim]

    def test_corrupt_seam_not_consumed_on_empty_dir(self, tmp_path):
        empty = tmp_path / "empty"
        empty.mkdir()
        (tmp_path / "entry.o").write_bytes(b"y" * 32)
        with tchaos.chaos_scope("cache_corrupt*1"):
            assert tchaos.corrupt_cache_seam(str(empty)) is None
            victim = tchaos.corrupt_cache_seam(str(tmp_path))
        assert victim is not None

    def test_cache_corrupt_seam_wired_into_the_build(self, tmp_path, monkeypatch):
        """The seam fires, and the sweep repairs, when the build first looks
        at its directory; the build then rebuilds the removed library (here
        it reaches for nvcc, which this machine lacks) and never falls back
        to the plain versions."""
        from thunder_tpu_torch.executors import _build

        monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
        monkeypatch.setattr(_build, "_swept", set())
        monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
        out = tmp_path / _build._digest()
        out.mkdir()
        lib = out / _build.LIB_NAME
        lib.write_bytes(b"\x7fELF" + b"z" * 64)
        with tchaos.chaos_scope("cache_corrupt*1"):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                _build.build()
        assert not lib.exists()  # corrupted by the seam, removed by the sweep

    def test_purge_on_error_clears_the_build_directory(self, tmp_path, monkeypatch):
        from thunder_tpu_torch.executors import _build
        from thunder_tpu_torch.resilience import compile_cache

        monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
        out = tmp_path / _build._digest()
        out.mkdir()
        (out / _build.LIB_NAME).write_bytes(b"\x7fELF" + b"z" * 8)
        (out / "flash_attn.o").write_bytes(b"o" * 8)
        assert compile_cache.purge_on_error(tdemotion.KernelCacheCorrupt("torn"))
        assert compile_cache._entry_files(str(out)) == []

    @pytest.mark.parametrize("step", ["build", "purge"])
    def test_sweep_and_purge_wait_for_the_build_lock(self, step, tmp_path, monkeypatch):
        """While another build holds the directory's lock (its nvcc may be
        writing an object that is still empty), neither the build's first
        sweep nor a purge touches the directory; each runs once the lock is
        released."""
        import fcntl
        import threading

        from thunder_tpu_torch.executors import _build
        from thunder_tpu_torch.resilience import compile_cache

        monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
        monkeypatch.setattr(_build, "_swept", set())
        out = tmp_path / _build._digest()
        out.mkdir()
        (out / _build.LIB_NAME).write_bytes(b"\x7fELF" + b"z" * 64)
        writing = out / "flash_attn.o"
        writing.write_bytes(b"")  # an object nvcc has just opened
        done = threading.Event()
        run = _build.build if step == "build" else (
            lambda: compile_cache.purge_on_error(tdemotion.KernelCacheCorrupt("torn")))
        with open(out / "lock", "w") as held:
            fcntl.flock(held, fcntl.LOCK_EX)
            worker = threading.Thread(target=lambda: (run(), done.set()), daemon=True)
            worker.start()
            assert not done.wait(0.5)
            assert writing.exists()
        worker.join(timeout=30)
        assert done.is_set() and not writing.exists()

    def test_active_cache_dir_logged_once(self, tmp_path, monkeypatch, caplog):
        """``TestPersistentCacheConfig``'s case with a seat in the port: the
        build directory is named once a process, at its first look."""
        import logging

        from thunder_tpu_torch.executors import _build

        monkeypatch.setattr(_build, "_swept", set())
        with caplog.at_level(logging.INFO, logger="thunder_tpu_torch"):
            _build._sweep(tmp_path)
            _build._sweep(tmp_path)
        assert sum("kernel build directory" in r.getMessage() for r in caplog.records) == 1


@BOTH
class TestQuarantineMetricsAndInfo:
    def test_demotion_metric(self, P):
        P.monitor.enable()
        P.demotion.quarantine("a.b", "flash", ttl=1)
        assert P.metrics.EXECUTOR_DEMOTIONS.value(executor="flash") == 1

    def test_cache_info_default_degradation(self, P):
        jf = P.jit(_fn, executors=[P.terminal])
        jf(P.input(X))
        info = P.pkg.cache_info(jf)
        assert info["degradation_level"] == 0
        assert info["entries"][0]["degradation_level"] == 0


def test_chaos_and_on_nan_refused_on_the_module_frontend():
    with pytest.raises(NotImplementedError, match="chaos/on_nan"):
        tt.jit(torch.nn.Linear(4, 4), device="cpu", on_nan="raise")
