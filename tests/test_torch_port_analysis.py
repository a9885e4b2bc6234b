"""The analysis layer (verifier, liveness, cost, ``examine``) through both packages.

Each case of ``tests/test_analysis.py`` (all but ``TestCollectiveRules``:
the port has no distributed prims yet), of ``tests/test_static_planner.py``'s
``TestLivenessGoldens``, ``TestPredictedOOMRule``, ``TestDonationRules``
(the hand-made traces; the JAX package's compile-pipeline donation cases
have no counterpart, since the port stages no donated input) and
``test_memory_report_end_to_end``, ``TestSymbolicChecksSmoke``
(``tests/test_symbolic_cache.py:449``) and ``test_lint_prints_cache_summary``
is written once over a namespace ``P`` and run through the JAX package and
the port on the CPU. The two give the same rule ids, severities and bsym
indexes on the same hand-made traces, and the same predicted peak bytes
with the port's allocator rounding off (``block_bytes=1``); with it on
(the default, 512-byte blocks) every buffer is charged its rounded size,
which one test states and checks.

The port alone: ``debug_checks=True`` over its own constructs (a 2-layer
GPT under ``+norm``, the ``quant`` stack, autocast, dropout's keyed draw,
symbolic values, ``vmap(grad)``, masked attention's verdicts, a module's
split forward and backward) finds no error; a planted bad transform is
attributed to its pass; the cost model's kernel rows on the ``h100`` spec
and the CPU's spec; ``hlo_report`` auditing a call's record.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import thunder_tpu
import thunder_tpu.analysis as janalysis
import thunder_tpu.analysis.liveness as jliveness
import thunder_tpu.clang as jclang
import thunder_tpu.core.prims as jprims
import thunder_tpu.examine as jexamine
import thunder_tpu.torch as jtorch
from thunder_tpu.api import trace_program as jtrace_program
from thunder_tpu.core import devices as jdevices
from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.core import trace as jtrace
from thunder_tpu.core.proxies import TensorProxy as JTensorProxy
from thunder_tpu.executors import passes as jpasses
from thunder_tpu import extend as jextend
from thunder_tpu.models import gpt as jgpt
from thunder_tpu.transforms import common as jcommon

import thunder_tpu_torch as tt
import thunder_tpu_torch.analysis as tanalysis
import thunder_tpu_torch.analysis.liveness as tliveness
import thunder_tpu_torch.clang as tclang
import thunder_tpu_torch.core.prims as tprims
import thunder_tpu_torch.examine as texamine
import thunder_tpu_torch.torch as ttorch
from thunder_tpu_torch.api import trace_program as ttrace_program
from thunder_tpu_torch.core import devices as tdevices
from thunder_tpu_torch.core import dtypes as tdtypes
from thunder_tpu_torch.core import trace as ttrace
from thunder_tpu_torch.core.proxies import TensorProxy as TTensorProxy
from thunder_tpu_torch.executors import passes as tpasses
from thunder_tpu_torch import extend as textend
from thunder_tpu_torch.models import gpt as tgpt
from thunder_tpu_torch.transforms import common as tcommon

JAX = SimpleNamespace(name="jax", analysis=janalysis, liveness=jliveness, clang=jclang, prims=jprims,
                      examine=jexamine, ltorch=jtorch, devices=jdevices, dtypes=jdtypes, trace=jtrace,
                      TensorProxy=JTensorProxy, passes=jpasses, extend=jextend, common=jcommon,
                      trace_program=jtrace_program, pkg=thunder_tpu, jit=thunder_tpu.jit,
                      value_and_grad=thunder_tpu.value_and_grad, executors=["jax"], exact={})
PORT = SimpleNamespace(name="port", analysis=tanalysis, liveness=tliveness, clang=tclang, prims=tprims,
                       examine=texamine, ltorch=ttorch, devices=tdevices, dtypes=tdtypes, trace=ttrace,
                       TensorProxy=TTensorProxy, passes=tpasses, extend=textend, common=tcommon,
                       trace_program=ttrace_program, pkg=tt, jit=lambda f, **k: tt.jit(f, device="cpu", **k),
                       value_and_grad=lambda f, **k: tt.value_and_grad(f, device="cpu", **k), executors=["torch"],
                       exact={"block_bytes": 1})
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=lambda P: P.name)
F32 = 4


def _t(P, shape=(4, 4), dtype=None, name=None):
    return P.TensorProxy(name=name, shape=shape, dtype=dtype or P.dtypes.float32, device=P.devices.Device("cpu"))


def _good(P):
    trc = P.trace.TraceCtx()
    with P.trace.tracectx(trc):
        a, b = _t(P), _t(P)
        trc.args = (a, b)
        d = P.clang.mul(P.clang.add(a, b), P.clang.add(a, b))
        P.prims.python_return(d)
        trc.output = d
    return trc


def _rules(diags, rule):
    return [d for d in diags if d.rule == rule]


def _errors(diags):
    return [d for d in diags if d.severity >= d.severity.ERROR]


def _summary(diags):
    return sorted((d.rule, int(d.severity), d.bsym_index) for d in diags)


def _bind_trace(P, build):
    """A trace of hand-bound symbols: ``build(trc, P)`` appends them and
    returns the output."""
    trc = P.trace.TraceCtx()
    out = build(trc, P)
    with P.trace.tracectx(trc):
        P.prims.python_return(out)
    trc.output = out
    return trc


# =============================================================================
# tests/test_analysis.py
# =============================================================================


def _use_before_def(trc, P):
    with P.trace.tracectx(trc):
        a = _t(P)
        trc.args = (a,)
        ghost, out = _t(P), _t(P)
    trc.bound_symbols.append(P.prims.add.bind(a, ghost, output=out))
    return out


def _redefinition(trc, P):
    with P.trace.tracectx(trc):
        a = _t(P)
        trc.args = (a,)
        out1 = _t(P)
    trc.bound_symbols.append(P.prims.add.bind(a, a, output=out1))
    trc.bound_symbols.append(P.prims.mul.bind(a, a, output=out1.replace_name(out1.name)))
    return out1


def _dtype_drift(trc, P):
    with P.trace.tracectx(trc):
        a, b = _t(P), _t(P)
        trc.args = (a, b)
        drifted = _t(P, dtype=P.dtypes.bfloat16)
    trc.bound_symbols.append(P.prims.add.bind(a, b, output=drifted))
    return drifted


def _shape_drift(trc, P):
    with P.trace.tracectx(trc):
        a = _t(P, (4, 4))
        trc.args = (a,)
        drifted = _t(P, (2, 2))
    trc.bound_symbols.append(P.prims.neg.bind(a, output=drifted))
    return drifted


def _meta_reject(trc, P):
    with P.trace.tracectx(trc):
        a, b = _t(P, (4, 4)), _t(P, (2, 2))
        trc.args = (a, b)
        out = _t(P, (4, 4))
    trc.bound_symbols.append(P.prims.add.bind(a, b, output=out))
    return out


def _inplace_hazard(trc, P):
    with P.trace.tracectx(trc):
        src, dst = _t(P), _t(P)
        trc.args = (src, dst)
        written = _t(P)
    trc.bound_symbols.append(P.prims.copy_.bind(src, dst, output=written))
    with P.trace.tracectx(trc):
        return P.clang.mul(dst, dst)


def _inplace_clean(trc, P):
    with P.trace.tracectx(trc):
        src, dst = _t(P), _t(P)
        trc.args = (src, dst)
        written = _t(P)
    trc.bound_symbols.append(P.prims.copy_.bind(src, dst, output=written))
    return written


def _dead_symbol(trc, P):
    with P.trace.tracectx(trc):
        a, b = _t(P), _t(P)
        trc.args = (a, b)
        c = P.clang.add(a, b)
        P.clang.sub(a, b)
        return c


def _side_effect(trc, P):
    with P.trace.tracectx(trc):
        src, dst = _t(P), _t(P)
        trc.args = (src, dst)
        written = _t(P)
    trc.bound_symbols.append(P.prims.copy_.bind(src, dst, output=written))
    with P.trace.tracectx(trc):
        return P.clang.add(src, src)


SEEDED = {  # case: (builder, rule, expected count, bsym index of the first)
    "use_before_def": (_use_before_def, "ssa.use-before-def", 1, 0),
    "redefinition": (_redefinition, "ssa.redefinition", 1, 1),
    "dtype_drift": (_dtype_drift, "meta.mismatch", 1, 0),
    "shape_drift": (_shape_drift, "meta.mismatch", 1, 0),
    "meta_reject": (_meta_reject, "meta.reject", 1, 0),
    "inplace_hazard": (_inplace_hazard, "alias.inplace-hazard", 1, 0),
    "inplace_clean": (_inplace_clean, "alias.inplace-hazard", 0, None),
    "dead_symbol": (_dead_symbol, "dce.dead-symbol", 1, 1),
    "side_effect_not_dead": (_side_effect, "dce.dead-symbol", 0, None),
}


@BOTH
def test_builtin_rules_registered(P):
    assert {"ssa.use-before-def", "ssa.redefinition", "ssa.undefined-output", "meta.mismatch", "meta.reject",
            "alias.inplace-hazard", "alias.entry-aliasing", "dce.dead-symbol", "names.orphan",
            "donation.use-after-donation", "donation.donated-output", "mem.predicted-oom"} <= set(P.analysis.all_rules())


@BOTH
def test_good_trace_is_clean(P):
    diags = P.analysis.verify(_good(P))
    assert _errors(diags) == [] and [d for d in diags if d.severity == d.severity.WARNING] == []


@BOTH
def test_disable_suppresses_rule(P):
    trc = _bind_trace(P, _dead_symbol)
    assert len(_rules(P.analysis.verify(trc), "dce.dead-symbol")) == 1
    assert _rules(P.analysis.verify(trc, disable={"dce.dead-symbol"}), "dce.dead-symbol") == []


@pytest.mark.parametrize("case", sorted(SEEDED))
def test_seeded_rule_fires_as_in_the_jax_package(case):
    build, rule, count, index = SEEDED[case]
    got = {}
    for P in (JAX, PORT):
        diags = P.analysis.verify(_bind_trace(P, build))
        found = _rules(diags, rule)
        assert len(found) == count, (P.name, diags)
        if count:
            assert found[0].bsym_index == index
        got[P.name] = _summary(d for d in diags if d.rule != "names.orphan")
    assert got["jax"] == got["port"]


@BOTH
def test_undefined_output_fires_once(P):
    trc = P.trace.TraceCtx()
    with P.trace.tracectx(trc):
        a = _t(P)
        trc.args = (a,)
        c = P.clang.add(a, a)
        P.prims.python_return(c)
        never_made = _t(P)
    trc.output = never_made
    assert len(_rules(P.analysis.verify(trc), "ssa.undefined-output")) == 1


@BOTH
def test_meta_rules_suppress_independently(P):
    trc = _bind_trace(P, _meta_reject)
    assert _rules(P.analysis.verify(trc, disable={"meta.reject"}), "meta.reject") == []
    assert len(_rules(P.analysis.verify(trc, disable={"meta.mismatch"}), "meta.reject")) == 1


@BOTH
def test_cse_and_dce_keep_side_effect_ops(P):
    def two_writes(trc, P):
        with P.trace.tracectx(trc):
            src, dst = _t(P), _t(P)
            trc.args = (src, dst)
            w1, w2 = _t(P), _t(P)
        trc.bound_symbols.append(P.prims.copy_.bind(src, dst, output=w1))
        trc.bound_symbols.append(P.prims.copy_.bind(src, dst, output=w2))
        with P.trace.tracectx(trc):
            return P.clang.add(w1, w2)

    assert [b.sym.name for b in P.common.cse(_bind_trace(P, two_writes)).bound_symbols].count("copy_") == 2
    assert "copy_" in [b.sym.name for b in P.common.dce(_bind_trace(P, _side_effect)).bound_symbols]


@BOTH
def test_name_registry(P):
    trc = P.trace.TraceCtx()
    trc.add_name("x7")
    with pytest.raises(ValueError, match="already registered"):
        trc.add_name("x7")
    assert trc.make_name("x") != "x7"
    trc = P.trace.TraceCtx()
    with P.trace.tracectx(trc):
        _t(P, name="dup")
        with pytest.raises(ValueError, match="already registered"):
            _t(P, name="dup")


@BOTH
def test_mark_attributes_failure_to_pass(P):
    trc = _bind_trace(P, _use_before_def)
    with P.trace.debug_checks(True):
        with pytest.raises(P.analysis.TraceVerificationError, match="buggy rewrite pass"):
            P.trace.mark(trc, "buggy rewrite pass")
    with P.trace.debug_checks(False):
        P.trace.mark(trc, "buggy rewrite pass")


def _drop_muls(P):
    def drop(trc):
        new = P.trace.from_trace(trc)
        new.bound_symbols = [b for b in trc.bound_symbols if b.sym.name != "mul"]
        return P.trace.mark(new, "Bad drop pass")

    return drop


@BOTH
def test_jit_debug_checks_catches_bad_transform(P):
    jf = P.jit(lambda x: P.clang.sum(P.clang.mul(x, x)), debug_checks=True, _trace_transforms=(_drop_muls(P),))
    with pytest.raises(P.analysis.TraceVerificationError) as ei:
        jf(np.ones((3, 3), np.float32))
    assert "Bad drop pass" in str(ei.value) and "ssa.use-before-def" in str(ei.value)


@BOTH
def test_jit_debug_checks_clean_run(P):
    jf = P.jit(lambda x, y: P.clang.mul(P.clang.sum(P.clang.add(x, y)), 2.0), debug_checks=True)
    assert float(np.asarray(jf(np.ones((3, 3), np.float32), np.ones((3, 3), np.float32)))) == pytest.approx(36.0)


@BOTH
def test_lint_collects_instead_of_raising(P):
    def f(x):
        P.clang.sub(x, x)  # dead on purpose
        return P.clang.sum(P.clang.mul(x, x))

    diags = P.examine.lint(f, np.ones((2, 2), np.float32), verbose=False, executors=P.executors)
    assert any(d.rule == "dce.dead-symbol" for d in diags) and not _errors(diags)


@BOTH
@pytest.mark.checks_smoke
def test_checks_smoke_elementwise_grad_autocast_rng(P, monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_CHECKS", "1")
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    w = np.random.RandomState(1).randn(8, 2).astype(np.float32)
    val, grads = P.value_and_grad(lambda x, w: P.ltorch.sum(P.ltorch.tanh(P.ltorch.matmul(x, w)) ** 2))(x, w)
    assert np.isfinite(float(np.asarray(val))) and len(grads) == 2
    out = P.jit(lambda x, w: P.ltorch.sum(P.ltorch.matmul(x, w)), autocast=True)(x, w)
    assert np.isfinite(float(np.asarray(out)))
    out = P.jit(lambda x: P.ltorch.sum(P.ltorch.dropout(x, p=0.5, training=True)))(np.ones((8, 8), np.float32))
    assert np.isfinite(float(np.asarray(out)))


@BOTH
@pytest.mark.checks_smoke
def test_checks_smoke_symbolic_values(P, monkeypatch):
    """``TestSymbolicChecksSmoke`` (tests/test_symbolic_cache.py:449)."""
    monkeypatch.setenv("THUNDER_TPU_CHECKS", "1")
    jf = P.jit(lambda x: P.clang.mean(P.clang.tanh(x)), cache="symbolic values", symbolic_dims={0: (0,)},
               buckets={"batch": "pow2"})
    for b in (5, 6, 7):
        assert np.isfinite(float(np.asarray(jf(np.ones((b, 4), np.float32)))))
    assert P.pkg.cache_info(jf)["compiles"] == 1


@BOTH
def test_lint_prints_cache_summary(P, capsys):
    """``test_lint_prints_cache_summary`` (tests/test_symbolic_cache.py:387)."""
    jf = P.jit(lambda x: P.clang.neg(x), executors=P.executors)
    x = np.ones((2,), np.float32)
    jf(x)
    diags = P.examine.lint(jf, x, executors=P.executors)
    out = capsys.readouterr().out
    assert "cache[constant_values]" in out and "1 compiles" in out
    assert not _errors(diags)


# =============================================================================
# tests/test_static_planner.py: liveness goldens, predicted OOM, donation
# =============================================================================


def _chain(P):
    """a, b inputs (64 B each); c = a+b; d = c*c; return d."""
    trc = P.trace.TraceCtx()
    with P.trace.tracectx(trc):
        a, b = _t(P), _t(P)
        trc.args = (a, b)
        c = P.clang.add(a, b)
        d = P.clang.mul(c, c)
        P.prims.python_return(d)
        trc.output = d
    return trc, a, b


@BOTH
def test_liveness_goldens(P):
    trc, a, b = _chain(P)
    plan = P.liveness.plan_liveness(trc, **P.exact)
    assert plan.input_bytes == 2 * 16 * F32 and plan.peak_bytes == 4 * 16 * F32
    assert plan.peak_sym == "mul" and plan.output_bytes == 16 * F32
    plan = P.liveness.plan_liveness(trc, donated=(a.name, b.name), **P.exact)
    assert plan.peak_bytes == 3 * 16 * F32 and plan.donated_names == (a.name, b.name)
    trc.tags["donated_inputs"] = (a.name, b.name)
    assert P.liveness.plan_liveness(trc, **P.exact).peak_bytes == 3 * 16 * F32


@BOTH
def test_liveness_views_dels_and_dtypes(P):
    trc = P.trace.TraceCtx()
    with P.trace.tracectx(trc):
        a = _t(P, (4, 4))
        trc.args = (a,)
        v = P.clang.reshape(a, (16,))
        c = P.clang.mul(v, v)
        P.prims.python_return(c)
        trc.output = c
    assert P.liveness.plan_liveness(trc, **P.exact).peak_bytes == 2 * 16 * F32  # the reshape is a view
    trc = P.trace.TraceCtx()
    with P.trace.tracectx(trc):
        a = _t(P, (4, 4))
        trc.args = (a,)
        v1 = P.clang.reshape(P.clang.add(a, a), (16,))
        v2 = P.clang.reshape(P.clang.add(a, a), (16,))
        out = P.clang.mul(v1, v2)
        P.prims.python_return(out)
        trc.output = out
    # a del after each view's reshape: the views still hold their buffers
    assert P.liveness.plan_liveness(P.passes.del_last_used(trc), **P.exact).peak_bytes == 4 * 16 * F32
    trc = P.trace.TraceCtx()
    with P.trace.tracectx(trc):
        a = _t(P, (4, 4), dtype=P.dtypes.bfloat16)
        trc.args = (a,)
        c = P.clang.add(a, a)
        P.prims.python_return(c)
        trc.output = c
    plan = P.liveness.plan_liveness(trc, **P.exact)
    assert plan.input_bytes == 16 * 2 and plan.peak_bytes == 2 * 16 * 2


@BOTH
def test_del_carrying_trace_matches_interval_analysis(P):
    def f(x):
        h = P.clang.tanh(P.clang.matmul(x, x))
        return P.clang.sum(P.clang.mul(h, h))

    _, comp = P.trace_program(f, (np.ones((8, 8), np.float32),), {})
    extrace = P.passes.transform_for_execution(P.common.cse(P.common.dce(comp)),
                                               P.extend.resolve_executors(P.executors))
    assert (P.liveness.plan_liveness(P.passes.del_last_used(extrace), **P.exact).peak_bytes
            == P.liveness.plan_liveness(extrace, **P.exact).peak_bytes)


def test_same_peak_bytes_as_the_jax_package_and_the_allocators_rounding():
    """The same program through both packages: the same peak with exact
    bytes; the port's default charges each buffer its 512-byte block."""
    def f(P):
        def g(x, w):
            return P.clang.sum(P.clang.tanh(P.clang.matmul(x, w)))
        return g

    x, w = np.ones((8, 16), np.float32), np.ones((16, 4), np.float32)
    jplan = jexamine.memory_report(f(JAX), x, w, executors=["jax"])
    tplan = texamine.memory_report(f(PORT), torch.from_numpy(x), torch.from_numpy(w), executors=["torch"])
    exact = tliveness.plan_liveness(tliveness.claimed_trace(f(PORT), (torch.from_numpy(x), torch.from_numpy(w)), {},
                                                            ["torch"]), block_bytes=1)
    assert exact.peak_bytes == jplan.peak_bytes > 0
    # inputs 512 + 256 B, each rounded to a block; the product (8, 4) and
    # tanh (8, 4) f32 128 B each, one block each; the 0-d sum one block.
    assert tplan.peak_bytes == 512 * 4 and tplan.peak_bytes >= tplan.input_bytes
    assert "predicted peak" in tplan.format()


@BOTH
def test_capacity_env_override(P, monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_HBM_BYTES", "12345")
    assert P.liveness.device_capacity_bytes() == 12345


def _biggish(P):
    trc = P.trace.TraceCtx()
    with P.trace.tracectx(trc):
        a = _t(P, (64, 64))
        trc.args = (a,)
        h = P.clang.mul(P.clang.tanh(P.clang.matmul(a, a)), P.clang.tanh(P.clang.matmul(a, a)))
        out = P.clang.sum(h)
        P.prims.python_return(out)
        trc.output = out
    return trc


@BOTH
@pytest.mark.parametrize("cap,fires", [("1024", True), (str(1 << 30), False)])
def test_predicted_oom_rule(P, monkeypatch, cap, fires):
    monkeypatch.setenv("THUNDER_TPU_HBM_BYTES", cap)
    found = _rules(P.analysis.verify(_biggish(P)), "mem.predicted-oom")
    assert len(found) == int(fires)
    if fires:
        assert found[0].severity == found[0].severity.WARNING and "exceeds" in found[0].message


def _donation_traces(P):
    out = {}
    trc, a, _ = _chain(P)
    trc.tags.update(donated_inputs=(a.name,), rerun_reads_inputs=True)
    out["use_after_donation"] = (trc, "donation.use-after-donation", 1)
    trc, a, _ = _chain(P)
    trc.tags["donated_inputs"] = (a.name,)
    out["donation_without_rerun"] = (trc, "donation.use-after-donation", 0)
    trc = P.trace.TraceCtx()
    with P.trace.tracectx(trc):
        a = _t(P, (4, 4))
        trc.args = (a,)
        v = P.clang.reshape(a, (16,))
        P.prims.python_return(v)
        trc.output = v
    trc.tags["donated_inputs"] = (a.name,)
    out["donated_output_view"] = (trc, "donation.donated-output", 1)

    def aliasing(trc, P):
        with P.trace.tracectx(trc):
            src, dst = _t(P, (4, 4)), _t(P, (4, 4))
            trc.args = (src, dst)
            written = _t(P, (4, 4))
        trc.bound_symbols.append(P.prims.copy_.bind(src, dst, output=written))
        with P.trace.tracectx(trc):
            return P.clang.reshape(dst, (16,))

    out["entry_aliasing_view"] = (_bind_trace(P, aliasing), "alias.entry-aliasing", 1)
    out["functionalized_inplace"] = (_bind_trace(P, _inplace_clean), "alias.entry-aliasing", 0)
    return out


@pytest.mark.parametrize("case", ["use_after_donation", "donation_without_rerun", "donated_output_view",
                                  "entry_aliasing_view", "functionalized_inplace"])
def test_donation_and_entry_aliasing_rules_as_in_the_jax_package(case):
    got = {}
    for P in (JAX, PORT):
        trc, rule, count = _donation_traces(P)[case]
        diags = P.analysis.verify(trc)
        assert len(_rules(diags, rule)) == count
        got[P.name] = _summary(d for d in diags if d.rule != "names.orphan")
    assert got["jax"] == got["port"]


def test_port_traces_carry_no_donation():
    """The port stages no donated input: its compiled traces carry no
    donation tag, and the donation rules find nothing on them."""
    g = tt.value_and_grad(lambda x: ttorch.sum(ttorch.tanh(x)), device="cpu")
    g(torch.ones(4, 4))
    trc = tt.last_traces(g)[-1]
    assert "donated_inputs" not in trc.tags
    assert [d for d in tanalysis.verify(trc) if d.rule.startswith("donation.")] == []


# =============================================================================
# The port's own constructs under debug_checks
# =============================================================================


@pytest.fixture(scope="module")
def tiny():
    cfg = tgpt.name_to_config("llama-hs100-tiny")
    params = tgpt.init_params(cfg, dtype=torch.bfloat16, seed=0, device="cpu")
    idx = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 128)))
    return cfg, params, idx


@pytest.mark.parametrize("executors", [["norm", "flash", "fused", "torch"], ["quant", "flash", "fused", "torch"]],
                         ids=["norm", "quant"])
def test_debug_checks_over_the_ports_kernel_claims(tiny, executors):
    cfg, params, idx = tiny
    ttrace.verify_seconds.clear()
    g = tt.value_and_grad(lambda p, i, t: tgpt.loss_fn(p, i, t, cfg), device="cpu", executors=executors,
                          debug_checks=True)
    loss, _ = g(params, idx, idx.roll(1, -1))
    plain = tt.value_and_grad(lambda p, i, t: tgpt.loss_fn(p, i, t, cfg), device="cpu", executors=executors)
    assert torch.equal(loss, plain(params, idx, idx.roll(1, -1))[0])
    assert len(ttrace.verify_seconds) >= 6  # acquisition, dce, cse, grad, claiming, dels
    assert not _errors(texamine.lint(g, params, idx, idx.roll(1, -1), verbose=False))


def test_debug_checks_over_vmap_masks_and_a_module(tiny):
    cfg, params, idx = tiny
    ttrace.verify_seconds.clear()
    vg = tt.vmap(tt.grad(lambda p, i, t: tgpt.loss_fn(p, i, t, cfg), device="cpu", debug_checks=True),
                 in_axes=(None, 0, 0))
    vg(params, idx[:, None], idx[:, None].roll(1, -1))
    assert len(ttrace.verify_seconds) >= 6
    q = torch.randn(2, 1, 2, 64, 16).to(torch.bfloat16)
    mask = torch.ones(64, 64, dtype=torch.bool).tril()[None, None]
    tt.vmap(lambda a, m: ttorch.scaled_dot_product_attention(a, a, a, attn_mask=m), in_axes=(0, None),
            device="cpu", debug_checks=True)(q, mask)
    ttrace.verify_seconds.clear()
    m = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 4))
    tm = tt.jit(m, device="cpu", debug_checks=True)
    x = torch.randn(3, 8, requires_grad=True)
    tm(x).sum().backward()
    assert x.grad is not None and len(ttrace.verify_seconds) >= 6  # the forward's and the backward's passes


def test_debug_checks_name_the_pass_of_a_bad_vmap_transform():
    with pytest.raises(tanalysis.TraceVerificationError, match="Bad drop pass"):
        tt.vmap(tt.jit(lambda x: tclang.sum(tclang.mul(x, x)), device="cpu", _trace_transforms=(_drop_muls(PORT),)),
                debug_checks=True)(torch.ones(3, 4))


def test_memory_report_of_a_split_step_keeps_saved_tensors_live(tiny):
    """The module frontend's forward and backward as one plan: the saved
    tensors live from the forward into the backward."""
    m = torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.Tanh(), torch.nn.Linear(256, 64))
    tm = tt.jit(m, device="cpu")
    x = torch.randn(32, 64, requires_grad=True)
    tm(x).sum().backward()
    fw, bw = tt.last_traces(tm)[-1], tt.last_backward_traces(tm)[-1]
    both = tanalysis.plan_fw_bw(fw, bw)
    alone = tanalysis.plan_liveness(bw)
    assert both.peak_bytes >= max(tanalysis.plan_liveness(fw).peak_bytes, alone.peak_bytes)


# =============================================================================
# The cost model's kernel rows
# =============================================================================


def test_cost_model_prices_the_kernel_claims_by_the_tables_formulas(tiny):
    cfg, params, idx = tiny
    g = tt.value_and_grad(lambda p, i, t: tgpt.loss_fn(p, i, t, cfg), device="cpu",
                          executors=["norm", "flash", "fused", "torch"])
    g(params, idx, idx.roll(1, -1))
    trc = tt.last_traces(g)[-1]
    tc = tanalysis.trace_cost(trc, "h100")
    kinds = tc.by_kind()
    assert {"sdpa", "rope", "cross_entropy", "norm", "matmul"} <= set(kinds)
    B, T, H, D = 2, 128, cfg.n_head, cfg.head_size
    pairs = B * T * (T + 1) // 2
    fwd = next(b for b in trc.bound_symbols if b.sym.name == "sdpa_fwd_res")
    (name, c), = tanalysis.kernel_costs(fwd)
    assert c.flops == 4.0 * H * D * pairs and c.dtype_class == "bf16"
    assert c.bytes_moved == (3 * B * H * T * D + B * H * T * D) * 2 + B * H * T * 4  # q, k, v, out bf16; lse f32
    rope = next(b for b in trc.bound_symbols if b.sym.name == "apply_rope")
    (_, c), = tanalysis.kernel_costs(rope)
    assert c.flops == 3.0 * B * H * T * D and c.bytes_moved == 2 * B * H * T * D * 2 + 2 * T * D * 2
    spec = tanalysis.DEVICE_SPECS["h100"]
    assert spec.peak_flops["bf16"] == 989e12 and spec.hbm_bw == 3.35e12 and spec.hbm_bytes == 80e9
    assert tanalysis.resolve_device_spec("cpu").name == "cpu"
    assert "cost model [h100" in tc.format()
    q = texamine.cost_report(lambda a, w: ttorch.linear(a, w), torch.ones(64, 128, dtype=torch.bfloat16),
                             torch.ones(32, 128, dtype=torch.bfloat16), executors=["quant", "torch"], device="h100")
    (row,) = q.rows
    assert row.kind == "int8_gemm" and row.flops == 2 * 64 * 32 * 128 + 4 * (64 * 128 + 32 * 128)


def test_hlo_report_names_its_roadmap_item():
    """ROADMAP item 13 is done: ``hlo_report`` audits the program, here the
    record of one eager call on the CPU (an unstaged entry)."""
    from thunder_tpu_torch.analysis.hlo_audit import HloScheduleReport

    rep = texamine.hlo_report(lambda x: x * 2, torch.ones(2), verbose=False)
    assert isinstance(rep, HloScheduleReport) and rep.source == "record" and rep.n_ops >= 1


@BOTH
def test_examine_fusions_and_alloc_memory(P):
    """``examine`` of a function, ``get_fusions`` and ``get_alloc_memory``
    over its trace, as in the JAX package."""
    def f(x, w):
        return P.ltorch.sum(P.ltorch.tanh(P.ltorch.matmul(x, w)))

    x, w = np.ones((8, 16), np.float32), np.ones((16, 4), np.float32)
    report = P.examine.examine(f, x, w)
    assert report["supported"] and report["unsupported_ops"] == [] and report["trace"] is not None
    _, comp = P.trace_program(f, (x, w), {})
    extrace = P.passes.del_last_used(P.passes.transform_for_execution(P.common.dce(comp),
                                                                      P.extend.resolve_executors(P.executors)))
    assert {name for name, _ in P.examine.get_fusions(extrace)} == set(P.executors)
    peak, timeline = P.examine.get_alloc_memory(extrace)
    assert timeline["inputs"] == (8 * 16 + 16 * 4) * F32 and peak >= timeline["inputs"] + 8 * 4 * F32
