"""Acquisition, ``jit``, core IR and transform cases of the JAX package's tests through both packages.

Each case is written once over a namespace ``P`` (``jit``, the language
modules, the package's top-level names, its api, IR and transform modules)
and run through the JAX package and through the port on the CPU:
- the sharp-edge reports (``tests/test_jit.py`` ``TestSharpEdges``,
  ``tests/test_acquisition.py`` ``test_captured_tensor_sharp_edge``,
  ``test_torch_tensor_closure_in_module``);
- the rest of ``tests/test_jit.py`` (caching and guards, numerics, RNG, the
  cache options ``"no caching"`` and ``"same input"``, the sharp-edge
  interceptors; its mutation-epilogue cases are in
  ``tests/test_torch_port_mutation.py``);
- ``tests/test_core.py`` (trace construction, dce/cse, type promotion, meta
  functions, a round trip through the terminal executor: the JAX package's
  ``"jax"``, the port's ``"torch"``);
- ``tests/test_transforms.py`` (autocast, rematerialization; ``TestRemat``
  resolves the default executors, ``extend.resolve_executors(None)``);
- ``TestFastPathDispatch`` and ``TestSameInputShortCircuit``
  (``tests/test_symbolic_cache.py:261-365``) and the trace dump
  (``tests/test_tooling.py:172``).
Where a case returns values, the two runs are held equal (f32, tolerance
1e-6: the same few elementwise products and sums; 1e-5 where a case sums
or multiplies matrices). A module's own parameters and buffers are inputs,
so ``jit(module, sharp_edges="error")`` of a module that closes over
nothing raises nothing.
"""

import contextlib
import dataclasses
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn as nn

import thunder_tpu
import thunder_tpu.api as japi
import thunder_tpu.clang as jclang
import thunder_tpu.core.prims as jprims
import thunder_tpu.torch as jtorch
from thunder_tpu.core import devices as jdevices
from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.core import proxies as jproxies
from thunder_tpu.core import trace as jtrace
from thunder_tpu.executors import passes as jpasses
from thunder_tpu import extend as jextend
from thunder_tpu.transforms import autocast as jautocast
from thunder_tpu.transforms import autodiff as jautodiff
from thunder_tpu.transforms import common as jcommon
from thunder_tpu.transforms import mincut as jmincut
from thunder_tpu.transforms import rematerialization as jremat

import thunder_tpu_torch as tt
import thunder_tpu_torch.api as tapi
import thunder_tpu_torch.clang as tclang
import thunder_tpu_torch.core.prims as tprims
import thunder_tpu_torch.torch as ttorch
from thunder_tpu_torch.core import devices as tdevices
from thunder_tpu_torch.core import dtypes as tdtypes
from thunder_tpu_torch.core import proxies as tproxies
from thunder_tpu_torch.core import trace as ttrace
from thunder_tpu_torch.executors import passes as tpasses
from thunder_tpu_torch import extend as textend
from thunder_tpu_torch.transforms import autocast as tautocast
from thunder_tpu_torch.transforms import autodiff as tautodiff
from thunder_tpu_torch.transforms import common as tcommon
from thunder_tpu_torch.transforms import mincut as tmincut
from thunder_tpu_torch.transforms import rematerialization as tremat

JAX = SimpleNamespace(name="jax", pkg=thunder_tpu, jit=thunder_tpu.jit, grad=thunder_tpu.grad,
                      value_and_grad=thunder_tpu.value_and_grad, clang=jclang, ltorch=jtorch, api=japi,
                      prims=jprims, devices=jdevices, dtypes=jdtypes, proxies=jproxies, trace=jtrace, passes=jpasses,
                      extend=jextend, autocast=jautocast, autodiff=jautodiff, common=jcommon, mincut=jmincut,
                      remat=jremat, terminal="jax", on_device=contextlib.nullcontext, asarray=lambda x: __import__("jax.numpy").numpy.asarray(x),
                      ones_like=lambda x: __import__("jax.numpy").numpy.ones_like(x))
PORT = SimpleNamespace(name="port", pkg=tt, jit=lambda f, **k: tt.jit(f, device="cpu", **k),
                       grad=lambda f, **k: tt.grad(f, device="cpu", **k),
                       value_and_grad=lambda f, **k: tt.value_and_grad(f, device="cpu", **k), clang=tclang,
                       ltorch=ttorch, api=tapi, prims=tprims, devices=tdevices, dtypes=tdtypes, proxies=tproxies,
                       trace=ttrace, passes=tpasses, extend=textend, autocast=tautocast, autodiff=tautodiff,
                       common=tcommon, mincut=tmincut, remat=tremat, terminal="torch",
                       on_device=lambda: tdevices.default_device("cpu"), asarray=torch.as_tensor,
                       ones_like=torch.ones_like)
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=lambda P: P.name)


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class _Opaque:
    pass


def _opaque_leaf_fn(P):
    def fn(a, flag):
        return P.clang.mul(a, 2.0)

    return fn


# =============================================================================
# TestSharpEdges (tests/test_jit.py:233-262): an input leaf the prologue
# cannot guard
# =============================================================================


def sharp_edges_allow_default(P):
    a = _r(3, seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no warning, no raise
        out = P.jit(_opaque_leaf_fn(P))(a, _Opaque())
    return _np(out)


def sharp_edges_warn(P):
    a = _r(3, seed=1)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = P.jit(_opaque_leaf_fn(P), sharp_edges="warn")(a, _Opaque())
    hits = [x for x in w if issubclass(x.category, P.pkg.ThunderSharpEdgeWarning)]
    assert hits, [str(x.message) for x in w]
    assert "cannot be guarded" in str(hits[0].message)
    return _np(out)


def sharp_edges_error(P):
    a = _r(3, seed=1)
    with pytest.raises(P.pkg.ThunderSharpEdgeError, match="cannot be guarded"):
        P.jit(_opaque_leaf_fn(P), sharp_edges="error")(a, _Opaque())


# =============================================================================
# tests/test_acquisition.py:321-370: a tensor captured from the enclosing scope
# =============================================================================


def captured_tensor_sharp_edge(P):
    w = _r(3, seed=40)

    def f(x):
        return P.ltorch.sum(x * w)

    with pytest.raises(P.pkg.ThunderSharpEdgeError, match="captured concrete tensor"):
        P.jit(f, sharp_edges="error")(_r(3, seed=41))
    with pytest.warns(UserWarning, match="captured concrete tensor"):
        P.jit(f, sharp_edges="warn")(_r(3, seed=41))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # allow: bakes silently
        out = P.jit(f)(_r(3, seed=41))
    assert np.isfinite(float(_np(out)))
    return _np(out)


def captured_torch_tensor_sharp_edge(P):
    """The same report for a captured torch tensor (the port's frontend
    lifts torch and numpy values alike)."""
    w = torch.from_numpy(_r(3, seed=42))

    def f(x):
        return P.ltorch.sum(x * w)

    with pytest.raises(P.pkg.ThunderSharpEdgeError, match=r"captured concrete tensor \(shape \(3,\)\)"):
        P.jit(f, sharp_edges="error")(_r(3, seed=43))
    return _np(P.jit(f)(_r(3, seed=43)))


def torch_tensor_closure_in_module(P):
    mask = torch.tril(torch.ones(6, 6))

    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(6, 6)

        def forward(self, x):
            return (self.fc(x) * mask).sum()  # closes over a raw tensor

    torch.manual_seed(7)
    m = M().eval()
    tm = P.jit(m)
    x = torch.randn(6, 6)
    got = tm(x)
    torch.testing.assert_close(torch.as_tensor(_np(got)), m(x).detach(), rtol=1e-3, atol=1e-4)
    return _np(got)


CASES = [sharp_edges_allow_default, sharp_edges_warn, sharp_edges_error, captured_tensor_sharp_edge,
         captured_torch_tensor_sharp_edge, torch_tensor_closure_in_module]


@BOTH
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_case(case, P):
    case(P)


@pytest.mark.parametrize("case", [c for c in CASES if c is not sharp_edges_error], ids=lambda c: c.__name__)
def test_case_results_agree(case):
    np.testing.assert_allclose(case(PORT), case(JAX), rtol=1e-6, atol=1e-6)


# =============================================================================
# tests/test_jit.py: caching, guards, numerics, RNG, cache options
# =============================================================================


def _a(*shape, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def elementwise_add_mul(P):
    a, b = _a(4, 5, seed=1), _a(4, 5, seed=2)
    out = _np(P.jit(lambda x, y: P.clang.mul(P.clang.add(x, y), 2.0))(a, b))
    np.testing.assert_allclose(out, (a + b) * 2, rtol=1e-5)
    return out


def cache_hit_on_same_metadata(P):
    jf = P.jit(lambda x: P.clang.sin(x))
    a = _a(3, seed=3)
    jf(a)
    out = _np(jf(a * 2))
    assert P.pkg.cache_misses(jf) == 1 and P.pkg.cache_hits(jf) == 1
    return out


def cache_miss_on_new_shape(P):
    jf = P.jit(lambda x: P.clang.sin(x))
    jf(_a(3, seed=4))
    jf(_a(4, seed=5))
    assert P.pkg.cache_misses(jf) == 2
    jf(_a(3, seed=6))
    assert P.pkg.cache_hits(jf) == 1


def cache_miss_on_new_dtype(P):
    jf = P.jit(lambda x: P.clang.add(x, x))
    jf(_a(3, seed=7))
    jf(_a(3, seed=7, dtype=np.float64))
    assert P.pkg.cache_misses(jf) == 2


def number_guard(P):
    jf = P.jit(lambda x, n: P.clang.mul(x, n))
    a = _a(3, seed=8)
    out2, out3 = _np(jf(a, 2.0)), _np(jf(a, 3.0))
    np.testing.assert_allclose(out2, a * 2, rtol=1e-5)
    np.testing.assert_allclose(out3, a * 3, rtol=1e-5)
    assert P.pkg.cache_misses(jf) == 2
    return np.stack([out2, out3])


def nested_container_inputs(P):
    def foo(pair, cfg):
        a, b = pair
        return P.clang.add(P.clang.mul(a, cfg["scale"]), b)

    a, b = _a(2, 3, seed=9), _a(2, 3, seed=10)
    out = _np(P.jit(foo)((a, b), {"scale": 3.0}))
    np.testing.assert_allclose(out, a * 3 + b, rtol=1e-5)
    return out


def python_control_flow_specializes(P):
    def foo(a, flag):
        return P.clang.sin(a) if flag else P.clang.cos(a)

    jf = P.jit(foo)
    a = _a(3, seed=11)
    np.testing.assert_allclose(_np(jf(a, True)), np.sin(a), rtol=1e-5)
    np.testing.assert_allclose(_np(jf(a, False)), np.cos(a), rtol=1e-5)
    assert P.pkg.cache_misses(jf) == 2


def torch_tensor_inputs_round_trip(P):
    a, b = torch.randn(4, 4), torch.randn(4, 4)
    out = P.jit(lambda x, y: P.clang.add(x, y))(a, b)
    assert isinstance(out, torch.Tensor)
    torch.testing.assert_close(out, a + b, rtol=1e-5, atol=1e-5)


def bfloat16_round_trip(P):
    a = torch.randn(8, 8, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    out = P.jit(lambda x: P.clang.mul(x, 2.0))(a)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, a * 2)
    return _np(out)


def rng_functionalization(P):
    def foo(a):
        return P.clang.add(a, P.clang.uniform((3, 3), 0.0, 1.0, device=P.devices.Device(), dtype=None))

    jf = P.jit(foo)
    a = np.zeros((3, 3), dtype=np.float32)
    out1, out2 = _np(jf(a)), _np(jf(a))
    assert (out1 >= 0).all() and (out1 <= 1).all()
    assert not np.allclose(out1, out2)
    assert "rng_key" in P.pkg.last_traces(jf)[-1].python()


def reductions_match_numpy(P):
    def foo(a):
        return (P.clang.sum(a, (1,)), P.clang.mean(a, (0,)), P.clang.amax(a, (0, 1)),
                P.clang.var(a, (1,), correction=1))

    a = np.random.RandomState(11).randn(4, 6).astype(np.float32)
    s_, m, mx, v = (_np(x) for x in P.jit(foo)(a))
    np.testing.assert_allclose(s_, a.sum(1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m, a.mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mx, a.max(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v, a.var(1, ddof=1), rtol=1e-4, atol=1e-6)
    return np.concatenate([s_, m, mx.ravel(), v])


def matmul_linear(P):
    x, w, b = _a(8, 16, seed=12), _a(32, 16, seed=13), _a(32, seed=14)
    out = _np(P.jit(lambda x, w, b: P.clang.linear(x, w, b))(x, w, b))
    np.testing.assert_allclose(out, x @ w.T + b, rtol=1e-4, atol=1e-4)
    return out


def no_caching_option(P):
    jf = P.jit(lambda x: P.clang.neg(x), cache="no caching")
    a = _a(3, seed=15)
    jf(a)
    out = _np(jf(a))
    assert P.pkg.cache_misses(jf) == 2 and P.pkg.cache_hits(jf) == 0
    assert P.pkg.compile_stats(jf).cache_entries == []
    return out


def structure_change_is_guard_miss(P):
    jf = P.jit(lambda pair, cfg: P.clang.add(P.clang.mul(pair[0], cfg["scale"]), pair[-1]))
    a, b = _a(2, 3, seed=16), _a(2, 3, seed=17)
    jf((a, b), {"scale": 3.0})
    np.testing.assert_allclose(_np(jf((a, b, b), {"scale": 3.0})), a * 3 + b, rtol=1e-5)
    np.testing.assert_allclose(_np(jf((a, b), {"scale": 3.0, "extra": 1.0})), a * 3 + b, rtol=1e-5)
    assert P.pkg.cache_misses(jf) == 3


def prologue_bug_propagates(P):
    jf = P.jit(lambda x: P.clang.neg(x))
    a = _a(3, seed=18)
    jf(a)
    cs = P.pkg.compile_stats(jf)

    def broken_prologue(*args, **kwargs):
        raise RuntimeError("genuine guard-code bug")

    cs.cache_entries[0] = dataclasses.replace(cs.cache_entries[0], prologue_fn=broken_prologue)
    cs.fast_cache.clear()  # through the prologue-probing slow tier
    with pytest.raises(RuntimeError, match="genuine guard-code bug"):
        jf(a)


def _random_fn(P):
    def fn(x):
        import random

        return P.clang.mul(x, random.random())

    return fn


def random_error(P):
    with pytest.raises(P.pkg.ThunderSharpEdgeError, match="random.random"):
        P.jit(_random_fn(P), sharp_edges="error")(_a(3, seed=19))


def random_warn(P):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        P.jit(_random_fn(P), sharp_edges="warn")(_a(3, seed=19))
    assert any("random.random" in str(x.message) for x in w)


def random_allow_bakes(P):
    a = np.ones(3, dtype=np.float32)
    jf = P.jit(_random_fn(P))
    np.testing.assert_array_equal(_np(jf(a)), _np(jf(a)))


def time_error(P):
    import time as _time

    with pytest.raises(P.pkg.ThunderSharpEdgeError, match="time.time"):
        P.jit(lambda x: P.clang.add(x, _time.time()), sharp_edges="error")(np.ones(3, dtype=np.float32))


def _environ_fn(P):
    import os

    return lambda x: P.clang.mul(x, float(os.environ.get("THUNDER_TEST_SCALE", "2.0")))


def environ_error(P):
    with pytest.raises(P.pkg.ThunderSharpEdgeError, match="os.environ"):
        P.jit(_environ_fn(P), sharp_edges="error")(np.ones(3, dtype=np.float32))


def environ_allow_executes(P):
    a = np.ones(3, dtype=np.float32)
    out = _np(P.jit(_environ_fn(P))(a))
    np.testing.assert_allclose(out, a * 2.0)
    return out


def same_input_guards_skipped(P):
    """``TestSameInputCache`` (tests/test_jit.py:329-358)."""
    a = np.ones(3, dtype=np.float32)
    jf = P.jit(lambda x, n: P.clang.mul(x, n), cache="same input")
    np.testing.assert_allclose(_np(jf(a, 2.0)), a * 2.0)
    np.testing.assert_allclose(_np(jf(a, 3.0)), a * 2.0)  # the first specialization, unchecked
    assert jf._lc_cs.cache_misses == 1 and jf._lc_cs.cache_hits == 1


def constant_values_reguards(P):
    a = np.ones(3, dtype=np.float32)
    jf = P.jit(lambda x, n: P.clang.mul(x, n))
    np.testing.assert_allclose(_np(jf(a, 2.0)), a * 2.0)
    np.testing.assert_allclose(_np(jf(a, 3.0)), a * 3.0)
    assert jf._lc_cs.cache_misses == 2


# =============================================================================
# tests/test_symbolic_cache.py:261-365: the O(1) dispatch and "same input"
# =============================================================================


def warm_entry_runs_no_prologue(P):
    jf = P.jit(lambda x: P.clang.neg(x))
    for s_ in [(2,), (3,), (4,)]:
        jf(np.ones(s_, np.float32))
    cs = P.pkg.compile_stats(jf)
    before = cs.prologue_runs
    jf(np.ones((2,), np.float32))  # the oldest entry, its key learned when it compiled
    assert P.pkg.compile_stats(jf).prologue_runs == before
    info = P.pkg.cache_info(jf)
    assert info["fast_hits"] >= 1 and info["entries"][0]["fast_hits"] >= 1


def slow_path_teaches_fast_path(P):
    jf = P.jit(lambda x: P.clang.neg(x))
    jf(np.ones((2,), np.float32))
    cs = P.pkg.compile_stats(jf)
    cs.fast_cache.clear()
    jf(np.ones((2,), np.float32))
    assert P.pkg.cache_info(jf)["slow_hits"] == 1
    p = cs.prologue_runs
    jf(np.ones((2,), np.float32))
    assert cs.prologue_runs == p


def number_type_distinguished(P):
    jf = P.jit(lambda x, n: P.clang.mul(x, n))
    x = np.ones((2,), np.float32)
    jf(x, 1)
    jf(x, True)
    assert P.pkg.cache_misses(jf) == 2
    jf(x, 1)
    jf(x, True)
    assert P.pkg.cache_misses(jf) == 2 and P.pkg.cache_hits(jf) == 2


def _branchy(P):
    def f(x):
        if x.sum() > 0:
            return P.clang.mul(x, 2.0)
        return P.clang.mul(x, -1.0)

    return f


def value_guards_still_checked_on_fast_hit(P):
    jf = P.jit(_branchy(P))
    pos, neg = np.ones((3,), np.float32), -np.ones((3,), np.float32)
    assert float(_np(jf(pos)).sum()) == 6.0
    assert float(_np(jf(neg)).sum()) == 3.0
    assert float(_np(jf(pos)).sum()) == 6.0
    assert float(_np(jf(neg)).sum()) == 3.0


def same_input_uses_newest_entry_without_probing(P):
    jf = P.jit(_branchy(P), cache="same input")
    pos, neg = np.ones((3,), np.float32), -np.ones((3,), np.float32)
    jf(pos)
    cs = P.pkg.compile_stats(jf)
    assert cs.cache_misses == 1 and len(cs.cache_entries) == 1
    out = _np(jf(neg))
    assert cs.cache_misses == 1 and len(cs.cache_entries) == 1
    np.testing.assert_allclose(out, neg * 2.0)
    assert cs.cache_hits == 1 and cs.prologue_runs == 2


def same_input_still_skips_metadata_guards(P):
    jf = P.jit(lambda x: P.clang.neg(x), cache="same input")
    jf(np.ones((3,), np.float32))
    jf(np.ones((3,), np.float64))
    cs = P.pkg.compile_stats(jf)
    assert cs.cache_misses == 1 and cs.cache_hits == 1


def execution_callback_file(P, tmp_path):
    """tests/test_tooling.py:172."""
    path = str(tmp_path / f"trace_{P.name}.py")
    P.pkg.set_execution_callback_file(path)
    try:
        P.jit(lambda x: P.ltorch.sum(x * 2.0))(_a(4, 4, seed=20))
    finally:
        P.pkg.set_execution_callback_file(None)
    src = open(path).read()
    assert "def computation" in src and "mul" in src


# =============================================================================
# tests/test_core.py
# =============================================================================


def _add_mul_trace(P):
    trc = P.trace.TraceCtx()
    with P.trace.tracectx(trc):
        a = P.proxies.TensorProxy(shape=(4, 5), dtype=P.dtypes.float32, device=P.devices.Device("cpu"))
        b = P.proxies.TensorProxy(shape=(4, 5), dtype=P.dtypes.float32, device=P.devices.Device("cpu"))
        trc.args = (a, b)
        d = P.clang.mul(P.clang.add(a, b), P.clang.add(a, b))
        P.clang.sub(a, b)  # dead
        P.prims.python_return(d)
        trc.output = d
    return trc


def trace_records_bsyms(P):
    names = [b.sym.name for b in _add_mul_trace(P).bound_symbols]
    assert "add" in names and "mul" in names and "python_return" in names


def trace_prints_as_python(P):
    src = _add_mul_trace(P).python()
    assert "def computation(t0, t1):" in src and "prims.add(t0, t1)" in src and "return" in src
    compile(src, "<test>", "exec")


def proxy_names_unique(P):
    trc = P.trace.TraceCtx()
    with P.trace.tracectx(trc):
        ps = [P.proxies.TensorProxy(shape=(1,), dtype=P.dtypes.float32, device=P.devices.cpu) for _ in range(10)]
    assert len({p.name for p in ps}) == 10


def dce_removes_dead_code(P):
    trc = _add_mul_trace(P)
    trc2 = P.common.dce(trc)
    assert len(trc2.bound_symbols) < len(trc.bound_symbols)
    assert all(b.sym.name != "sub" for b in trc2.bound_symbols)


def cse_merges_duplicates(P):
    trc = P.trace.TraceCtx()
    with P.trace.tracectx(trc):
        a = P.proxies.TensorProxy(shape=(3,), dtype=P.dtypes.float32, device=P.devices.cpu)
        trc.args = (a,)
        z = P.clang.add(P.clang.sin(a), P.clang.sin(a))
        P.prims.python_return(z)
        trc.output = z
    assert sum(1 for b in P.common.cse(trc).bound_symbols if b.sym.name == "sin") == 1


def provenance_recorded(P):
    assert "Dead Code Elimination" in repr(P.common.dce(_add_mul_trace(P)).provenance)


def type_promotion(P):
    d = P.dtypes
    for da, db, want in [(d.float32, d.bfloat16, d.float32), (d.bfloat16, d.float16, d.float32),
                         (d.int64, d.float32, d.float32), (d.int32, d.int64, d.int64), (d.bool8, d.int8, d.int8)]:
        with P.trace.tracectx(P.trace.TraceCtx()):
            a = P.proxies.TensorProxy(shape=(2,), dtype=da, device=P.devices.cpu)
            b = P.proxies.TensorProxy(shape=(2,), dtype=db, device=P.devices.cpu)
            assert P.clang.add(a, b).dtype == want
    with P.trace.tracectx(P.trace.TraceCtx()):
        a = P.proxies.TensorProxy(shape=(2,), dtype=d.bfloat16, device=P.devices.cpu)
        assert P.clang.add(a, 2.0).dtype == d.bfloat16 and P.clang.add(a, 2).dtype == d.bfloat16
        i = P.proxies.TensorProxy(shape=(2,), dtype=d.int32, device=P.devices.cpu)
        assert P.clang.mul(i, 2.0).dtype == d.float32


def meta_functions(P):
    with P.trace.tracectx(P.trace.TraceCtx()):
        T = lambda *s: P.proxies.TensorProxy(shape=s, dtype=P.dtypes.float32, device=P.devices.cpu)  # noqa: E731
        assert P.prims.matmul(T(8, 4, 5), T(5, 7)).shape == (8, 4, 7)
        with pytest.raises(RuntimeError):
            P.prims.matmul(T(4, 5), T(4, 5))
        assert P.clang.reshape(T(4, 6), (2, -1)).shape == (2, 12)
        a = T(4, 6, 8)
        assert P.clang.getitem(a, 0).shape == (6, 8)
        assert P.clang.getitem(a, (slice(1, 3),)).shape == (2, 6, 8)
        assert P.clang.getitem(a, (None, Ellipsis, 0)).shape == (1, 4, 6)
        assert P.proxies.NumberProxy(3, python_type=int) + 4 == 7


def trace_callable_executes(P):
    trc = P.common.dce(_add_mul_trace(P))
    fn = P.passes.transform_for_execution(trc, (P.extend.get_executor(P.terminal),)).python_callable()
    a, b = _a(4, 5, seed=21), _a(4, 5, seed=22)
    out = _np(fn(P.asarray(a), P.asarray(b)))
    np.testing.assert_allclose(out, (a + b) * (a + b), rtol=1e-5)
    return out


def cse_preserves_random_ops(P):
    def f(a):
        u1 = P.clang.uniform((4,), 0.0, 1.0, device=a.device, dtype=a.dtype)
        u2 = P.clang.uniform((4,), 0.0, 1.0, device=a.device, dtype=a.dtype)
        return P.clang.add(P.clang.add(u1, u2), a)

    _, comp = P.api.trace_program(f, (_a(4, seed=23),), {})
    assert comp.python().count("uniform") == P.common.cse(P.common.dce(comp)).python().count("uniform") == 2


def cse_no_commutative_rewrite(P):
    x, y = _a(3, seed=24), _a(3, seed=25)
    _, comp = P.api.trace_program(lambda a, b: P.clang.mul(P.clang.add(a, b), P.clang.add(a, b)), (x, y), {})
    assert P.common.cse(P.common.dce(comp)).python().count("add") == 1
    _, comp2 = P.api.trace_program(lambda a, b: P.clang.mul(P.clang.add(a, b), P.clang.add(b, a)), (x, y), {})
    assert P.common.cse(P.common.dce(comp2)).python().count("add") == 2


def dce_keeps_outputs_and_inputs_signature(P):
    def f(a, b):
        P.clang.mul(a, 100.0)  # dead on purpose
        return P.clang.add(a, b)

    x = _a(3, seed=26)
    _, comp = P.api.trace_program(f, (x, x), {})
    out = P.common.dce(comp)
    assert "100.0" not in out.python() and len(out.args) == len(comp.args)


def provenance_chain_across_passes(P):
    jf = P.jit(lambda a: P.ltorch.sum(P.ltorch.tanh(a) * 2.0))
    jf(_a(3, 3, seed=27))
    provs = [str(t.provenance) for t in P.pkg.last_traces(jf) if t.provenance is not None]
    assert len(P.pkg.last_traces(jf)) >= 3
    assert any("Dead Code Elimination" in p for p in provs)
    assert any("Common Subexpression Elimination" in p for p in provs)


def from_bsym_swap_proxies_rewrites_args(P):
    x = _a(3, seed=28)
    _, comp = P.api.trace_program(lambda a, b: P.clang.add(a, b), (x, x), {})
    add_bsym = next(b for b in comp.bound_symbols if b.sym.name == "add")
    a0, b0 = comp.args
    swapped = add_bsym.from_bsym_swap_proxies({P.proxies.variableify(a0): b0}, skip_output=True)
    assert [p.name for p in swapped.flat_proxy_args] == [b0.name, b0.name]


# =============================================================================
# tests/test_transforms.py: autocast and rematerialization
# =============================================================================


def _t(*shape, seed=0):
    return np.random.RandomState(seed + sum(shape)).randn(*shape).astype(np.float32)


def autocast_linear_runs_in_bf16(P):
    f = lambda x, w: P.ltorch.sum(P.ltorch.linear(x, w))  # noqa: E731
    x, w = _t(4, 8), _t(6, 8, seed=1)
    jf = P.jit(f, autocast="bfloat16")
    out = float(_np(jf(x, w)))
    assert "bfloat16" in P.pkg.last_traces(jf)[-1].python()
    np.testing.assert_allclose(out, float(_np(P.jit(f)(x, w))), rtol=2e-2)
    return np.float32(out)


def autocast_with_grad(P):
    def loss(x, w):
        return P.ltorch.sum(P.ltorch.gelu(P.ltorch.linear(x, w)) ** 2.0)

    x, w = _t(4, 8), _t(6, 8, seed=1)
    l1, g1 = P.value_and_grad(loss, autocast="bfloat16")(x, w)
    l2, g2 = P.value_and_grad(loss)(x, w)
    np.testing.assert_allclose(float(_np(l1)), float(_np(l2)), rtol=5e-2)
    for a, b in zip(g1, g2):
        a, b = _np(a), _np(b)
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max() + 1e-3


def autocast_casts_matmul_inputs_only(P):
    def f(x, w):
        return P.ltorch.sum(P.ltorch.exp(P.ltorch.linear(x, w) * 0.01))

    _, comp = P.api.trace_program(f, (_t(4, 8), _t(6, 8, seed=1)), {})
    src = P.autocast.autocast(P.common.dce(comp)).python()
    assert "bfloat16" in src and src.count("convert_element_type") >= 2


def _split(P, fn, *args, remat: bool):
    with P.on_device():
        _, comp = P.api.trace_program(fn, args, {})
    fw, bw = P.autodiff.forward_and_backward_from_trace(P.common.dce(comp))
    if remat:
        fw, bw = P.remat.rematerialize_forward_and_backward(fw, bw)
    return fw, bw


def _run_split(P, fw, bw, x, w):
    exs = P.extend.resolve_executors(None)
    out, saved = P.passes.transform_for_execution(fw, exs).python_callable()(P.asarray(x), P.asarray(w))
    return out, P.passes.transform_for_execution(bw, exs).python_callable()(*saved, P.ones_like(out))


def remat_saved_shrinks_and_grads_match(P):
    def loss(x, w):
        b = P.ltorch.tanh(P.ltorch.gelu(P.ltorch.linear(x, w)))
        return P.ltorch.sum(b * b)

    x, w = _t(4, 8), _t(16, 8, seed=1)
    fw0, bw0 = _split(P, loss, x, w, remat=False)
    fw1, bw1 = _split(P, loss, x, w, remat=True)
    assert len(fw1.tags["saved_for_backward"]) < len(fw0.tags["saved_for_backward"])
    (out0, g0), (out1, g1) = _run_split(P, fw0, bw0, x, w), _run_split(P, fw1, bw1, x, w)
    np.testing.assert_allclose(float(_np(out0)), float(_np(out1)), rtol=1e-6)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    return np.concatenate([_np(g).ravel() for g in g1])


def remat_matmul_results_stay_saved(P):
    def loss(x, w1, w2):
        h3 = P.ltorch.linear(P.ltorch.gelu(P.ltorch.linear(x, w1)), w2)
        return P.ltorch.sum(h3 * h3)

    args = (_t(4, 8), _t(16, 8, seed=1), _t(4, 16, seed=2))
    _, bw = _split(P, loss, *args, remat=True)
    _, bw0 = _split(P, loss, *args, remat=False)
    count = lambda src: src.count("linear") + src.count("matmul")  # noqa: E731
    assert count(bw.python()) == count(bw0.python())


def remat_mincut_shares_chain_prefix(P):
    def loss(x, w):
        c = P.ltorch.exp(P.ltorch.linear(x, w)[:, :8])
        return P.ltorch.sum(c * P.ltorch.tanh(c))

    x, w = _t(4, 8), _t(64, 8, seed=1)
    fw0, bw0 = _split(P, loss, x, w, remat=False)
    fw1, bw1 = _split(P, loss, x, w, remat=True)
    assert len(fw1.tags["saved_for_backward"]) < len(fw0.tags["saved_for_backward"])
    (out0, g0), (out1, g1) = _run_split(P, fw0, bw0, x, w), _run_split(P, fw1, bw1, x, w)
    np.testing.assert_allclose(float(_np(out0)), float(_np(out1)), rtol=1e-6)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    assert P.mincut.using_native()


def module_remat_grads_match(P):
    torch.manual_seed(0)

    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1, self.fc2 = nn.Linear(8, 32), nn.Linear(32, 4)

        def forward(self, x):
            return self.fc2(torch.nn.functional.gelu(self.fc1(x)))

    m1, m2 = M(), M()
    m2.load_state_dict(m1.state_dict())
    x = torch.randn(4, 8)
    P.jit(m1, rematerialize=True)(x).pow(2).sum().backward()
    P.jit(m2, rematerialize=False)(x).pow(2).sum().backward()
    for (n, p1), (_, p2) in zip(m1.named_parameters(), m2.named_parameters()):
        np.testing.assert_allclose(p1.grad.numpy(), p2.grad.numpy(), rtol=1e-3, atol=1e-4, err_msg=n)


MORE_CASES = [
    elementwise_add_mul, cache_hit_on_same_metadata, cache_miss_on_new_shape, cache_miss_on_new_dtype, number_guard,
    nested_container_inputs, python_control_flow_specializes, torch_tensor_inputs_round_trip, bfloat16_round_trip,
    rng_functionalization, reductions_match_numpy, matmul_linear, no_caching_option, structure_change_is_guard_miss,
    prologue_bug_propagates, random_error, random_warn, random_allow_bakes, time_error, environ_error,
    environ_allow_executes, same_input_guards_skipped, constant_values_reguards, warm_entry_runs_no_prologue,
    slow_path_teaches_fast_path, number_type_distinguished, value_guards_still_checked_on_fast_hit,
    same_input_uses_newest_entry_without_probing, same_input_still_skips_metadata_guards, trace_records_bsyms,
    trace_prints_as_python, proxy_names_unique, dce_removes_dead_code, cse_merges_duplicates, provenance_recorded,
    type_promotion, meta_functions, trace_callable_executes, cse_preserves_random_ops, cse_no_commutative_rewrite,
    dce_keeps_outputs_and_inputs_signature, provenance_chain_across_passes, from_bsym_swap_proxies_rewrites_args,
    autocast_linear_runs_in_bf16, autocast_with_grad, autocast_casts_matmul_inputs_only,
    remat_saved_shrinks_and_grads_match, remat_matmul_results_stay_saved, remat_mincut_shares_chain_prefix,
    module_remat_grads_match,
]
MORE_VALUED = [elementwise_add_mul, cache_hit_on_same_metadata, number_guard, nested_container_inputs,
               bfloat16_round_trip, reductions_match_numpy, matmul_linear, no_caching_option, environ_allow_executes,
               trace_callable_executes, remat_saved_shrinks_and_grads_match]


@BOTH
@pytest.mark.parametrize("case", MORE_CASES, ids=lambda c: c.__name__)
def test_more_case(case, P):
    case(P)


@BOTH
def test_execution_callback_file(P, tmp_path):
    execution_callback_file(P, tmp_path)


@pytest.mark.parametrize("case", MORE_VALUED, ids=lambda c: c.__name__)
def test_more_case_results_agree(case):
    np.testing.assert_allclose(case(PORT), case(JAX), rtol=1e-5, atol=1e-5)


# =============================================================================
# The port alone
# =============================================================================


class _WithParamsAndBuffers(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(6, 6)
        self.norm = nn.LayerNorm(6)
        self.register_buffer("gain", torch.linspace(0.5, 1.5, 6))

    def forward(self, x):
        return (self.norm(self.fc(x)) * self.gain).sum()


@pytest.mark.parametrize("policy", ["error", "warn"])
def test_module_params_and_buffers_are_no_sharp_edge(policy):
    torch.manual_seed(3)
    m = _WithParamsAndBuffers()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tm = tt.jit(m, sharp_edges=policy, device="cpu")
        for seed in (0, 1):
            x = torch.randn(4, 6, generator=torch.Generator().manual_seed(seed))
            torch.testing.assert_close(tm(x), m(x), rtol=1e-5, atol=1e-5)


def test_module_closure_is_reported_under_error():
    mask = torch.tril(torch.ones(6, 6))

    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(6, 6)

        def forward(self, x):
            return (self.fc(x) * mask).sum()

    with pytest.raises(tt.ThunderSharpEdgeError, match=r"captured concrete tensor \(shape \(6, 6\)\)"):
        tt.jit(M(), sharp_edges="error", device="cpu")(torch.randn(6, 6))


def test_captured_tensor_reported_once_per_object():
    """Two uses of one captured array bake one constant and report once."""
    w = _r(3, seed=44)

    def f(x):
        return ttorch.sum(x * w + w)

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tt.jit(f, sharp_edges="warn", device="cpu")(_r(3, seed=45))
    assert sum("captured concrete tensor" in str(x.message) for x in rec) == 1


def test_guardable_leaves_are_no_sharp_edge():
    """Tensors, numbers, strings, None and containers of them are guarded:
    nothing to report under "error"."""

    def f(a, n, s, z, d):
        return tclang.mul(d["x"][0], n) if s == "mul" and z is None else a

    jf = tt.jit(f, sharp_edges="error", device="cpu")
    out = jf(_r(3, seed=2), 3.0, "mul", None, {"x": [_r(3, seed=3)]})
    np.testing.assert_allclose(_np(out), 3.0 * _r(3, seed=3), rtol=1e-6)


@pytest.mark.parametrize("name", ["ThunderSharpEdgeError", "ThunderSharpEdgeWarning", "SHARP_EDGES_OPTIONS",
                                  "CACHE_OPTIONS"])
def test_top_level_names_match_the_jax_package(name):
    ours, theirs = getattr(tt, name), getattr(thunder_tpu, name)
    assert name in tt.__all__
    if issubclass(theirs, BaseException):
        assert issubclass(ours, tuple(c for c in theirs.__mro__[1:] if c.__module__ == "builtins"))
    else:
        assert [m.name for m in ours] == [m.name for m in theirs]


def test_cache_option_members_are_taken_by_jit():
    """Every member and its string, in any case; an unknown option raises."""
    x = _r(3, seed=5)
    for member in tt.CACHE_OPTIONS:
        for opt in (member, member.value, member.value.upper()):
            jf = tt.jit(lambda a: tclang.mul(a, 2.0), cache=opt, device="cpu")
            np.testing.assert_allclose(_np(jf(x)), 2 * x)
            assert tt.compile_data(jf).cache_option is member
    with pytest.raises(ValueError, match="cache="):
        tt.jit(lambda a: a, cache="every call", device="cpu")


# =============================================================================
# The extend registry (thunder_tpu/extend/__init__.py:37-235), the port alone
# =============================================================================


def test_default_executors_are_the_registry_defaults():
    assert textend.resolve_executors(None) == tapi.DEFAULT_EXECUTORS == textend.get_default_executors()
    assert [e.name for e in textend.get_default_executors()] == ["flash", "fused", "torch"]
    assert {"flash", "fused", "torch", "norm", "quant", "python"} <= {e.name for e in textend.get_all_executors()}
    assert tt.compile_data(tt.jit(lambda a: a, device="cpu")).executors_list == tapi.DEFAULT_EXECUTORS


def test_add_default_executor_front_and_back():
    extra = textend.OperatorExecutor("extra")
    before = textend.get_default_executors()
    try:
        textend.add_default_executor(extra, front=True)
        assert textend.get_default_executors() == (extra,) + before
        textend.add_default_executor(extra, front=False)
        assert textend.get_default_executors() == before + (extra,)
    finally:
        textend._default_executors.remove(extra)
    assert textend.get_default_executors() == before


def test_fusion_pass_runs_after_claiming():
    seen = []

    class Recorder(textend.FusionExecutor):
        def fusion_pass(self, trace):
            seen.append([b.sym.executor.name for b in trace.bound_symbols if b.sym.executor is not None])
            return trace

    rec = Recorder("recorder")
    op = rec.register_temporary_operation("noop", lambda x: x)
    assert rec.get_impl(op.id) is not None and op.id == "recorder.noop"
    x = _r(3, seed=50)
    out = tt.jit(lambda a: tclang.mul(a, 2.0), device="cpu", executors=[rec, "torch"])(x)
    np.testing.assert_allclose(_np(out), 2 * x)
    assert len(seen) == 1 and seen[0] and set(seen[0]) == {"torch"}  # once, over the claimed ops


def test_fuel_stops_claiming_and_register_operator():
    ex = textend.OperatorExecutor("counted_neg")
    calls = []
    sym = ex.register_operator("neg", meta=lambda a: a, fn=lambda a: calls.append(1) or -a, replaces=tprims.PrimIDs.NEG)
    assert sym.id == "counted_neg.neg" and ex.get_impl(tprims.PrimIDs.NEG) is not None
    ex.set_fuel(1)
    f = tt.jit(lambda a: tclang.neg(tclang.neg(a)), device="cpu", executors=[ex, "torch"])
    np.testing.assert_allclose(_np(f(_r(3, seed=51))), _r(3, seed=51))
    assert calls == [1] and ex.get_fuel() is False  # one claim spent the fuel; the second neg went to torch
    assert ex.get_execution_transform(tprims.PrimIDs.NEG) is None and ex.get_grad_transform(tprims.PrimIDs.NEG) is None


def test_lookasides_register_and_resolve():
    def external(x):
        return x

    def replacement(x):
        return x

    assert textend.get_lookaside(external) is None
    textend.register_lookaside(external, replacement)
    try:
        assert textend.get_lookaside(external) is replacement
    finally:
        textend._lookasides.pop(external)
