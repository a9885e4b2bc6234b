"""The numpy language and the trace pattern matcher through both packages.

The cases of ``tests/test_numpy_lang.py`` (3) and ``tests/test_patterns.py``
(5), each written once over a namespace ``P`` and run through the JAX
package and through the port on the CPU (``device="cpu"``). Where a case
returns values, the two runs are held equal (f32, rtol 1e-6: the same few
elementwise ops, one 4x3 product).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import thunder_tpu
import thunder_tpu.api as japi
import thunder_tpu.clang as jclang
import thunder_tpu.numpy as jnp_lang
from thunder_tpu.core import langctxs as jlangctxs
from thunder_tpu.core import patterns as jpatterns
from thunder_tpu.core.prims import PrimIDs as JPrimIDs
from thunder_tpu.executors.passes import transform_for_execution as jtfe
from thunder_tpu.extend import resolve_executors as jresolve
from thunder_tpu.transforms.common import dce as jdce

import thunder_tpu_torch as tt
import thunder_tpu_torch.api as tapi
import thunder_tpu_torch.clang as tclang
import thunder_tpu_torch.numpy as tnp_lang
from thunder_tpu_torch.core import devices as tdevices
from thunder_tpu_torch.core import langctxs as tlangctxs
from thunder_tpu_torch.core import patterns as tpatterns
from thunder_tpu_torch.core.prims import PrimIDs as TPrimIDs
from thunder_tpu_torch.executors.passes import transform_for_execution as ttfe
from thunder_tpu_torch.extend import resolve_executors as tresolve
from thunder_tpu_torch.transforms.common import dce as tdce

JAX = SimpleNamespace(name="jax", jit=thunder_tpu.jit, api=japi, np=jnp_lang, langctxs=jlangctxs, clang=jclang,
                      patterns=jpatterns, PrimIDs=JPrimIDs, tfe=jtfe, resolve=jresolve, dce=jdce,
                      trace_program=japi.trace_program)
PORT = SimpleNamespace(name="port", jit=lambda f, **k: tt.jit(f, device="cpu", **k), api=tapi, np=tnp_lang,
                       langctxs=tlangctxs, clang=tclang, patterns=tpatterns, PrimIDs=TPrimIDs, tfe=ttfe,
                       resolve=tresolve, dce=tdce, trace_program=lambda f, a, k: _on_cpu(tapi.trace_program, f, a, k))
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=lambda P: P.name)


def _on_cpu(fn, *args):
    with tdevices.default_device("cpu"):
        return fn(*args)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


# =============================================================================
# tests/test_numpy_lang.py
# =============================================================================


def numpy_ops_trace_and_execute(P):
    def f(a, b):
        h = P.np.add(a, b)
        return P.np.matmul(P.np.transpose(h), h), P.np.sum(P.np.multiply(h, h), axis=1)

    a = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    b = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    m, s = P.jit(f)(a, b)
    h = a + b
    np.testing.assert_allclose(_np(m), h.T @ h, rtol=1e-5)
    np.testing.assert_allclose(_np(s), (h * h).sum(1), rtol=1e-5)
    return np.concatenate([_np(m).ravel(), _np(s)])


def ufunc_where_kwarg(P):
    a = np.ones(4, dtype=np.float32)
    b = np.full(4, 2.0, dtype=np.float32)
    mask = np.array([True, False, True, False])
    out = _np(P.jit(lambda a, b, m: P.np.add(a, b, where=m))(a, b, mask))
    np.testing.assert_allclose(out, np.add(a, b, where=mask, out=a.copy()))
    return out


def methods_resolve_under_numpy_context(P):
    ctx = P.langctxs.resolve_language(P.langctxs.Languages.NUMPY)
    assert ctx.has_method("add") and ctx.has_method("matmul") and ctx.has_method("len")
    f = P.langctxs.langctx(P.langctxs.Languages.NUMPY)(lambda a: a.mean(axis=0))
    _, comp = P.trace_program(f, (np.random.RandomState(2).randn(3, 5).astype(np.float32),), {})
    assert tuple(comp.output.shape) == (5,)


# =============================================================================
# tests/test_patterns.py
# =============================================================================


def _trace(P, fn, *args):
    _, comp = P.trace_program(fn, args, {})
    return P.dce(comp)


def match_chain(P):
    x = np.random.RandomState(3).randn(3).astype(np.float32)
    comp = _trace(P, lambda a, b: P.clang.neg(P.clang.add(P.clang.mul(a, b), a)), x, x)
    ms = P.patterns.Pattern().match(P.PrimIDs.MUL, "m").match(P.PrimIDs.ADD, "a").match_all(comp)
    assert len(ms) == 1
    m = ms[0]
    assert m["m"].sym.id is P.PrimIDs.MUL and m["a"].sym.id is P.PrimIDs.ADD
    assert m["m"].flat_proxy_outs[0].name in {p.name for p in m["a"].flat_proxy_args}


def predicate_step_and_no_match(P):
    comp = _trace(P, lambda a: P.clang.mul(P.clang.neg(a), 2.0), np.random.RandomState(4).randn(3).astype(np.float32))
    assert not P.patterns.Pattern().match(P.PrimIDs.ADD).match_all(comp)
    ms = P.patterns.Pattern().match(lambda b: b.sym.id is P.PrimIDs.NEG, "n").match_all(comp)
    assert len(ms) == 1 and isinstance(ms[0], P.patterns.Match)


def non_overlapping(P):
    comp = _trace(P, lambda a: P.clang.mul(P.clang.mul(P.clang.mul(a, 2.0), 3.0), 4.0),
                  np.random.RandomState(5).randn(3).astype(np.float32))
    ms = P.patterns.Pattern().match(P.PrimIDs.MUL).match(P.PrimIDs.MUL).match_all(comp)
    assert len(ms) == 1 and ms[0].indices[0] < ms[0].indices[1]


def replace_refuses_dangling_consumer(P):
    def f(a):
        t = P.clang.mul(a, 2.0)
        return P.clang.mul(P.clang.neg(t), P.clang.add(t, a))

    comp = _trace(P, f, np.random.RandomState(6).randn(3).astype(np.float32))
    m = P.patterns.Pattern().match(P.PrimIDs.MUL, "m").match(P.PrimIDs.ADD, "a").match_all(comp)[0]

    def build(match):
        return {match["a"].flat_proxy_outs[0].name: P.clang.mul(match["m"].args[0], 3.0)}

    with pytest.raises(ValueError, match="consumes"):
        P.patterns.replace(comp, m, build)


def replace_rewrite(P):
    x = np.random.RandomState(7).randn(3).astype(np.float32)
    comp = _trace(P, lambda a, b: P.clang.neg(P.clang.add(P.clang.mul(a, b), a)), x, x)
    m = P.patterns.Pattern().match(P.PrimIDs.MUL, "m").match(P.PrimIDs.ADD, "a").match_all(comp)[0]

    def build(match):
        a_in, b_in = match["m"].args[0], match["m"].args[1]
        return {match["a"].flat_proxy_outs[0].name: P.clang.mul(a_in, P.clang.add(b_in, 1.0))}

    comp2 = P.dce(P.patterns.replace(comp, m, build))
    got = _np(P.tfe(comp2, P.resolve(None)).python_callable()(*(torch.from_numpy(x) if P is PORT else x,) * 2))
    np.testing.assert_allclose(got, -(x * (x + 1.0)), rtol=1e-6)
    return got


CASES = [numpy_ops_trace_and_execute, ufunc_where_kwarg, methods_resolve_under_numpy_context, match_chain,
         predicate_step_and_no_match, non_overlapping, replace_refuses_dangling_consumer, replace_rewrite]


@BOTH
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_case(case, P):
    case(P)


@pytest.mark.parametrize("case", [numpy_ops_trace_and_execute, ufunc_where_kwarg, replace_rewrite],
                         ids=lambda c: c.__name__)
def test_case_results_agree(case):
    np.testing.assert_allclose(case(PORT), case(JAX), rtol=1e-6, atol=1e-6)


def test_numpy_language_is_registered_beside_torch():
    """Importing the numpy language registers its context; the torch
    language stays the default method table."""
    assert tlangctxs.resolve_language(tlangctxs.Languages.NUMPY).has_method("reshape")
    assert tlangctxs.get_langctx() is tlangctxs.resolve_language(tlangctxs.Languages.TORCH)
