"""The trace-rewriting helpers of ``transforms/common.py`` through both
packages, on the CPU.

``eval_trace``, ``visitor_transform``, ``replace_redundant_inputs`` and
``order_proxies`` of the port (``thunder_tpu_torch/transforms/common.py``)
against the JAX package's (``thunder_tpu/transforms/common.py``). The same
programs are acquired by each package's ``trace_program`` on the same numpy
inputs and rewritten by the same visitor; the two give the same symbol names,
the same ``order_proxies`` map, and outputs equal within
``tests/framework.py``'s float32 tolerances when each evaluates the rewritten
trace through its terminal executor's implementations (``jax``, ``torch``).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import thunder_tpu.clang as jclang
from thunder_tpu.api import trace_program as jtrace_program
from thunder_tpu.core.proxies import variableify as jvariableify
from thunder_tpu.extend import get_executor as jget_executor
from thunder_tpu.transforms import common as jcommon

import thunder_tpu_torch.clang as tclang
from thunder_tpu_torch.api import trace_program as ttrace_program
from thunder_tpu_torch.core.proxies import variableify as tvariableify
from thunder_tpu_torch.extend import get_executor as tget_executor
from thunder_tpu_torch.transforms import common as tcommon

from framework import assert_close, tolerances

JAX = SimpleNamespace(name="jax", clang=jclang, trace_program=jtrace_program, variableify=jvariableify,
                      common=jcommon, executor=lambda: jget_executor("jax"), input=lambda x: x)
PORT = SimpleNamespace(name="port", clang=tclang, trace_program=ttrace_program, variableify=tvariableify,
                       common=tcommon, executor=lambda: tget_executor("torch"), input=torch.from_numpy)
TOL = tolerances(torch.float32)


def _inputs():
    rng = np.random.RandomState(0)
    return rng.randn(4, 8).astype(np.float32), rng.randn(4, 8).astype(np.float32)


def _chain(P):
    def f(x, y):
        return P.clang.mul(P.clang.add(P.clang.tanh(P.clang.mul(x, y)), x), y)

    return f


def _reduce(P):
    def f(x, y):
        h = P.clang.exp(P.clang.sub(x, y))
        return P.clang.sum(P.clang.mul(h, P.clang.neg(y)), 1)

    return f


def _shared(P):
    def f(x, y):
        m = P.clang.mul(x, x)
        return P.clang.add(P.clang.mul(m, y), P.clang.tanh(m))

    return f


PROGRAMS = {"chain": _chain, "reduce": _reduce, "shared": _shared}


def _trace(P, program):
    a, b = _inputs()
    _, comp = P.trace_program(PROGRAMS[program](P), (P.input(a), P.input(b)), {})
    return comp


def _mul_to_add(P):
    """A visitor that swaps every ``mul`` for an ``add`` recorded in its
    place, and keeps every other symbol."""
    def visit(bsym):
        if bsym.sym.name != "mul":
            return None
        out = P.clang.add(*bsym.args)
        return {P.variableify(bsym.output): out}

    return visit


def _drop_tanh(P):
    """A visitor that replaces ``tanh(x)`` by ``x`` itself, recording nothing."""
    def visit(bsym):
        if bsym.sym.name != "tanh":
            return None
        return {P.variableify(bsym.output): bsym.args[0]}

    return visit


VISITORS = {"mul_to_add": _mul_to_add, "drop_tanh": _drop_tanh}


def _names(trace):
    return [b.sym.name for b in trace.bound_symbols]


def _evaluate(P, trace):
    ex = P.executor()
    a, b = _inputs()
    out = P.common.eval_trace(trace, P.input(a), P.input(b), symbol_mapper=lambda bsym: ex.get_impl(bsym.sym.id))
    return np.asarray(out)


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_order_proxies_equal_across_packages(program):
    j, p = _trace(JAX, program), _trace(PORT, program)
    assert _names(p) == _names(j)
    jo, po = jcommon.order_proxies(j.bound_symbols), tcommon.order_proxies(p.bound_symbols)
    assert po == jo
    assert sorted(set(po.values())) == list(range(len(po)))


@pytest.mark.parametrize("visitor", sorted(VISITORS))
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_visitor_transform_equal_across_packages(program, visitor):
    got = {}
    for P in (JAX, PORT):
        trace = _trace(P, program)
        new = P.common.visitor_transform(trace, VISITORS[visitor](P), provenance="Swap test")
        assert new is not trace
        assert "Swap test" in str(new)
        if visitor == "mul_to_add":
            assert "mul" not in _names(new)
        else:
            assert "tanh" not in _names(new)
        got[P.name] = (_names(new), P.common.order_proxies(new.bound_symbols), _evaluate(P, new))
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert_close(got["port"][2], got["jax"][2], **TOL)


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_eval_trace_runs_the_program(program):
    """``eval_trace`` with no rewrite computes the program itself: the two
    packages agree with each other and with the function run eagerly by
    each package's executor."""
    j = _evaluate(JAX, _trace(JAX, program))
    p = _evaluate(PORT, _trace(PORT, program))
    assert_close(p, j, **TOL)
    a, b = _inputs()
    if program == "chain":
        assert_close(p, (np.tanh(a * b) + a) * b, **TOL)


def test_eval_trace_rerecords_under_a_trace_context():
    """Under an active trace context and no mapper, ``eval_trace`` records
    the program again into that trace, symbol for symbol, in both
    packages."""
    from thunder_tpu.core.trace import TraceCtx as JTraceCtx
    from thunder_tpu.core.trace import tracectx as jtracectx
    from thunder_tpu_torch.core.trace import TraceCtx as TTraceCtx
    from thunder_tpu_torch.core.trace import tracectx as ttracectx

    got = {}
    for P, ctx, cls in ((JAX, jtracectx, JTraceCtx), (PORT, ttracectx, TTraceCtx)):
        trace = _trace(P, "chain")
        new = cls()
        with ctx(new):
            out = P.common.eval_trace(trace, *trace.args)
        got[P.name] = ([b.sym.name for b in new.bound_symbols], tuple(out.shape))
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["mul", "tanh", "add", "mul"]


def test_eval_trace_names_an_undefined_proxy():
    for P in (JAX, PORT):
        trace = _trace(P, "chain")
        with pytest.raises(RuntimeError, match="undefined proxy"):
            P.common.eval_trace(trace, *_inputs()[:1])


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_replace_redundant_inputs_is_the_identity(program):
    for P in (JAX, PORT):
        trace = _trace(P, program)
        assert P.common.replace_redundant_inputs(trace) is trace
