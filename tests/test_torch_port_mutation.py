"""The cases of ``tests/test_jit.py``'s ``TestInputMutationEpilogue`` through
both packages.

A function that writes into its inputs (a dict key set or deleted, a list
appended to, a tuple slot rebound, an input tensor updated in place) has the
writes replayed onto the caller's objects after each run. Each case is
written once over a namespace ``P`` (``jit``, ``grad``, the language modules,
the sharp-edge error) and run through the JAX package and through the port
on the CPU, with the checks of ``test_jit.py``; the caller-visible results
of the two runs are held equal (f32, tolerance 1e-6: the same elementwise
products and sums of a few ones).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import thunder_tpu
import thunder_tpu.clang as jclang
import thunder_tpu.torch as jtorch
from thunder_tpu.common import ThunderSharpEdgeError as JaxSharpEdgeError

import thunder_tpu_torch as tt
import thunder_tpu_torch.clang as tclang
import thunder_tpu_torch.torch as ttorch
from thunder_tpu_torch.common import ThunderSharpEdgeError as PortSharpEdgeError

JAX = SimpleNamespace(name="jax", jit=thunder_tpu.jit, grad=thunder_tpu.grad, clang=jclang, ltorch=jtorch,
                      sharp_error=JaxSharpEdgeError, epilogue=lambda jf: jf._lc_cs.cache_entries[-1].epilogue_fn)
PORT = SimpleNamespace(name="port", jit=lambda f, **k: tt.jit(f, device="cpu", **k),
                       grad=lambda f, **k: tt.grad(f, device="cpu", **k), clang=tclang, ltorch=ttorch,
                       sharp_error=PortSharpEdgeError,
                       epilogue=lambda jf: tt.compile_stats(jf).cache_entries[-1].epilogue_fn)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dict_input_set_replayed(P):
    def f(d):
        d["doubled"] = P.ltorch.mul(d["x"], 2.0)
        return P.ltorch.sum(d["x"])

    jf = P.jit(f)
    d = {"x": np.ones((2, 3), dtype=np.float32)}
    out = jf(d)
    assert "doubled" in d, "caller's dict was not updated"
    np.testing.assert_allclose(_np(d["doubled"]), 2.0 * np.ones((2, 3)))
    np.testing.assert_allclose(float(_np(out)), 6.0)
    d2 = {"x": np.full((2, 3), 3.0, dtype=np.float32)}
    jf(d2)  # the cache hit replays too
    np.testing.assert_allclose(_np(d2["doubled"]), 6.0 * np.ones((2, 3)))
    assert jf._lc_cs.cache_hits == 1
    return _np(d["doubled"]), _np(d2["doubled"]), _np(out)


def dict_del_and_scalar_set_replayed(P):
    def f(d):
        del d["old"]
        d["flag"] = 7
        return P.clang.mul(d["x"], 1.0)

    d = {"x": np.ones(3, dtype=np.float32), "old": 1}
    P.jit(f)(d)
    assert "old" not in d and d["flag"] == 7
    return sorted(d), d["flag"]


def list_append_replayed(P):
    def f(lst, x):
        lst.append(P.clang.mul(x, 3.0))
        return P.clang.sum(x, (0,))

    lst = []
    P.jit(f)(lst, np.ones(4, dtype=np.float32))
    assert len(lst) == 1
    np.testing.assert_allclose(_np(lst[0]), 3.0 * np.ones(4))
    return _np(lst[0])


def inplace_input_tensor_replayed_numpy(P):
    def f(x):
        P.ltorch.add_(x, 1.0)
        return P.ltorch.sum(x)

    x = np.zeros((2, 2), dtype=np.float32)
    out = P.jit(f)(x)
    np.testing.assert_allclose(x, np.ones((2, 2)), err_msg="caller array not updated")
    np.testing.assert_allclose(float(_np(out)), 4.0)
    return x.copy(), _np(out)


def inplace_input_tensor_replayed_torch(P):
    def f(x):
        P.ltorch.mul_(x, 2.0)
        return P.ltorch.sum(x)

    x = torch.ones(3)
    P.jit(f)(x)
    np.testing.assert_allclose(x.numpy(), 2.0 * np.ones(3))
    return x.numpy().copy()


def sharp_edges_error_raises(P):
    def f(d):
        d["k"] = P.clang.mul(d["x"], 2.0)
        return P.clang.sum(d["x"], (0,))

    jf = P.jit(f, sharp_edges="error")
    with pytest.raises(P.sharp_error, match="mutates its inputs"):
        jf({"x": np.ones(3, dtype=np.float32)})
    return "raised"


def mutation_under_grad_rejected(P):
    def f(x, out):
        out.append(P.clang.mul(x, 2.0))
        return P.clang.sum(P.clang.mul(x, x), (0,))

    with pytest.raises(NotImplementedError, match="mutates its inputs"):
        P.grad(f)(np.ones(3, dtype=np.float32), [])
    return "raised"


def tuple_value_replacement_replayed(P):
    def f(d):
        d["pair"] = (P.clang.mul(d["x"], 2.0), 5)
        return P.clang.sum(d["x"], (0,))

    d = {"x": np.ones(3, dtype=np.float32), "pair": (None, 0)}
    P.jit(f)(d)
    assert isinstance(d["pair"], tuple) and d["pair"][1] == 5
    np.testing.assert_allclose(_np(d["pair"][0]), 2.0 * np.ones(3))
    return _np(d["pair"][0]), d["pair"][1]


def nested_container_value_not_false_positive(P):
    def f(d, size=None):
        return P.clang.mul(d["x"], float(len(size)))

    jf = P.jit(f)
    d = {"x": np.ones(3, dtype=np.float32), "cfg": {"mode": "a", "dims": (1, 2)}}
    out = jf(d, size=(8, 3))
    assert P.epilogue(jf) is None, "read-only inputs produced an epilogue"
    return _np(out)


CASES = [dict_input_set_replayed, dict_del_and_scalar_set_replayed, list_append_replayed,
         inplace_input_tensor_replayed_numpy, inplace_input_tensor_replayed_torch, sharp_edges_error_raises,
         mutation_under_grad_rejected, tuple_value_replacement_replayed, nested_container_value_not_false_positive]


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    else:
        assert a == b


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_mutation_case_through_both_packages(case):
    _same(case(PORT), case(JAX))


def test_port_epilogue_list_resync_and_nested_set():
    """The port's own: a list rebuilt (``resync``) and a key set two levels
    down, replayed on every call, a cache hit included."""

    def f(d, lst):
        lst.insert(0, tclang.add(d["inner"]["x"], 1.0))
        d["inner"]["y"] = tclang.mul(d["inner"]["x"], 3.0)
        return tclang.sum(d["inner"]["x"], (0,))

    jf = tt.jit(f, device="cpu")
    for v in (1.0, 2.0):
        d, lst = {"inner": {"x": np.full(3, v, dtype=np.float32)}}, ["tail"]
        out = jf(d, lst)
        assert lst[1] == "tail" and len(lst) == 2
        np.testing.assert_allclose(_np(lst[0]), np.full(3, v + 1.0))
        np.testing.assert_allclose(_np(d["inner"]["y"]), np.full(3, 3 * v))
        np.testing.assert_allclose(float(_np(out)), 3 * v)
    assert (tt.cache_misses(jf), tt.cache_hits(jf)) == (1, 1)
    kinds = {rec[0] for rec in tt.last_traces(jf)[0]._input_mutations}
    assert kinds == {"resync", "set"}
