"""Acquisition and ``jit`` cases of the JAX package's tests through both
packages: the sharp-edge reports.

Each case is written once over a namespace ``P`` (``jit``, the language
modules, the package's top-level sharp-edge classes) from the checks of
``tests/test_jit.py`` (``TestSharpEdges``) and ``tests/test_acquisition.py``
(``test_captured_tensor_sharp_edge``, ``test_torch_tensor_closure_in_module``),
and run through the JAX package and through the port on the CPU. Where a
case returns values, the two runs are held equal (f32, tolerance 1e-6: the
same few elementwise products and sums). A module's own parameters and
buffers are inputs, so ``jit(module, sharp_edges="error")`` of a module that
closes over nothing raises nothing.
"""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn as nn

import thunder_tpu
import thunder_tpu.clang as jclang
import thunder_tpu.torch as jtorch

import thunder_tpu_torch as tt
import thunder_tpu_torch.clang as tclang
import thunder_tpu_torch.torch as ttorch

JAX = SimpleNamespace(name="jax", pkg=thunder_tpu, jit=thunder_tpu.jit, clang=jclang, ltorch=jtorch)
PORT = SimpleNamespace(name="port", pkg=tt, jit=lambda f, **k: tt.jit(f, device="cpu", **k), clang=tclang,
                       ltorch=ttorch)
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=lambda P: P.name)


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
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
    x = _r(3, seed=5)
    for opt in (tt.CACHE_OPTIONS.CONSTANT_VALUES, "constant values"):
        np.testing.assert_allclose(_np(tt.jit(lambda a: tclang.mul(a, 2.0), cache=opt, device="cpu")(x)), 2 * x)
    with pytest.raises(ValueError, match="cache="):
        tt.jit(lambda a: a, cache=tt.CACHE_OPTIONS.NO_CACHING, device="cpu")
