"""The cases of ``tests/test_inplace.py`` through both packages.

Each case is written once over a namespace ``P`` (``jit``, ``grad``,
``value_and_grad``, the ``torch`` language module, ``out`` to numpy) and run
through the JAX package and through the port on the CPU; each keeps its own
checks from ``test_inplace.py`` and the two packages' results are held
together at that case's tolerance. Module cases run on copies of one module
(the same state dict), so each package updates its own buffers. One case is
the port's own: an in-place update of an input tensor is copied into the
caller's tensor after the run, as the JAX package's epilogue does.
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import thunder_tpu
import thunder_tpu.torch as jtorch

import thunder_tpu_torch as tt
import thunder_tpu_torch.torch as ttorch


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


JAX = SimpleNamespace(name="jax", jit=thunder_tpu.jit, grad=thunder_tpu.grad,
                      value_and_grad=thunder_tpu.value_and_grad, ltorch=jtorch)
PORT = SimpleNamespace(name="port", jit=lambda f, **k: tt.jit(f, device="cpu", **k),
                       grad=lambda f, **k: tt.grad(f, device="cpu", **k),
                       value_and_grad=lambda f, **k: tt.value_and_grad(f, device="cpu", **k), ltorch=ttorch)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def basic_chain(P):
    x, y = _rand(4, 8), _rand(4, 8, seed=1)

    def f(a, b):
        c = P.ltorch.mul(a, 1.0)
        P.ltorch.add_(c, b)
        P.ltorch.mul_(c, 2.0)
        return c

    got = _np(P.jit(f)(x, y))
    np.testing.assert_allclose(got, (x + y) * 2, rtol=1e-5, atol=1e-6)
    return got


def consumer_ordering(P):
    x = _rand(4, 8)

    def f(a):
        b = P.ltorch.mul(a, 2.0)
        s1 = P.ltorch.sum(b)
        P.ltorch.zero_(b)
        s2 = P.ltorch.sum(b)
        return s1, s2

    s1, s2 = (_np(v) for v in P.jit(f)(x))
    assert abs(float(s1) - 2 * x.sum()) < 1e-3 and float(s2) == 0.0
    return s1, s2


def inplace_keeps_dtype(P):
    x = np.arange(8, dtype=np.int64)

    def f(a):
        b = P.ltorch.add(a, 0)
        P.ltorch.add_(b, 1)
        return b

    got = _np(P.jit(f)(x))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, x + 1)
    return got


def masked_fill_and_clamp_(P):
    x = _rand(4, 8)

    def f(a):
        b = P.ltorch.mul(a, 1.0)
        P.ltorch.masked_fill_(b, P.ltorch.lt(b, 0.0), 0.5)
        P.ltorch.clamp_(b, None, 1.0)
        return b

    got = _np(P.jit(f)(x))
    want = torch.from_numpy(x).clone()
    want.masked_fill_(want < 0.0, 0.5).clamp_(max=1.0)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)
    return got


def copy_broadcast_and_cast(P):
    x, row = _rand(4, 8), _rand(8, seed=3)

    def f(a, r):
        b = P.ltorch.mul(a, 1.0)
        P.ltorch.copy_(b, r)
        return b

    got = _np(P.jit(f)(x, row))
    np.testing.assert_allclose(got, np.broadcast_to(row, (4, 8)), rtol=1e-6)
    return got


def grads_flow_through_inplace(P):
    x, y = _rand(4, 4), _rand(4, 4, seed=5)

    def f(a, b):
        c = P.ltorch.mul(a, 1.0)
        P.ltorch.add_(c, b)
        P.ltorch.mul_(c, 2.0)
        return P.ltorch.sum(c)

    g = P.grad(f)(x, y)
    gx = _np(g[0] if isinstance(g, (tuple, list)) else g)
    np.testing.assert_allclose(gx, np.full((4, 4), 2.0), rtol=1e-6)
    return gx


def alpha_kwarg(P):
    x, y = _rand(4, 4), _rand(4, 4, seed=2)
    a = _np(P.jit(lambda a, b: P.ltorch.add(a, b, alpha=3.0))(x, y))
    np.testing.assert_allclose(a, x + 3.0 * y, rtol=1e-5)
    s = _np(P.jit(lambda a, b: P.ltorch.sub(a, b, alpha=0.5))(x, y))
    np.testing.assert_allclose(s, x - 0.5 * y, rtol=1e-5)
    return a, s


def _module_copy(m):
    return copy.deepcopy(m)


def module_with_inplace_forward(P):
    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(8, 8)

        def forward(self, x):
            h = self.lin(x)
            h.mul_(0.5)
            h.add_(1.0)
            return h.relu()

    torch.manual_seed(0)
    m = M()
    x = torch.from_numpy(_rand(4, 8))
    got = _np(P.jit(m)(x))
    np.testing.assert_allclose(got, _np(m(x)), rtol=1e-4, atol=1e-5)
    return got


def batchnorm_eval_and_train_forward(P):
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1), torch.nn.BatchNorm2d(4), torch.nn.ReLU())
    x = torch.from_numpy(_rand(2, 3, 8, 8))
    m.eval()
    ev = _np(P.jit(m)(x))
    np.testing.assert_allclose(ev, _np(m(x)), rtol=1e-4, atol=1e-4)
    m.train()
    ref = _module_copy(m)
    tr = _np(P.jit(m)(x))
    np.testing.assert_allclose(tr, _np(ref(x)), rtol=1e-3, atol=1e-3)
    return ev, tr


def batchnorm_running_stats_writeback(P):
    torch.manual_seed(0)
    m, m_ref = torch.nn.BatchNorm2d(3), torch.nn.BatchNorm2d(3)
    m_ref.load_state_dict(m.state_dict())
    m.train()
    m_ref.train()
    x = torch.from_numpy(_rand(4, 3, 8, 8))
    tm = P.jit(m)
    for _ in range(3):
        out = tm(x)
        ref = m_ref(x)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_np(m.running_mean), _np(m_ref.running_mean), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(m.running_var), _np(m_ref.running_var), rtol=1e-4, atol=1e-5)
    assert int(m.num_batches_tracked) == 3
    m.eval()
    m_ref.eval()
    ev = _np(P.jit(m)(x))
    np.testing.assert_allclose(ev, _np(m_ref(x)), rtol=1e-3, atol=1e-4)
    return _np(out), _np(m.running_mean), _np(m.running_var), ev


def setattr_buffer_counter(P):
    class Counter(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("steps", torch.zeros(()))
            self.lin = torch.nn.Linear(4, 4)

        def forward(self, x):
            self.steps = self.steps + 1.0
            return self.lin(x) * 1.0

    torch.manual_seed(0)
    c = Counter()
    tc = P.jit(c)
    x = torch.from_numpy(_rand(2, 4))
    for _ in range(5):
        out = tc(x)
    assert float(c.steps) == 5.0
    return _np(out), _np(c.steps)


def conv_grads(P):
    torch.manual_seed(0)
    m = torch.nn.Conv2d(3, 4, 3, padding=1, bias=True)
    x = torch.from_numpy(_rand(2, 3, 8, 8))
    P.jit(m)(x).sum().backward()
    gw, gb = m.weight.grad.clone(), m.bias.grad.clone()
    m.weight.grad = m.bias.grad = None
    m(x).sum().backward()
    np.testing.assert_allclose(_np(gw), _np(m.weight.grad), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_np(gb), _np(m.bias.grad), rtol=1e-3, atol=1e-3)
    return _np(gw), _np(gb)


def slice_assign(P):
    def f(a):
        b = P.ltorch.mul(a, 1.0)
        b[1:3] = 7.0
        return b

    x = _rand(5, 4)
    got = _np(P.jit(f)(x))
    want = x.copy()
    want[1:3] = 7.0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    return got


def int_and_tuple_key_assign(P):
    def f(a, v):
        b = P.ltorch.mul(a, 1.0)
        b[0] = v
        b[2, 1:] = 0.0
        return b

    x, v = _rand(4, 4), _rand(4, seed=2)
    got = _np(P.jit(f)(x, v))
    want = x.copy()
    want[0] = v
    want[2, 1:] = 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    return got


def setitem_grads(P):
    def loss(a, v):
        b = P.ltorch.mul(a, 1.0)
        b[1:3] = v
        return P.ltorch.sum(b * b)

    x, v = _rand(5, 4), _rand(2, 4, seed=3)
    _, (ga, gv) = P.value_and_grad(loss)(x, v)
    ta = torch.from_numpy(x).requires_grad_()
    tv = torch.from_numpy(v).requires_grad_()
    tb = ta * 1.0
    tb = torch.cat([tb[:1], tv, tb[3:]])
    (tb * tb).sum().backward()
    np.testing.assert_allclose(_np(ga), ta.grad.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(gv), tv.grad.numpy(), rtol=1e-4, atol=1e-6)
    return _np(ga), _np(gv)


def bool_mask_scalar_assign(P):
    def f(a, m):
        b = P.ltorch.mul(a, 1.0)
        b[m] = -1e9
        return b

    x = _rand(4, 5)
    m = x > 0
    got = _np(P.jit(f)(x, m))
    want = x.copy()
    want[m] = -1e9
    np.testing.assert_allclose(got, want, rtol=1e-5)
    return got


def bool_mask_leading_dims(P):
    def f(a, m):
        b = P.ltorch.mul(a, 1.0)
        b[m] = 0.0
        return b

    x = _rand(4, 5)
    m = np.array([True, False, True, False])
    got = _np(P.jit(f)(x, m))
    want = x.copy()
    want[m] = 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    return got


def bool_mask_tensor_value_rejected(P):
    def f(a, m, v):
        b = P.ltorch.mul(a, 1.0)
        b[m] = v
        return b

    x = _rand(4, 5)
    m = x > 0
    with pytest.raises(NotImplementedError, match="boolean mask"):
        P.jit(f)(x, m, _rand(int(m.sum()), seed=4))
    return ()


def scalar_into_int_tensor_truncates(P):
    def f(a):
        b = P.ltorch.add(a, 0)
        b[0] = 7.5
        return b

    got = _np(P.jit(f)(np.arange(4, dtype=np.int32)))
    assert got.dtype == np.int32 and got[0] == 7, got
    return got


def input_tensor_updated_in_place(P):
    def f(a, b):
        P.ltorch.add_(a, b)
        return P.ltorch.mul(a, 2.0)

    a, b = torch.from_numpy(_rand(3, 4)), torch.from_numpy(_rand(3, 4, seed=1))
    a0 = a.clone()
    fn = P.jit(f)
    out1, out2 = _np(fn(a, b)), _np(fn(a, b))
    np.testing.assert_allclose(_np(a), _np(a0 + 2 * b), rtol=1e-6)
    np.testing.assert_allclose(out2, _np((a0 + 2 * b) * 2), rtol=1e-6)
    return out1, out2, _np(a)


CASES = [basic_chain, consumer_ordering, inplace_keeps_dtype, masked_fill_and_clamp_, copy_broadcast_and_cast,
         grads_flow_through_inplace, alpha_kwarg, module_with_inplace_forward, batchnorm_eval_and_train_forward,
         batchnorm_running_stats_writeback, setattr_buffer_counter, conv_grads, slice_assign,
         int_and_tuple_key_assign, setitem_grads, bool_mask_scalar_assign, bool_mask_leading_dims,
         bool_mask_tensor_value_rejected, scalar_into_int_tensor_truncates, input_tensor_updated_in_place]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_inplace_case_through_both_packages(case):
    want = case(JAX)
    got = case(PORT)
    flat_w = want if isinstance(want, tuple) else (want,)
    flat_g = got if isinstance(got, tuple) else (got,)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64), rtol=1e-4, atol=1e-5)
