"""The ``TestAutocast`` cases of ``tests/test_transforms.py`` through both
packages, and ``autocast=`` on the port's module frontend.

Each case runs the same program through the JAX package and through the port
on the CPU, keeps its own checks (bf16 products against the f32 program
within 2e-2 relative, the loss within 5e-2, gradients within 2e-2 of their
largest magnitude plus 1e-3) and holds the two packages together at those
same limits: both cast the products' inputs to bf16 and the results back to
f32, but XLA's CPU backend may keep a product's f32 result where torch
rounds it to bf16 first, so each product element may differ by one bf16
rounding (2^-9 of it), which a sum of products can carry to a few 1e-3.
"""

import numpy as np
import pytest
import torch

import thunder_tpu
import thunder_tpu.torch as jtorch
from thunder_tpu.api import trace_program as jtrace_program
from thunder_tpu.transforms.autocast import autocast as jautocast
from thunder_tpu.transforms.common import dce as jdce

import thunder_tpu_torch as tt
import thunder_tpu_torch.torch as ttorch
from thunder_tpu_torch.api import trace_program as ttrace_program
from thunder_tpu_torch.transforms.autocast import autocast as tautocast
from thunder_tpu_torch.transforms.common import dce as tdce


def _t(*shape, seed=0):
    rng = np.random.RandomState(seed + sum(shape))
    return rng.randn(*shape).astype(np.float32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


PACKAGES = {
    "jax": (thunder_tpu, jtorch, {}),
    "port": (tt, ttorch, {"device": "cpu"}),
}


def _linear_runs_in_bf16(pkg, lt, kw):
    def f(x, w):
        return lt.sum(lt.linear(x, w))

    jf = pkg.jit(f, autocast="bfloat16", **kw)
    x, w = _t(4, 8), _t(6, 8, seed=1)
    out = float(_np(jf(x, w)))
    assert "bfloat16" in pkg.last_traces(jf)[-1].python()
    want = float(_np(pkg.jit(f, **kw)(x, w)))
    np.testing.assert_allclose(out, want, rtol=2e-2)
    return out


def _autocast_with_grad(pkg, lt, kw):
    def loss(x, w):
        return lt.sum(lt.gelu(lt.linear(x, w)) ** 2.0)

    x, w = _t(4, 8), _t(6, 8, seed=1)
    l1, g1 = pkg.value_and_grad(loss, autocast="bfloat16", **kw)(x, w)
    l2, g2 = pkg.value_and_grad(loss, **kw)(x, w)
    np.testing.assert_allclose(float(_np(l1)), float(_np(l2)), rtol=5e-2)
    for a, b in zip(g1, g2):
        _assert_grad_close(_np(a), _np(b))
    return float(_np(l1)), [_np(g) for g in g1]


def _assert_grad_close(a, b):
    # bf16 matmuls: error scales with the tensor's magnitude
    assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max() + 1e-3


def _matmul_inputs_cast_not_others(trace_program, dce, autocast, lt):
    def f(x, w):
        h = lt.linear(x, w)
        return lt.sum(lt.exp(h * 0.01))

    _, comp = trace_program(f, (_t(4, 8), _t(6, 8, seed=1)), {})
    src = autocast(dce(comp)).python()
    assert "bfloat16" in src
    assert src.count("convert_element_type") >= 2
    return [line.split("=", 1)[-1].strip().split("(")[0] for line in src.splitlines() if " = " in line]


def test_linear_runs_in_bf16_through_both_packages():
    np.testing.assert_allclose(_linear_runs_in_bf16(*PACKAGES["port"]), _linear_runs_in_bf16(*PACKAGES["jax"]),
                               rtol=2e-2)


def test_autocast_with_grad_through_both_packages():
    (l_jax, g_jax), (l_port, g_port) = _autocast_with_grad(*PACKAGES["jax"]), _autocast_with_grad(*PACKAGES["port"])
    np.testing.assert_allclose(l_port, l_jax, rtol=5e-2)
    for a, b in zip(g_port, g_jax):
        _assert_grad_close(a, b)


def test_matmul_inputs_cast_not_others_through_both_packages():
    want = _matmul_inputs_cast_not_others(jtrace_program, jdce, jautocast, jtorch)
    got = _matmul_inputs_cast_not_others(ttrace_program, tdce, tautocast, ttorch)
    assert [op.replace("ltorch.", "") for op in got] == [op.replace("ltorch.", "") for op in want]


def test_autocast_comes_before_grad_and_casts_attention_to_bf16():
    """``autocast`` is the first trace transform, as the JAX package puts it
    (``api.py:1620-1627``): SDPA on f32 inputs runs on bf16 casts, which the
    flash executor claims, and the gradients come back in f32."""
    B, H, T, D = 1, 2, 128, 64
    q, k, v = (_t(B, H, T, D, seed=s) for s in range(3))

    def loss(q, k, v):
        return ttorch.sum(ttorch.scaled_dot_product_attention(q, k, v, is_causal=True))

    vg = tt.value_and_grad(loss, autocast="bfloat16", device="cpu")
    value, grads = vg(q, k, v)
    assert all(g.dtype == torch.float32 for g in grads)
    src = tt.last_traces(vg)[-1].python()
    assert "flash_sdpa" in src
    ref = torch.nn.functional.scaled_dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)), is_causal=True)
    np.testing.assert_allclose(float(value), float(ref.sum()), rtol=2e-2, atol=2e-1)


def test_module_autocast_runs_its_products_in_bf16():
    """The port's module frontend applies ``autocast=``; the JAX package's
    takes the option and leaves the module's products in f32."""
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(), torch.nn.Linear(32, 4))
    x = torch.from_numpy(_t(8, 16))
    tm = tt.jit(m, device="cpu", autocast="bfloat16")
    out = tm(x)
    assert out.dtype == torch.float32
    assert "bfloat16" in tt.last_traces(tm)[-1].python()
    want = m(x)
    torch.testing.assert_close(out, want, rtol=3e-2, atol=3e-2)
    out.sum().backward()
    assert m[0].weight.grad is not None and m[0].weight.grad.dtype == torch.float32
