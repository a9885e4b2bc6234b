"""vmap, jvp and grad of vmap through both packages, and the kernels' batching rules.

Each case of ``tests/test_function_transforms.py`` is written once over a
namespace ``P`` and run through the JAX package and through the port on the
CPU (``device="cpu"``); where a case returns values, the two runs are held
equal (f32, rtol 1e-5: the same few products and sums).

The port alone: each kernel's batching rule (``executors/batching.py``)
under ``torch.func.vmap`` against a loop over the slices of the wrapper's
plain version, with mixed ``in_dims``, a vmapped dim that is not the first,
and the norm backward's per-slice dw (folding would sum it over the slices).
On the CPU a wrapper runs its plain version on the folded tensors, so these
hold the folding; bf16 results are held bit for bit where the plain version
computes a row at a time (rope, cross-entropy, the norms) and within 2^-7 of
the largest element for attention, whose plain version's products take
another summation order at another batch size. Also: one wrapper call a call
site under vmap, a kernel without a rule raising, jvp claiming no kernel,
a wrapper refusing a batched or dual tensor, keyed draws under vmap, and
open_llama_3b's head size (``llama-hs100-tiny``, bf16, 2 layers, T = 128)
per-sample gradients against the jit path's B = 1 grads and against the
JAX package's ``vmap(grad(loss))`` (norm-relative 2^-5, as
``test_torch_port_autodiff.py`` holds bf16 grads).
"""

import dataclasses
import gc
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

import thunder_tpu
import thunder_tpu.api as japi
import thunder_tpu.clang as jclang
import thunder_tpu.torch as jtorch
from thunder_tpu.core.pytree import tree_flatten as jtree_flatten
from thunder_tpu.models import gpt as jgpt

import thunder_tpu_torch as tt
import thunder_tpu_torch.api as tapi
import thunder_tpu_torch.clang as tclang
import thunder_tpu_torch.torch as ttorch
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.executors import batching, flashex, fusedex, normex
from thunder_tpu_torch.models import gpt as tgpt

JAX = SimpleNamespace(name="jax", pkg=thunder_tpu, api=japi, vmap=thunder_tpu.vmap, jvp=thunder_tpu.jvp,
                      grad=thunder_tpu.grad, value_and_grad=thunder_tpu.value_and_grad, jit=thunder_tpu.jit,
                      clang=jclang, ltorch=jtorch)
PORT = SimpleNamespace(name="port", pkg=tt, api=tapi, vmap=lambda f, **k: tt.vmap(f, device="cpu", **k),
                       jvp=lambda f, p, t: tt.jvp(f, p, t, device="cpu"),
                       grad=lambda f, **k: tt.grad(f, device="cpu", **k),
                       value_and_grad=lambda f, **k: tt.value_and_grad(f, device="cpu", **k),
                       jit=lambda f, **k: tt.jit(f, device="cpu", **k), clang=tclang, ltorch=ttorch)
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=lambda P: P.name)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


# =============================================================================
# tests/test_function_transforms.py, written over P
# =============================================================================


def vmap_batches_over_leading_axis(P):
    def f(x, w):
        return P.ltorch.sum(P.ltorch.tanh(P.ltorch.linear(x, w)))

    xs = np.random.RandomState(0).randn(5, 4, 8).astype(np.float32)
    w = np.random.RandomState(1).randn(3, 8).astype(np.float32)
    out = _np(P.vmap(f, in_axes=(0, None))(xs, w))
    want = np.array([np.tanh(x @ w.T).sum() for x in xs], dtype=np.float32)
    np.testing.assert_allclose(out, want, rtol=1e-3, atol=1e-4)
    return out


def jvp_forward_mode(P):
    def g(x):
        return P.ltorch.sum(P.ltorch.exp(x))

    x = np.random.RandomState(2).randn(3, 3).astype(np.float32)
    p, tg = P.jvp(g, (x,), (np.ones_like(x),))
    np.testing.assert_allclose(float(_np(p)), np.exp(x).sum(), rtol=1e-4)
    np.testing.assert_allclose(float(_np(tg)), np.exp(x).sum(), rtol=1e-4)
    return np.stack([_np(p), _np(tg)])


def jvp_linear_map(P):
    def g(x, w):
        return P.ltorch.linear(x, w)

    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    w = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    tx = np.random.RandomState(2).randn(2, 4).astype(np.float32)
    p, t = P.jvp(g, (x, w), (tx, np.zeros_like(w)))
    np.testing.assert_allclose(_np(p), x @ w.T, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(t), tx @ w.T, rtol=1e-4, atol=1e-5)
    return np.stack([_np(p), _np(t)])


def vmap_kwargs_and_kernel_claims(P):
    def f(x, w, *, scale=1.0):
        return P.ltorch.sum(P.ltorch.tanh(P.ltorch.linear(x, w)) * scale)

    xs = np.random.RandomState(0).randn(5, 4, 8).astype(np.float32)
    w = np.random.RandomState(1).randn(3, 8).astype(np.float32)
    out = _np(P.vmap(f, in_axes=(0, None))(xs, w, scale=2.0))
    want = np.array([2.0 * np.tanh(x @ w.T).sum() for x in xs], dtype=np.float32)
    np.testing.assert_allclose(out, want, rtol=1e-3, atol=1e-4)
    return out


def vmap_over_sdpa_model(P):
    def f(q, k, v):
        return P.ltorch.sum(P.ltorch.scaled_dot_product_attention(q, k, v, is_causal=True))

    rng = np.random.RandomState(3)
    qs, ks, vs = (rng.randn(3, 1, 2, 128, 16).astype(np.float32) for _ in range(3))
    out = _np(P.vmap(f)(qs, ks, vs))
    jf = P.jit(f)
    want = np.array([float(_np(jf(qs[i], ks[i], vs[i]))) for i in range(3)])
    np.testing.assert_allclose(out, want, rtol=2e-3, atol=1e-3)
    return out


def vmap_pytree_arg(P):
    def f(p, x):
        return P.ltorch.sum(P.ltorch.linear(x, p["w"]) + p["b"])

    rng = np.random.RandomState(5)
    ps = {"w": rng.randn(4, 3, 8).astype(np.float32), "b": rng.randn(4, 3).astype(np.float32)}
    x = rng.randn(2, 8).astype(np.float32)
    out = _np(P.vmap(f, in_axes=(0, None))(ps, x))
    want = np.array([(x @ ps["w"][i].T + ps["b"][i]).sum() for i in range(4)], dtype=np.float32)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    return out


def vmap_second_call_zero_tracing(P):
    vm = P.vmap(lambda x: P.clang.mul(x, 2.0))
    a = np.random.randn(4, 3).astype(np.float32)
    r1 = _np(vm(a))
    cs = P.pkg.compile_stats(vm)
    assert cs.cache_misses == 1
    r2 = _np(vm(a))
    assert cs.cache_misses == 1 and cs.cache_hits == 1
    np.testing.assert_allclose(r1, r2)


def vmap_in_axes_arity_validated(P):
    vm = P.vmap(lambda x, y: P.clang.add(x, y), in_axes=(0,))
    a = np.random.randn(4, 3).astype(np.float32)
    with pytest.raises(ValueError, match="in_axes"):
        vm(a, a)


def jvp_caches_staging(P):
    def f(x):
        return P.clang.sin(x)

    P.api._jvp_cache.clear()
    a = np.random.randn(3).astype(np.float32)
    t = np.ones(3, dtype=np.float32)
    _, t1 = P.jvp(f, (a,), (t,))
    assert len(P.api._jvp_cache) == 1
    _, t2 = P.jvp(f, (a,), (t,))
    assert len(P.api._jvp_cache) == 1
    np.testing.assert_allclose(_np(t1), _np(t2))


def jvp_closures_in_loop_not_aliased(P):
    a = np.ones(3, dtype=np.float32)
    t = np.ones(3, dtype=np.float32)
    results = []
    for c in (2.0, 3.0, 4.0):
        def f(x, _c=c):
            return P.clang.mul(x, _c)

        _, tg = P.jvp(f, (a,), (t,))
        results.append(float(_np(tg)[0]))
        del f
        gc.collect()
    assert results == [2.0, 3.0, 4.0]


def jvp_cache_lru_eviction_bounded(P):
    c = P.api._JvpCache()
    for i in range(c.MAX_ENTRIES + 44):
        c.put(str(i), (), i)
    assert len(c) == c.MAX_ENTRIES
    assert c.get("0", ()) is None
    assert c.get(str(c.MAX_ENTRIES + 43), ()) == c.MAX_ENTRIES + 43


def vmap_of_grad_per_sample_gradients(P):
    def loss(x, w):
        return P.ltorch.sum(P.ltorch.tanh(P.ltorch.linear(x, w)))

    rng = np.random.RandomState(7)
    xs = rng.randn(5, 4, 8).astype(np.float32)
    w = rng.randn(3, 8).astype(np.float32)
    gx, gw = P.vmap(P.grad(loss), in_axes=(0, None))(xs, w)
    assert gx.shape == (5, 4, 8) and gw.shape == (5, 3, 8)
    tw = torch.from_numpy(w)
    for i in range(5):
        tx = torch.from_numpy(xs[i]).requires_grad_()
        twi = tw.clone().requires_grad_()
        torch.tanh(torch.nn.functional.linear(tx, twi)).sum().backward()
        np.testing.assert_allclose(_np(gx[i]), tx.grad.numpy(), rtol=2e-3, atol=1e-4)
        np.testing.assert_allclose(_np(gw[i]), twi.grad.numpy(), rtol=2e-3, atol=1e-4)
    return np.concatenate([_np(gx).ravel(), _np(gw).ravel()])


def grad_of_vmap_ones_cotangent(P):
    def f(x, w):
        return P.ltorch.sum(P.ltorch.tanh(P.ltorch.linear(x, w)))

    rng = np.random.RandomState(8)
    xs = rng.randn(5, 4, 8).astype(np.float32)
    w = rng.randn(3, 8).astype(np.float32)
    gx, gw = P.grad(P.vmap(f, in_axes=(0, None)))(xs, w)
    assert gx.shape == xs.shape and gw.shape == w.shape
    tx = torch.from_numpy(xs).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    torch.tanh(torch.nn.functional.linear(tx, tw)).sum().backward()
    np.testing.assert_allclose(_np(gx), tx.grad.numpy(), rtol=2e-3, atol=3e-4)
    np.testing.assert_allclose(_np(gw), tw.grad.numpy(), rtol=2e-3, atol=3e-4)
    return np.concatenate([_np(gx).ravel(), _np(gw).ravel()])


def value_and_grad_of_vmap(P):
    xs = np.random.RandomState(9).randn(3, 4).astype(np.float32)
    vm = P.vmap(lambda x: P.ltorch.sum(P.ltorch.exp(x)))
    vals, (gx,) = P.value_and_grad(vm)(xs)
    np.testing.assert_allclose(_np(vals), np.exp(xs).sum(axis=1), rtol=1e-4)
    np.testing.assert_allclose(_np(gx), np.exp(xs), rtol=1e-4)
    return np.concatenate([_np(vals).ravel(), _np(gx).ravel()])


def vmap_of_grad_caches_staging(P):
    per_sample = P.vmap(P.grad(lambda x: P.ltorch.sum(P.ltorch.exp(x))))
    xs = np.random.RandomState(10).randn(4, 3).astype(np.float32)
    per_sample(xs)
    per_sample(xs)
    cs = P.pkg.compile_stats(per_sample)
    assert cs.cache_misses == 1 and cs.cache_hits == 1


def vmap_rejects_container_mutation(P):
    def f(d):
        d["k"] = P.ltorch.tanh(d["x"])
        return P.ltorch.sum(d["k"])

    with pytest.raises(NotImplementedError, match="mutates its inputs"):
        P.vmap(f)({"x": np.ones((3, 4), np.float32)})


def jvp_rejects_inplace_tensor_mutation(P):
    def f(x):
        P.ltorch.add_(x, 1.0)
        return P.ltorch.sum(x)

    x = np.ones((4,), np.float32)
    with pytest.raises(NotImplementedError, match="mutates its inputs"):
        P.jvp(f, (x,), (x,))


CASES = [vmap_batches_over_leading_axis, jvp_forward_mode, jvp_linear_map, vmap_kwargs_and_kernel_claims,
         vmap_over_sdpa_model, vmap_pytree_arg, vmap_second_call_zero_tracing, vmap_in_axes_arity_validated,
         jvp_caches_staging, jvp_closures_in_loop_not_aliased, jvp_cache_lru_eviction_bounded,
         vmap_of_grad_per_sample_gradients, grad_of_vmap_ones_cotangent, value_and_grad_of_vmap,
         vmap_of_grad_caches_staging, vmap_rejects_container_mutation, jvp_rejects_inplace_tensor_mutation]
VALUED = [vmap_batches_over_leading_axis, jvp_forward_mode, jvp_linear_map, vmap_kwargs_and_kernel_claims,
          vmap_over_sdpa_model, vmap_pytree_arg, vmap_of_grad_per_sample_gradients, grad_of_vmap_ones_cotangent,
          value_and_grad_of_vmap]


@BOTH
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_case(case, P):
    case(P)


@pytest.mark.parametrize("case", VALUED, ids=lambda c: c.__name__)
def test_case_results_agree(case):
    np.testing.assert_allclose(case(PORT), case(JAX), rtol=1e-5, atol=1e-5)


# =============================================================================
# The batching rules on the CPU, against a loop over the slices
# =============================================================================


def _bf16(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).to(torch.bfloat16)


def _slices(t, d, V):
    """Slice i of a batched operand (``d`` its vmapped dim), the operand itself when unbatched."""
    return [t if d is None else t.select(d, i) for i in range(V)]


def _loop(fn, in_dims, args, V):
    """fn run on each slice, the results stacked at dim 0."""
    outs = [fn(*(a if not isinstance(a, torch.Tensor) else _slices(a, d, V)[i] for a, d in zip(args, in_dims)))
            for i in range(V)]
    if isinstance(outs[0], tuple):
        return tuple(None if o[0] is None else torch.stack([x[j] for x in outs]) for j, o in enumerate(zip(*outs)))
    return torch.stack(outs)


def _close(got, want, atol_frac):
    got, want = (got,) if not isinstance(got, tuple) else got, (want,) if not isinstance(want, tuple) else want
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape and g.dtype == w.dtype
        if atol_frac == 0:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=atol_frac * float(w.float().abs().max()))


V = 3
ATTN = [(0, 0, 0), (0, None, None), (1, 1, None), (2, 0, 1)]


def _qkv(in_dims, B=1, H=2, T=64, D=16, G=2):
    shapes = [(B, H, T, D), (B, G, T, D), (B, G, T, D)]
    out = []
    for i, (shape, d) in enumerate(zip(shapes, in_dims)):
        t = _bf16(*shape, seed=10 + i)
        out.append(t if d is None else torch.stack([_bf16(*shape, seed=20 + 3 * i + j) for j in range(V)], d))
    return out


@pytest.mark.parametrize("in_dims", ATTN, ids=str)
def test_flash_rules_fold_slices(in_dims):
    q, k, v = _qkv(in_dims)
    for rule, wrapper in ((batching.flash_fwd, flashex.flash_attention_fwd),
                          (batching.flash_fwd_lse, flashex.flash_attention_fwd_lse),
                          (batching.legacy_fwd, flashex.legacy_flash_fwd)):
        got = torch.func.vmap(lambda a, b, c: rule(a, b, c, True, 0.25), in_dims=in_dims)(q, k, v)
        want = _loop(lambda a, b, c: wrapper(a, b, c, causal=True, scale=0.25), in_dims, (q, k, v), V)
        _close(got, want, 2.0 ** -7)


@pytest.mark.parametrize("in_dims", ATTN, ids=str)
def test_flash_backward_rules_fold_slices(in_dims):
    q, k, v = _qkv(in_dims)
    dout = torch.stack([_bf16(1, 2, 64, 16, seed=40 + j) for j in range(V)])
    dims = (0,) + in_dims
    out, lse = torch.func.vmap(lambda a, b, c: batching.flash_fwd_lse(a, b, c, True, 0.25), in_dims=in_dims)(q, k, v)
    got = torch.func.vmap(lambda g, a, b, c, o, s: batching.flash_bwd(g, a, b, c, o, s, True, 0.25),
                          in_dims=dims + (0, 0))(dout, q, k, v, out, lse)
    want = _loop(lambda g, a, b, c, o, s: flashex.flash_attention_bwd(g, a, b, c, o, s, causal=True, scale=0.25),
                 dims + (0, 0), (dout, q, k, v, out, lse), V)
    _close(got, want, 2.0 ** -6)
    for rule, wrapper in ((batching.flash_bwd_recompute, flashex.flash_attention_bwd_recompute),
                          (batching.legacy_bwd, flashex.legacy_flash_bwd)):
        got = torch.func.vmap(lambda g, a, b, c: rule(g, a, b, c, True, 0.25), in_dims=dims)(dout, q, k, v)
        want = _loop(lambda g, a, b, c: wrapper(g, a, b, c, causal=True, scale=0.25), dims, (dout, q, k, v), V)
        _close(got, want, 2.0 ** -6)


@pytest.mark.parametrize("d", [0, 2])
def test_rope_rule_folds_slices(d):
    x = torch.stack([_bf16(2, 3, 16, 8, seed=j) for j in range(V)], d)
    cos, sin = _bf16(16, 8, seed=7), _bf16(16, 8, seed=8)
    got = torch.func.vmap(batching.rope, in_dims=(d, None, None))(x, cos, sin)
    _close(got, _loop(fusedex.apply_rope, (d, None, None), (x, cos, sin), V), 0)
    # A cos table a slice (per-sample positions), sin shared: each slice's
    # rows rotate by their own table, bit for bit.
    coses = torch.stack([_bf16(16, 8, seed=50 + j) for j in range(V)])
    got = torch.func.vmap(batching.rope, in_dims=(d, 0, None))(x, coses, sin)
    _close(got, _loop(fusedex.apply_rope, (d, 0, None), (x, coses, sin), V), 0)


@pytest.mark.parametrize("dims", [(0, 0), (1, None), (0, 0, 0)], ids=str)
def test_cross_entropy_rules_fold_slices(dims):
    logits = torch.stack([torch.randn(6, 11, generator=torch.Generator().manual_seed(j)) for j in range(V)],
                         dims[0])
    target = torch.tensor([1, 3, -100, 10, 0, 5])
    if dims[1] is not None:
        target = torch.stack([target.roll(j) for j in range(V)])
    if len(dims) == 2:
        got = torch.func.vmap(lambda x, t: batching.ce_rows(x, t, -100), in_dims=dims)(logits, target)
        want = _loop(lambda x, t: fusedex.cross_entropy_rows(x, t, -100), dims, (logits, target), V)
    else:
        scale = torch.rand(V, 6, generator=torch.Generator().manual_seed(3))
        got = torch.func.vmap(batching.ce_bwd, in_dims=dims)(logits, target, scale)
        want = _loop(fusedex.cross_entropy_bwd, dims, (logits, target, scale), V)
    _close(got, want, 0)


@pytest.mark.parametrize("layer_norm", [False, True], ids=["rms", "ln"])
@pytest.mark.parametrize("d", [0, 1])
def test_norm_rules_keep_dw_per_slice(layer_norm, d):
    """The backward's dw (and db) come a row a slice, (V, D): a fold would
    sum them over the slices."""
    x = torch.stack([_bf16(2, 5, 24, seed=j) for j in range(V)], d)
    g = torch.stack([_bf16(2, 5, 24, seed=9 + j) for j in range(V)], d)
    w, b = _bf16(24, seed=30), (_bf16(24, seed=31) if layer_norm else None)
    got = torch.func.vmap(lambda a: batching.norm_fwd(a, w, b, 1e-5, layer_norm), in_dims=d)(x)
    want = _loop(lambda a: normex.norm_fwd_plain(a, w, b, 1e-5, layer_norm=layer_norm), (d,), (x,), V)
    _close(got, want, 0)
    got = torch.func.vmap(lambda gg, a: batching.norm_bwd(gg, a, w, 1e-5, layer_norm, layer_norm, 1),
                          in_dims=(d, d), out_dims=(0, 0, 0 if layer_norm else None))(g, x)
    want = _loop(lambda gg, a: normex.norm_bwd_plain(gg, a, w, 1e-5, layer_norm=layer_norm, with_bias=layer_norm),
                 (d, d), (g, x), V)
    assert got[1].shape == (V, 24)
    _close(got[:1], want[:1], 0)
    _close(got[1:], want[1:], 1e-6)  # the segments' column sums: the same rows, another summation order


def test_norm_backward_nested_vmap_segments():
    x = _bf16(2, V, 4, 16, seed=1)
    g = _bf16(2, V, 4, 16, seed=2)
    w = _bf16(16, seed=3)
    inner = torch.func.vmap(lambda gg, a: batching.norm_bwd(gg, a, w, 1e-6, False, False, 1), in_dims=(0, 0),
                            out_dims=(0, 0, None))
    dx, dw, db = torch.func.vmap(inner, in_dims=(1, 1), out_dims=(0, 0, None))(g, x)
    assert dw.shape == (V, 2, 16) and db is None
    for i in range(V):
        for j in range(2):
            wd = normex.norm_bwd_plain(g[j, i], x[j, i], w, 1e-6, layer_norm=False)
            assert torch.equal(dx[i, j], wd[0])
            torch.testing.assert_close(dw[i, j], wd[1], rtol=0, atol=1e-6 * float(wd[1].abs().max()))


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(next(a.shape for a in args if isinstance(a, torch.Tensor)))
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_one_wrapper_call_a_call_site(monkeypatch):
    """Under vmap each claimed kernel's wrapper is called once a call site,
    on the folded batch, never once a slice."""
    calls = {n: _spy(monkeypatch, m, n) for m, n in ((flashex, "flash_attention_fwd_lse"),
                                                     (flashex, "flash_attention_bwd"),
                                                     (fusedex, "apply_rope"), (fusedex, "cross_entropy_bwd"))}
    cfg = tgpt.name_to_config("llama-hs100-tiny")
    params = tgpt.init_params(cfg, dtype=torch.bfloat16, seed=0, device="cpu")
    idx = torch.randint(0, cfg.vocab_size, (V, 1, 128), generator=torch.Generator().manual_seed(0))
    tt.vmap(tt.grad(lambda p, i, t: tgpt.loss_fn(p, i, t, cfg), device="cpu"), in_axes=(None, 0, 0))(params, idx,
                                                                                                     idx.roll(1, -1))
    n = cfg.n_layer
    assert len(calls["flash_attention_fwd_lse"]) == len(calls["flash_attention_bwd"]) == n
    assert len(calls["apply_rope"]) == 4 * n and len(calls["cross_entropy_bwd"]) == 1
    assert calls["flash_attention_fwd_lse"][0][0] == V and calls["cross_entropy_bwd"][0][0] == V * 128


def test_kernel_without_a_rule_raises():
    """The int8 linear and masked attention, refused here before their rules
    existed, now equal a loop over the slices; a claim of an executor with no
    batching rule (one a user registers) still raises, naming it."""
    from thunder_tpu_torch.extend import OperatorExecutor, register_executor

    x = torch.randn(V, 4, 64, generator=torch.Generator().manual_seed(0))
    w = torch.randn(8, 64, generator=torch.Generator().manual_seed(1))
    lin = lambda a, b: ttorch.linear(a, b)  # noqa: E731
    got = tt.vmap(lin, in_axes=(0, None), device="cpu", executors=["quant", "torch"])(x, w)
    one = tt.jit(lin, device="cpu", executors=["quant", "torch"])
    _close(got, torch.stack([one(x[i], w) for i in range(V)]), 0)
    q = _bf16(V, 1, 2, 64, 16)
    mask = torch.ones(1, 1, 64, 64, dtype=torch.bool).tril()
    attn = lambda a, m: ttorch.scaled_dot_product_attention(a, a, a, attn_mask=m)  # noqa: E731
    got = tt.vmap(attn, in_axes=(0, None), device="cpu")(q, mask)
    one = tt.jit(attn, device="cpu")
    _close(got, torch.stack([one(q[i], mask) for i in range(V)]), 0)
    ex = OperatorExecutor("no_rule_for_vmap")
    register_executor(ex)
    ex.register_implementation("torch.tanh", fn=torch.tanh, checker=lambda a: True)
    with pytest.raises(NotImplementedError, match="no_rule_for_vmap executor's tanh has no batching rule"):
        tt.vmap(lambda a: ttorch.tanh(a), device="cpu", executors=["no_rule_for_vmap", "torch"])(x)


def test_wrappers_refuse_batched_and_dual_tensors():
    x, cos, sin = _bf16(1, 2, 16, 8), _bf16(16, 8, seed=1), _bf16(16, 8, seed=2)
    with pytest.raises(NotImplementedError, match="rope: the kernel was given a tensor under a function transform"):
        torch.func.vmap(lambda a: fusedex.apply_rope(a, cos, sin))(torch.stack([x] * 2))
    with forward_ad.dual_level():
        dual = forward_ad.make_dual(x.float(), torch.ones(x.shape))
        with pytest.raises(NotImplementedError, match="rope"):
            fusedex.apply_rope(dual, cos.float(), sin.float())
    with pytest.raises(NotImplementedError, match="rms_fwd"):
        torch.func.jvp(lambda a: normex.rms_norm_fwd(a, torch.ones(8)), (x.float(),), (torch.ones(x.shape),))


def test_jvp_claims_no_kernel(monkeypatch):
    """jvp claims with the torch executor alone, decided before tracing: a
    bf16 attention and cross-entropy program reaches no kernel wrapper."""
    calls = [_spy(monkeypatch, m, n) for m, n in ((flashex, "flash_attention_fwd"), (fusedex, "cross_entropy_rows"),
                                                  (fusedex, "apply_rope"))]
    q = _bf16(1, 2, 64, 16)
    tgt = torch.randint(0, 16, (128,), generator=torch.Generator().manual_seed(0))

    def f(a):
        o = ttorch.scaled_dot_product_attention(a, a, a, is_causal=True)
        return ttorch.cross_entropy(ttorch.reshape(o, (128, 16)).float(), tgt)

    p, t = tt.jvp(f, (q,), (torch.ones_like(q),), device="cpu")
    assert all(c == [] for c in calls)
    src = tt.compile_stats(tt.jvp).last_traces[-1].python()
    assert "flash_" not in src and "fused_" not in src
    assert "torch executor only" in tt.compile_stats(tt.jvp).executors_note
    eps = 1e-2
    fd = (float(tt.jit(f, device="cpu", executors=["torch"])((q.float() + eps).bfloat16()))
          - float(tt.jit(f, device="cpu", executors=["torch"])((q.float() - eps).bfloat16()))) / (2 * eps)
    assert np.isfinite(float(p)) and abs(float(t) - fd) <= 0.1 * abs(fd) + 0.1


@BOTH
def test_keyed_draws_are_shared_by_the_slices(P):
    """A draw under vmap takes one key: every slice draws the same numbers,
    as under jax.vmap."""
    from thunder_tpu.core import devices as jdevices
    from thunder_tpu_torch.core import devices as tdevices

    dev = tdevices.Device("cpu") if P is PORT else jdevices.Device()

    def f(x):
        return P.clang.add(x, P.clang.uniform((4, 5), 0.0, 1.0, device=dev, dtype=None))

    xs = np.arange(V * 20, dtype=np.float32).reshape(V, 4, 5)
    out = _np(P.vmap(f)(xs))
    noise = out - xs
    assert ((noise >= 0) & (noise < 1)).all() and np.ptp(noise) > 0
    for i in range(1, V):
        np.testing.assert_allclose(noise[i], noise[0], atol=1e-5)


# =============================================================================
# Per-sample gradients of the GPT loss
# =============================================================================


def _named(params, flatten, grads):
    def paths(x, pre):
        if isinstance(x, dict):
            return {k: paths(v, f"{pre}.{k}") for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [paths(v, f"{pre}[{i}]") for i, v in enumerate(x)]
        return pre

    return dict(zip(flatten(paths(params, "p"))[0], grads))


@pytest.fixture(scope="module")
def gpt_inputs():
    tcfg = tgpt.name_to_config("llama-hs100-tiny")
    jcfg = jgpt.GPTConfig(**dataclasses.asdict(tcfg))
    jparams = jgpt.init_params(jcfg, dtype=thunder_tpu.core.dtypes.bfloat16, seed=0)
    tparams = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.RandomState(0)
    idx = rng.randint(0, tcfg.vocab_size, (2, 1, 128)).astype(np.int32)
    tgt = rng.randint(0, tcfg.vocab_size, (2, 1, 128)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, idx, tgt


@pytest.mark.parametrize("executors", [None, ["norm", "flash", "fused", "torch"]], ids=["default", "norm"])
def test_per_sample_grads_equal_each_slices_grad(gpt_inputs, executors):
    """vmap(grad(loss)) against grad(loss) at B = 1 on each sample, the jit
    path's wrappers: bit for bit on the CPU, where each rule's fold runs the
    plain versions row by row (attention, a batch row at a time)."""
    _, tcfg, _, tparams, idx, tgt = gpt_inputs
    g = tt.grad(lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg), device="cpu", executors=executors)
    per_sample = tt.vmap(g, in_axes=(None, 0, 0))(tparams, idx, tgt)
    for s in range(2):
        for got, want in zip(per_sample, g(tparams, idx[s], tgt[s])):
            torch.testing.assert_close(got[s].float(), want.float(), rtol=0, atol=2.0 ** -7 * float(
                want.float().abs().max()) + 1e-30)


def test_per_sample_grads_match_the_jax_package(gpt_inputs, monkeypatch):
    monkeypatch.setenv("THUNDER_FLASH_FORCE", "1")
    jcfg, tcfg, jparams, tparams, idx, tgt = gpt_inputs
    jg = thunder_tpu.vmap(thunder_tpu.grad(lambda p, i, t: jgpt.loss_fn(p, i, t, jcfg)), in_axes=(None, 0, 0))(
        jparams, idx, tgt)
    tg = tt.vmap(tt.grad(lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg), device="cpu"), in_axes=(None, 0, 0))(
        tparams, idx, tgt)
    want = _named(jparams, jtree_flatten, [np.asarray(g, np.float32) for g in jg])
    got = _named(tparams, tree_flatten, [g.float().numpy() for g in tg])
    assert set(got) == set(want)
    for name in got:
        assert got[name].shape == want[name].shape == (2,) + want[name].shape[1:]
        for s in range(2):
            rel = np.linalg.norm(got[name][s] - want[name][s]) / np.linalg.norm(want[name][s])
            assert rel <= 2.0 ** -5, f"{name}[{s}]: norm-relative error {rel}"


def test_grad_of_vmap_sums_the_per_sample_grads(gpt_inputs):
    _, tcfg, _, tparams, idx, tgt = gpt_inputs
    f = lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg)  # noqa: E731
    per_sample = tt.vmap(tt.grad(f, device="cpu"), in_axes=(None, 0, 0))(tparams, idx, tgt)
    vals, summed = tt.value_and_grad(tt.vmap(f, in_axes=(None, 0, 0), device="cpu"))(tparams, idx, tgt)
    assert vals.shape == (2,)
    for s in range(2):
        torch.testing.assert_close(vals[s].float(), tt.jit(f, device="cpu")(tparams, idx[s], tgt[s]).float(),
                                   rtol=0, atol=0)
    for a, b in zip(summed, per_sample):
        torch.testing.assert_close(a.float(), b.sum(0).float(), rtol=0, atol=0)


# =============================================================================
# The torch executor's in-place prims, in forms that work under vmap
# =============================================================================


def test_embedding_backward_bits_unchanged_and_batched():
    """``_embedding_backward`` adds out of place now: the same bits as the
    in-place add it replaces, and batched rows add into the unbatched zeros."""
    from thunder_tpu_torch.executors import torchex

    grad = torch.randn(2, 64, 24, generator=torch.Generator().manual_seed(0))
    idx = torch.randint(0, 10, (2, 64), generator=torch.Generator().manual_seed(1))
    old = torch.zeros(10, 24).index_add_(0, idx.reshape(-1), grad.reshape(-1, 24))
    assert torch.equal(torchex._embedding_backward(grad, idx, 10, 24), old)
    gs = torch.stack([grad, grad * 2, -grad])
    got = torch.func.vmap(lambda g: torchex._embedding_backward(g, idx, 10, 24))(gs)
    for i in range(3):
        assert torch.equal(got[i], torchex._embedding_backward(gs[i], idx, 10, 24))


def test_interior_pad_bits_unchanged_and_batched():
    from thunder_tpu_torch.executors import torchex

    a = torch.randn(3, 4, generator=torch.Generator().manual_seed(2))
    config = [(1, 0, 2), (0, 2, 1)]
    old = torch.full((7, 7), 0.5)
    old[::3, ::2] = a
    old = torch.nn.functional.pad(old, [0, 2, 1, 0], value=0.5)
    assert torch.equal(torchex._pad(a, 0.5, config), old)
    batch = torch.stack([a, a + 1])
    got = torch.func.vmap(lambda x: torchex._pad(x, 0.5, config))(batch)
    assert torch.equal(got[1], torchex._pad(a + 1, 0.5, config))


def test_setitem_of_a_batched_value_matches_the_plain_write():
    from thunder_tpu_torch.executors import torchex

    a = torch.zeros(4, 6)
    vals = torch.randn(3, 2, 6, generator=torch.Generator().manual_seed(3))
    for key in ((slice(1, 3),), (torch.tensor([3, 0]),), (slice(None), )):
        shape = a[key].shape
        v = vals[:, :shape[0]] if len(shape) == 2 and shape[0] <= 2 else torch.randn(3, *shape)
        got = torch.func.vmap(lambda x: torchex._setitem(a, key, x))(v)
        for i in range(3):
            want = a.clone()
            want[key] = v[i]
            assert torch.equal(got[i], want)
            assert torch.equal(torchex._setitem(a, key, v[i]), want)
