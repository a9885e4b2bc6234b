"""The last batching rules (masked attention, the int8 linear, a norm weight and rope tables a slice) on the CPU.

Each rule of ``executors/batching.py`` under ``torch.func.vmap`` against a
loop over the slices of the wrapper's plain version: masked attention with
the slices' verdicts mixed (0, 1, 2), forward and backward, given or read;
the int8 linear with the activation, the weight or both batched (each
slice's amax and scale its own); RMSNorm and LayerNorm with a weight and bias
a slice; rope with cos/sin a slice; nested vmaps and a vmapped dim that is
not the first. On the CPU a wrapper runs its plain version on the folded
tensors, so these hold the folding: bit for bit where the plain version
computes a row, a problem or a slice at a time (rope, the norms' y and dx,
quantization, the int8 product), within 2^-7 of the largest element for
attention, whose plain products take another summation order at another
batch size, and within 1e-6 of it for a norm's dw (the same rows, summed in
another order).

Then through both packages, on the same numpy-seeded inputs: per-sample
gradients of llama-hs100-tiny (open_llama_3b's head size, bf16, 2 layers,
T = 128) under a left-padded 4-D causal mask, the port's ``vmap(grad)``
against the JAX package's (norm-relative 2^-5, as the unmasked case in
``test_torch_port_transforms.py``); an int8 linear under vmap with the
activation batched (the same q, scales and int32 sums: within one bf16 ulp
of the largest element, the f32 rescale rounded once more to bf16); and a
two-model ensemble forward (stacked weights under ``+norm``, rope tables
offset by each slice's position) against the JAX package's vmap
(norm-relative 2^-6 on bf16 logits).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu
import thunder_tpu.core.dtypes as jdtypes
import thunder_tpu.torch as jtorch
from thunder_tpu.core.pytree import tree_flatten as jtree_flatten
from thunder_tpu.models import gpt as jgpt

import thunder_tpu_torch as tt
import thunder_tpu_torch.torch as ttorch
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.executors import batching, flashex, fusedex, normex, quantex
from thunder_tpu_torch.models import gpt as tgpt

V = 3


def jax_tree_map_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_stack(trees):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def _bf16_np(t):
    return t.float().numpy().astype(jnp.bfloat16)


def _bf16(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)).to(torch.bfloat16)


def _close(got, want, frac):
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if frac == 0:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=frac * float(w.float().abs().max()) + 1e-30)


def _masks(T, pad):
    """(3, 1, 1, T, T) bool masks whose verdicts are 0 (a random mask: the
    exact branch), 1 (left-padded, every valid key) and 2 (left-padded causal)."""
    kv = torch.arange(T) >= pad
    full = kv[None, :].expand(T, T)
    rnd = torch.from_numpy(np.random.RandomState(3).rand(T, T) > 0.3)
    return torch.stack([rnd, full, torch.ones(T, T, dtype=torch.bool).tril() & full])[:, None, None]


# =============================================================================
# Masked attention (rows 8-9)
# =============================================================================


def _qkv(B=1, H=2, G=2, T=64, D=16):
    return [torch.stack([_bf16(B, h, T, D, seed=10 * i + j) for j in range(V)]) for i, h in enumerate((H, G, G, H))]


@pytest.mark.parametrize("verdicts", [None, (0, 1, 2)], ids=["read", "given"])
def test_masked_rule_takes_each_slices_verdict(verdicts):
    masks = _masks(64, 16)
    q, k, v, g = _qkv()
    assert [int(flashex.mask_verdict(masks[j], 1, 64, 64, False)) for j in range(V)] == [0, 1, 2]
    reads = flashex.mask_plan.host_reads
    out = torch.func.vmap(lambda a, b, c, m: batching.masked_fwd(a, b, c, m, False, 0.25, verdicts, 1))(q, k, v, masks)
    grads = torch.func.vmap(lambda gg, a, b, c, m: batching.masked_bwd(gg, a, b, c, m, False, 0.25, verdicts, 1))(
        g, q, k, v, masks)
    assert flashex.mask_plan.host_reads - reads == (2 if verdicts is None else 0)
    for j in range(V):
        _close(out[j], flashex._sdpa_impl(q[j], k[j], v[j], attn_mask=masks[j].clone(), scale=0.25), 2.0 ** -7)
        want = flashex._sdpa_bwd_impl(g[j], q[j], k[j], v[j], masks[j].clone(), False, 0.25)
        _close(tuple(x[j] for x in grads), tuple(want), 2.0 ** -6)


def test_masked_rule_counts_one_launch_a_verdict(monkeypatch):
    masks = _masks(64, 16)[[1, 2, 2]]
    q, k, v, _ = _qkv()
    calls = []
    for name in ("sdpa_exact", "flash_attention_fwd_seg"):
        orig = getattr(flashex, name)
        monkeypatch.setattr(flashex, name, lambda *a, _o=orig, _n=name, **kw: (calls.append((_n, a[0].shape[0])),
                                                                                _o(*a, **kw))[1])
    torch.func.vmap(lambda a, b, c, m: batching.masked_fwd(a, b, c, m, False, 0.25, (1, 2, 2), 1))(q, k, v, masks)
    assert sorted(calls) == [("flash_attention_fwd_seg", 1), ("flash_attention_fwd_seg", 2)]


def test_masked_rule_nested_and_non_leading_dims():
    """Two vmap levels (a key-padding mask batched at the outer level only),
    then a vmapped dim that is not the first."""
    T = 64
    q = torch.stack([_bf16(2, 1, 2, T, 16, seed=j) for j in range(V)], 1)  # (2, V, 1, 2, T, 16)
    keypad = torch.stack([torch.arange(T) >= p for p in (0, 8)])  # (2, T): a mask a outer slice
    inner = torch.func.vmap(lambda a, m: batching.masked_fwd(a, a, a, m, False, 0.25, None, 1), in_dims=(0, None))
    got = torch.func.vmap(inner, in_dims=(0, 0))(q, keypad)
    for i in range(2):
        for j in range(V):
            want = flashex._sdpa_impl(q[i, j], q[i, j], q[i, j], attn_mask=keypad[i].clone(), scale=0.25)
            _close(got[i, j], want, 2.0 ** -7)
    masks = _masks(T, 16)
    qs = _qkv()[0].movedim(0, 2)  # (1, 2, V, T, 16)
    got = torch.func.vmap(lambda a, m: batching.masked_fwd(a, a, a, m, False, 0.25, None, 1), in_dims=(2, 0))(
        qs, masks)
    for j in range(V):
        _close(got[j], flashex._sdpa_impl(qs[:, :, j], qs[:, :, j], qs[:, :, j], attn_mask=masks[j].clone(),
                                          scale=0.25), 2.0 ** -7)


# =============================================================================
# The int8 linear
# =============================================================================


@pytest.mark.parametrize("axes", [(0, None), (None, 0), (0, 0), (1, None)], ids=str)
def test_quant_linear_scales_each_slice_as_its_own_call(axes, monkeypatch):
    x = torch.stack([_bf16(2, 5, 128, seed=j) * (j + 1) for j in range(V)], axes[0] or 0)
    w = torch.stack([_bf16(48, 128, seed=10 + j) * 0.05 for j in range(V)])
    a = x if axes[0] is not None else x[0]
    b = w if axes[1] is not None else w[0]
    lin = lambda p, q: ttorch.linear(p, q)  # noqa: E731
    calls = []
    monkeypatch.setattr(quantex, "int8_gemm", lambda *args, _f=quantex.int8_gemm: (calls.append(1), _f(*args))[1])
    got = tt.vmap(lin, in_axes=axes, device="cpu", executors=["quant", "torch"])(a, b)
    assert len(calls) == 1  # one product for the slices, through the quant claim's rule
    one = tt.jit(lin, device="cpu", executors=["quant", "torch"])
    for j in range(V):
        want = one(a.select(axes[0], j) if axes[0] is not None else a, b[j] if axes[1] is not None else b)
        assert torch.equal(got[j], want)


def test_quant_linear_reads_the_wrappers_in_their_seats(monkeypatch):
    """Outside vmap the quant claim calls whatever sits in ``quantex``'s
    seats at each call (``chip_smoke.py`` phase 15 puts the plain versions
    and a planted fault there), not the wrappers it was defined beside."""
    calls = []
    for name in ("quantize_tensor", "quantize_rows", "int8_gemm"):
        orig = getattr(quantex, name)
        monkeypatch.setattr(quantex, name, lambda *a, _o=orig, _n=name: (calls.append(_n), _o(*a))[1])
    tt.jit(lambda a, b: ttorch.linear(a, b), device="cpu", executors=["quant", "torch"])(
        _bf16(4, 128, seed=1), _bf16(8, 128, seed=2))
    assert sorted(calls) == ["int8_gemm", "quantize_rows", "quantize_tensor"]


def test_quant_rules_segments_and_problems():
    """The wrappers' own batch: ``quantize_tensor`` in V segments equals V
    calls, ``int8_gemm`` over P problems equals P products, and the GEMM rule
    nests (problems multiply level by level)."""
    x = torch.stack([_bf16(4, 64, seed=j) * (j + 1) for j in range(V)])
    q, s = quantex.quantize_tensor(x.reshape(-1, 64), 127.0, V)
    assert s.shape == (V,)
    for j in range(V):
        qj, sj = quantex.quantize_tensor(x[j], 127.0)
        assert torch.equal(q.reshape(V, 4, 64)[j], qj) and torch.equal(s[j], sj)
    q2, s2 = torch.func.vmap(lambda t: batching.quant_tensor(t, 127.0))(x)
    assert torch.equal(q2, q.reshape(V, 4, 64)) and torch.equal(s2, s)
    gen = torch.Generator().manual_seed(0)
    qa = torch.randint(-127, 128, (2, V, 6, 64), generator=gen, dtype=torch.int8)
    qw = torch.randint(-127, 128, (V, 8, 64), generator=gen, dtype=torch.int8)
    sc = torch.rand(2, V, 8, generator=gen) * 1e-2
    inner = torch.func.vmap(lambda a, w, c: batching.int8_gemm(a, w, c, None, torch.float32), in_dims=(0, 0, 0))
    got = torch.func.vmap(inner, in_dims=(0, None, 0))(qa, qw, sc)
    for i in range(2):
        for j in range(V):
            assert torch.equal(got[i, j], quantex.int8_gemm_plain(qa[i, j], qw[j], sc[i, j], None, torch.float32))


# =============================================================================
# A norm weight and rope tables a slice
# =============================================================================


@pytest.mark.parametrize("layer_norm", [False, True], ids=["rms", "ln"])
@pytest.mark.parametrize("d", [0, 1])
def test_norm_rules_with_a_weight_a_slice(layer_norm, d):
    x = torch.stack([_bf16(2, 5, 24, seed=j) for j in range(V)], d)
    g = torch.stack([_bf16(2, 5, 24, seed=9 + j) for j in range(V)], d)
    w = torch.stack([_bf16(24, seed=30 + j) for j in range(V)])
    b = _bf16(24, seed=40) if layer_norm else None  # a shared bias beside a weight a slice
    y = torch.func.vmap(lambda a, ww: batching.norm_fwd(a, ww, b, 1e-5, layer_norm), in_dims=(d, 0))(x, w)
    dx, dw, db = torch.func.vmap(lambda gg, a, ww: batching.norm_bwd(gg, a, ww, 1e-5, layer_norm, layer_norm, 1),
                                 in_dims=(d, d, 0), out_dims=(0, 0, 0 if layer_norm else None))(g, x, w)
    for j in range(V):
        xj, gj = x.select(d, j), g.select(d, j)
        _close(y[j], normex.norm_fwd_plain(xj, w[j], b, 1e-5, layer_norm=layer_norm), 0)
        wdx, wdw, wdb = normex.norm_bwd_plain(gj, xj, w[j], 1e-5, layer_norm=layer_norm, with_bias=layer_norm)
        _close(dx[j], wdx, 0)
        _close(dw[j], wdw, 1e-6)
        if layer_norm:
            _close(db[j], wdb, 1e-6)


@pytest.mark.parametrize("batched", ["outer", "inner"])
def test_norm_rule_nested_weight_at_one_level(batched):
    """Two levels, the weight batched at one of them: the rows are the
    outer slices' runs of inner slices, and the weight is expanded to them."""
    x = _bf16(2, V, 4, 16, seed=1)
    ws = _bf16(2 if batched == "outer" else V, 16, seed=2)
    if batched == "outer":
        inner = torch.func.vmap(lambda a, w: batching.norm_fwd(a, w, None, 1e-6, False), in_dims=(0, None))
        got = torch.func.vmap(inner, in_dims=(0, 0))(x, ws)
    else:
        inner = torch.func.vmap(lambda a, w: batching.norm_fwd(a, w, None, 1e-6, False), in_dims=(0, 0))
        got = torch.func.vmap(inner, in_dims=(0, None))(x, ws)
    for i in range(2):
        for j in range(V):
            w = ws[i] if batched == "outer" else ws[j]
            _close(got[i, j], normex.norm_fwd_plain(x[i, j], w, None, 1e-6, layer_norm=False), 0)


@pytest.mark.parametrize("d", [0, 2])
def test_rope_rule_with_tables_a_slice(d):
    x = torch.stack([_bf16(2, 3, 16, 8, seed=j) for j in range(V)], d)
    cos = torch.stack([_bf16(16, 8, seed=20 + j) for j in range(V)])
    sin = torch.stack([_bf16(16, 8, seed=30 + j) for j in range(V)])
    got = torch.func.vmap(batching.rope, in_dims=(d, 0, 0))(x, cos, sin)
    for j in range(V):
        _close(got[j], fusedex.rope_plain(x.select(d, j), cos[j], sin[j]), 0)
    # nested: the tables batched at the outer level, x at both
    xs = _bf16(2, V, 1, 2, 16, 8, seed=5)
    inner = torch.func.vmap(batching.rope, in_dims=(0, None, None))
    got = torch.func.vmap(inner, in_dims=(0, 0, 0))(xs, cos[:2], sin[:2])
    for i in range(2):
        for j in range(V):
            _close(got[i, j], fusedex.rope_plain(xs[i, j], cos[i], sin[i]), 0)


# =============================================================================
# Through both packages
# =============================================================================


def _forward(M, L, params, idx, mask, cos, sin, cfg):
    """The GPT forward of ``models/gpt.py`` (either package's module ``M``,
    its torch language ``L``) with an attention mask and the rope tables as
    inputs: the functional form a padded batch and per-sample positions need."""
    B, T = idx.shape
    H, G, hs = cfg.n_head, cfg.query_groups, cfg.head_size
    x = L.embedding(idx, params["wte"])
    for p in params["blocks"]:
        a = p["attn"]
        qkv = L.linear(M._norm(x, p["norm_1"], cfg), a["qkv_w"], a.get("qkv_b"))
        q, k, v = (L.permute(L.reshape(t, (B, T, n, hs)), (0, 2, 1, 3)) for t, n in
                   ((qkv[..., :H * hs], H), (qkv[..., H * hs:(H + G) * hs], G), (qkv[..., (H + G) * hs:], G)))
        y = L.scaled_dot_product_attention(L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v, attn_mask=mask,
                                           enable_gqa=G != H)
        x = x + L.linear(L.reshape(L.permute(y, (0, 2, 1, 3)), (B, T, H * hs)), a["proj_w"], a.get("proj_b"))
        x = x + M._mlp(M._norm(x, p["norm_2"], cfg), p["mlp"], cfg)
    return L.linear(M._norm(x, params["ln_f"], cfg), params["lm_head_w"])


def _loss(M, L, params, idx, tgt, mask, cos, sin, cfg):
    logits = _forward(M, L, params, idx, mask, cos, sin, cfg)
    B, T, Vv = logits.shape
    return L.cross_entropy(L.reshape(logits.float(), (B * T, Vv)), L.reshape(tgt, (B * T,)))


def _tables(T, cfg, offset=0):
    """cos/sin (T, rope_n_elem) of positions offset .. offset + T, in bf16 values."""
    n = cfg.rope_n_elem
    theta = cfg.rope_base ** (-np.arange(0, n // 2, dtype=np.float64) * 2 / n)
    f = np.arange(offset, offset + T, dtype=np.float64)[:, None] * theta[None]
    emb = np.concatenate([f, f], 1)
    return [torch.from_numpy(t.astype(np.float32)).to(torch.bfloat16) for t in (np.cos(emb), np.sin(emb))]


@pytest.fixture(scope="module")
def tiny():
    tcfg = tgpt.name_to_config("llama-hs100-tiny")
    assert not tcfg.parallel_residual
    jcfg = jgpt.GPTConfig(**dataclasses.asdict(tcfg))
    return jcfg, tcfg


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_masked_per_sample_grads_match_the_jax_package(tiny, monkeypatch):
    """vmap(grad(loss)) over a padded batch: sample 0 left-padded by 32
    tokens (mask 0, target ignored), sample 1 whole; both causal 4-D masks."""
    monkeypatch.setenv("THUNDER_FLASH_FORCE", "1")
    jcfg, tcfg = tiny
    T = 128
    jparams = jgpt.init_params(jcfg, dtype=jdtypes.bfloat16, seed=0)
    tparams = tgpt.params_from_jax(jax_tree_map_np(jparams), device="cpu")
    rng = np.random.RandomState(0)
    idx = rng.randint(0, tcfg.vocab_size, (2, 1, T)).astype(np.int64)
    tgt = rng.randint(0, tcfg.vocab_size, (2, 1, T)).astype(np.int64)
    tgt[0, 0, :32] = -100
    kv = np.stack([np.arange(T) >= 32, np.ones(T, bool)])
    mask = (np.tril(np.ones((T, T), bool))[None] & kv[:, None, :])[:, None, None]  # (2, 1, 1, T, T)
    cos, sin = _tables(T, tcfg)
    jf = thunder_tpu.vmap(thunder_tpu.grad(lambda p, i, t, m, c, s: _loss(jgpt, jtorch, p, i, t, m, c, s, jcfg)),
                          in_axes=(None, 0, 0, 0, None, None))
    jg = jf(jparams, idx, tgt, mask, _bf16_np(cos), _bf16_np(sin))
    tf = tt.vmap(tt.grad(lambda p, i, t, m, c, s: _loss(tgpt, ttorch, p, i, t, m, c, s, tcfg), device="cpu"),
                 in_axes=(None, 0, 0, 0, None, None))
    tg = tf(tparams, torch.from_numpy(idx), torch.from_numpy(tgt), torch.from_numpy(mask), cos, sin)
    want = [_np(g) for g in jtree_flatten(jg)[0]]
    got = [_np(g) for g in tree_flatten(tg)[0]]
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        for s in range(2):
            if np.linalg.norm(b[s]) > 0:
                assert _rel(a[s], b[s]) <= 2.0 ** -5
    src = tt.compile_stats(tf).last_traces[-1].python()
    assert "verdict=(2, 2)" in src  # each slice's verdict, given to the claims


def test_quant_linear_under_vmap_matches_the_jax_package(monkeypatch):
    """The JAX package's vmap takes its default executors: the quant
    executor is put first among them here, and its result is first held to
    its own jit of each slice (so it did quantize each slice on its own)."""
    from thunder_tpu import extend as jextend

    monkeypatch.setattr(jextend, "_default_executors", [jextend.get_executor("quant"), jextend.get_executor("jax")])
    rng = np.random.RandomState(0)
    x = (rng.randn(V, 4, 128) * np.arange(1, V + 1)[:, None, None]).astype(np.float32)
    w = (rng.randn(48, 128) * 0.05).astype(np.float32)
    xb, wb = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    lin_t, lin_j = (lambda a, b: ttorch.linear(a, b)), (lambda a, b: jtorch.linear(a, b))
    got = tt.vmap(lin_t, in_axes=(0, None), device="cpu", executors=["quant", "torch"])(xb, wb)
    want = np.asarray(thunder_tpu.vmap(lin_j, in_axes=(0, None))(_bf16_np(xb), _bf16_np(wb)), np.float32)
    jone = thunder_tpu.jit(lin_j, executors=["quant", "jax"])
    for j in range(V):
        np.testing.assert_array_equal(want[j], np.asarray(jone(_bf16_np(xb[j]), _bf16_np(wb)), np.float32))
        np.testing.assert_allclose(_np(got[j]), want[j], rtol=0, atol=2.0 ** -7 * np.abs(want[j]).max())


def test_ensemble_forward_matches_the_jax_package(tiny, monkeypatch):
    """Two models stacked (under +norm: a norm weight a slice), each with its
    own position offset (rope tables a slice), one causal mask shared."""
    monkeypatch.setenv("THUNDER_FLASH_FORCE", "1")
    jcfg, tcfg = tiny
    T = 128
    jps = [jgpt.init_params(jcfg, dtype=jdtypes.bfloat16, seed=s) for s in (0, 1)]
    stacked = jax_stack(jps)
    tparams = tgpt.params_from_jax(jax_tree_map_np(stacked), device="cpu")
    idx = np.random.RandomState(1).randint(0, tcfg.vocab_size, (1, T)).astype(np.int64)
    mask = np.tril(np.ones((T, T), bool))[None, None]
    tabs = [_tables(T, tcfg, offset) for offset in (0, 64)]
    cos = torch.stack([c for c, _ in tabs])
    sin = torch.stack([s for _, s in tabs])
    jout = thunder_tpu.vmap(lambda p, i, m, c, s: _forward(jgpt, jtorch, p, i, m, c, s, jcfg),
                            in_axes=(0, None, None, 0, 0))(stacked, idx, mask, _bf16_np(cos), _bf16_np(sin))
    tf = tt.vmap(lambda p, i, m, c, s: _forward(tgpt, ttorch, p, i, m, c, s, tcfg), in_axes=(0, None, None, 0, 0),
                 device="cpu", executors=["norm", "flash", "fused", "torch"])
    tout = tf(tparams, torch.from_numpy(idx), torch.from_numpy(mask), cos, sin)
    src = tt.compile_stats(tf).last_traces[-1].python()
    assert "rms_norm" in src and "apply_rope" in src
    for s in range(2):
        assert _rel(_np(tout[s]), np.asarray(jout[s], np.float32)) <= 2.0 ** -6


def test_masked_per_sample_grads_at_64_slices(monkeypatch):
    """vmap(grad) of masked attention at V = 64 (DP-SGD's usual batch), the
    slices' verdicts mixed 0/1/2, against ``grad`` of each slice alone
    (2^-6 of the largest element, as the rule's backward above); the verdict
    vector is one guard, so the same masks reuse the entry and a changed
    slice makes a new one."""
    monkeypatch.setenv("THUNDER_FLASH_FORCE", "1")
    n, T = 64, 64
    masks = torch.stack([_masks(T, 1 + j % 47)[j % 3] for j in range(n)])  # (64, 1, 1, T, T)
    x = torch.stack([_bf16(1, 2, T, 16, seed=j) for j in range(n)])
    w = _bf16(16, 16, seed=99)

    def f(w, x, m):
        q = ttorch.matmul(x, w)
        return ttorch.sum(ttorch.square(ttorch.scaled_dot_product_attention(q, x, x, attn_mask=m).float()))

    vf = tt.vmap(tt.grad(f, device="cpu"), in_axes=(None, 0, 0))
    got = vf(w, x, masks)
    src = tt.compile_stats(vf).last_traces[-1].python()
    assert f"verdict={tuple(j % 3 for j in range(n))}" in src
    one = tt.grad(f, device="cpu")
    for j in range(n):
        _close(tuple(g[j] for g in got), tuple(one(w, x[j], masks[j])), 2.0 ** -6)
    compiles = tt.compile_stats(vf).compile_count
    vf(w, x, masks)
    assert tt.compile_stats(vf).compile_count == compiles
    swapped = masks.clone()
    swapped[5] = masks[1]  # slice 5's verdict 2 becomes 1
    got = vf(w, x, swapped)
    assert tt.compile_stats(vf).compile_count == compiles + 1
    _close(tuple(g[5] for g in got), tuple(one(w, x[5], swapped[5])), 2.0 ** -6)
