"""The port's kernel modules against the JAX functions they replace, on the CPU.

On CPU tensors each wrapper of ``thunder_tpu_torch/executors/flashex.py`` and
``fusedex.py`` runs its plain PyTorch version; here that version is held
against the JAX package's kernel as the JAX package's own tests run it on the
CPU: the splash flash attention through ``thunder_tpu.jit`` with
``THUNDER_FLASH_FORCE=1`` (Pallas interpret mode), and the Pallas rope and
cross-entropy kernels through ``pallasex._rope_impl`` and ``_ce_impl``.
Inputs are made with numpy from a seed and handed to both packages.

Tolerances: float32 comparisons differ only in summation order (1e-5
relative). bf16 comparisons allow a few bf16 ulps: the JAX kernels round at
other places (q*scale is rounded to bf16 before splash, its rope multiplies
in bf16), while the port's plain versions compute in f32 and round once.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu
import thunder_tpu.torch as jtorch
from thunder_tpu.executors import flashex as jflashex
from thunder_tpu.executors import pallasex

import thunder_tpu_torch as tt
import thunder_tpu_torch.torch as ttorch
from thunder_tpu_torch.executors import flashex, fusedex


def _np(*shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _torch(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(x).to(dtype)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


# =============================================================================
# Flash attention
# =============================================================================


@pytest.fixture
def _jax_flash_on_cpu(monkeypatch):
    """Run the JAX package's splash kernel in Pallas interpret mode."""
    monkeypatch.setenv("THUNDER_FLASH_FORCE", "1")


def _jax_sdpa(q, k, v, *, causal, gqa):
    def f(q, k, v):
        return jtorch.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=gqa)

    jf = thunder_tpu.jit(f)
    out = jf(*(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)))
    assert "flash_scaled_dot_product_attention" in thunder_tpu.last_traces(jf)[-1].python()
    return _f32(out)


@pytest.mark.parametrize(
    "qshape,kvshape,causal",
    [
        ((1, 2, 128, 64), (1, 2, 128, 64), True),
        ((1, 2, 128, 100), (1, 2, 128, 100), True),  # open_llama_3b's head size
        ((1, 4, 128, 32), (1, 2, 128, 32), True),  # GQA
        ((1, 2, 128, 32), (1, 2, 256, 32), True),  # causal offset Tkv - Tq
        ((1, 2, 128, 32), (1, 2, 128, 32), False),
    ],
)
def test_flash_plain_matches_jax_splash(_jax_flash_on_cpu, qshape, kvshape, causal):
    q, k, v = _np(*qshape, seed=0), _np(*kvshape, seed=1), _np(*kvshape, seed=2)
    gqa = qshape[1] != kvshape[1]
    want = _jax_sdpa(q, k, v, causal=causal, gqa=gqa)
    qt, kt, vt = (_torch(x, torch.bfloat16) for x in (q, k, v))
    scale = 1.0 / math.sqrt(qshape[-1])
    plain = flashex.flash_attention_plain(qt, kt, vt, causal=causal, scale=scale)
    got = flashex.flash_attention_fwd(qt, kt, vt, causal=causal, scale=scale)
    assert torch.equal(got, plain)  # a CPU tensor takes the plain version
    np.testing.assert_allclose(_f32(got), want, rtol=2e-2, atol=2e-2)


def test_flash_claims_half_precision_sdpa_and_matches_decomposition():
    q, k, v = (_torch(_np(1, 2, 128, 64, seed=s), torch.bfloat16) for s in range(3))

    def f(q, k, v):
        return ttorch.scaled_dot_product_attention(q, k, v, is_causal=True)

    fast = tt.jit(f, device="cpu")
    slow = tt.jit(f, device="cpu", executors=["torch"])
    got, want = fast(q, k, v), slow(q, k, v)
    assert "flash_scaled_dot_product_attention" in tt.last_traces(fast)[-1].python()
    # The decomposition rounds q*scale and the scores to bf16; the kernel's
    # plain version keeps the scores in f32.
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)


def test_flash_refuses_f32():
    q, k, v = (_torch(_np(1, 2, 128, 64, seed=s)) for s in range(3))

    def f(q, k, v):
        return ttorch.scaled_dot_product_attention(q, k, v, is_causal=True)

    jf = tt.jit(f, device="cpu")
    out = jf(q, k, v)
    assert "flash_" not in tt.last_traces(jf)[-1].python()
    want = flashex.flash_attention_plain(q, k, v, causal=True, scale=1 / 8)
    np.testing.assert_allclose(_f32(out), _f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "qshape,kvshape,kwargs",
    [
        ((1, 2, 32, 64), (1, 2, 32, 64), {}),  # below the 64-token floor
        ((1, 2, 128, 300), (1, 2, 128, 300), {}),  # head size above 256
        ((1, 4, 128, 32), (1, 2, 128, 32), {"enable_gqa": False}),  # GQA needs enable_gqa
        ((1, 2, 128, 32), (1, 2, 128, 32), {"dropout_p": 0.5}),
    ],
)
def test_flash_checker_refuses(qshape, kvshape, kwargs):
    q = torch.zeros(qshape, dtype=torch.bfloat16)
    k = v = torch.zeros(kvshape, dtype=torch.bfloat16)
    assert not flashex._sdpa_checker(q, k, v, is_causal=True, **kwargs)


# The residual pair: forward with logsumexp, backward from (out, lse). The
# JAX functions run the splash kernels in Pallas interpret mode. Tolerances:
# the JAX package rounds q*scale to bf16 before its kernels (a relative
# change of up to 2^-9 in each score, so up to ~1e-2 in lse at |scores| of a
# few units), and its backward rounds at other places than the port's.
_RES_CASES = [
    ((1, 2, 128, 100), (1, 2, 128, 100), True),  # open_llama_3b's head size
    ((1, 4, 128, 32), (1, 2, 128, 32), True),  # GQA
    ((1, 2, 128, 64), (1, 2, 128, 64), False),  # full attention
]


def _jax_bf16(*xs):
    return [jnp.asarray(x, dtype=jnp.bfloat16) for x in xs]


@pytest.mark.parametrize("qshape,kvshape,causal", _RES_CASES)
def test_flash_lse_plain_matches_jax_fwd_res(_jax_flash_on_cpu, qshape, kvshape, causal):
    q, k, v = _np(*qshape, seed=20), _np(*kvshape, seed=21), _np(*kvshape, seed=22)
    gqa = qshape[1] != kvshape[1]
    jout, jlse = jflashex._sdpa_fwd_res_impl(*_jax_bf16(q, k, v), None, causal, None, gqa)
    qt, kt, vt = (_torch(x, torch.bfloat16) for x in (q, k, v))
    out, lse = flashex.flash_attention_fwd_lse(qt, kt, vt, causal=causal, scale=1.0 / math.sqrt(qshape[-1]))
    assert lse.dtype == torch.float32 and tuple(lse.shape) == qshape[:3]
    np.testing.assert_allclose(_f32(out), _f32(jout), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_f32(lse), _f32(jlse), rtol=0, atol=3e-2)


@pytest.mark.parametrize("qshape,kvshape,causal", _RES_CASES)
def test_flash_bwd_plain_matches_jax_bwd_res(_jax_flash_on_cpu, qshape, kvshape, causal):
    q, k, v, g = _np(*qshape, seed=23), _np(*kvshape, seed=24), _np(*kvshape, seed=25), _np(*qshape, seed=26)
    gqa = qshape[1] != kvshape[1]
    jq, jk, jv, jg = _jax_bf16(q, k, v, g)
    # Both backwards start from the JAX package's saved (out, lse).
    jout, jlse = jflashex._sdpa_fwd_res_impl(jq, jk, jv, None, causal, None, gqa)
    want = jflashex._sdpa_bwd_res_impl(jg, jq, jk, jv, jout, jlse, None, causal, None, gqa)
    qt, kt, vt, gt = (_torch(x, torch.bfloat16) for x in (q, k, v, g))
    out, lse = _torch(np.array(_f32(jout)), torch.bfloat16), _torch(np.array(_f32(jlse)))
    scale = 1.0 / math.sqrt(qshape[-1])
    got = flashex.flash_attention_bwd(gt, qt, kt, vt, out, lse, causal=causal, scale=scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=0, atol=3e-2 * np.abs(_f32(b)).max(), err_msg=name)


def test_flash_bwd_plain_matches_autograd_in_f32():
    """In float32 (no roundings of P or dS that matter) the plain backward
    is the exact gradient: held against torch autograd of plain attention."""
    B, H, G, T, D = 1, 4, 2, 64, 32
    q, k, v, g = (_torch(_np(*shape, seed=30 + i)) for i, shape in
                  enumerate([(B, H, T, D), (B, G, T, D), (B, G, T, D), (B, H, T, D)]))
    scale = 0.2
    out, lse = flashex.flash_attention_lse_plain(q, k, v, causal=True, scale=scale)
    got = flashex.flash_attention_bwd_plain(g, q, k, v, out, lse, causal=True, scale=scale)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    ref = torch.nn.functional.scaled_dot_product_attention(qa, ka, va, is_causal=True, scale=scale,
                                                           enable_gqa=True)
    want = torch.autograd.grad(ref, (qa, ka, va), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_residual_eligibility_needs_equal_lengths():
    q = torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, 256, 64, dtype=torch.bfloat16)
    assert flashex.residual_eligible(q, q, q)
    assert not flashex.residual_eligible(q, kv, kv)  # S != L stays on the recompute path
    assert not flashex.residual_eligible(q.float(), q.float(), q.float())


# =============================================================================
# Rotary embedding
# =============================================================================


def _cos_sin(T, D):
    pos = np.arange(T, dtype=np.float32)[:, None]
    theta = 10000.0 ** (np.arange(D // 2, dtype=np.float32) * -2.0 / D)
    emb = np.concatenate([pos * theta, pos * theta], axis=1)
    return np.cos(emb), np.sin(emb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 16, 100), (1, 2, 32, 64)])
def test_rope_plain_matches_pallas(shape, dtype):
    x = _np(*shape, seed=3)
    cos, sin = _cos_sin(shape[2], shape[3])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _f32(pallasex._rope_impl(*(jnp.asarray(a, dtype=jdt) for a in (x, cos, sin))))
    xt, ct, st = (_torch(a, tdt) for a in (x, cos, sin))
    got = fusedex.apply_rope(xt, ct, st)
    assert torch.equal(got, fusedex.rope_plain(xt, ct, st))
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(_f32(got), want, rtol=0, atol=2 * 2.0 ** -7 * np.abs(want).max())


def test_rope_strided_view_matches_contiguous():
    B, T, H, D = 2, 16, 3, 100
    qkv = _torch(_np(B, T, 3 * H * D, seed=4))
    x = qkv[..., H * D:2 * H * D].reshape(B, T, H, D).permute(0, 2, 1, 3)
    cos, sin = (_torch(a) for a in _cos_sin(T, D))
    torch.testing.assert_close(fusedex.apply_rope(x, cos, sin), fusedex.apply_rope(x.contiguous(), cos, sin))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_backward_matches_jax(dtype):
    """The rope backward is the rope with -sin. jax.vjp cannot differentiate
    through a pallas_call, so it is held against jax.vjp of the same
    rotate-half written in jax.numpy, and against ``pallasex._rope_impl``
    with -sin, which is what the JAX package's VJP rule runs."""
    B, H, T, D = 2, 3, 16, 100
    g = _np(B, H, T, D, seed=12)
    cos, sin = _cos_sin(T, D)

    def rope(x):
        x1, x2 = x[..., : D // 2], x[..., D // 2:]
        return x * jnp.asarray(cos) + jnp.concatenate([-x2, x1], axis=-1) * jnp.asarray(sin)

    _, vjp = jax.vjp(rope, jnp.asarray(_np(B, H, T, D, seed=13)))
    exact = _f32(vjp(jnp.asarray(g))[0])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jax_bwd = _f32(pallasex._rope_impl(*(jnp.asarray(a, dtype=jdt) for a in (g, cos, -sin))))
    gt, ct, st = (_torch(a, tdt) for a in (g, cos, sin))
    got = _f32(fusedex.apply_rope(gt, ct, -st))
    if dtype == "float32":
        np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, jax_bwd, rtol=1e-5, atol=1e-6)
    else:
        lim = 2 * 2.0 ** -7 * np.abs(exact).max()  # inputs and result rounded to bf16
        np.testing.assert_allclose(got, exact, rtol=0, atol=lim)
        np.testing.assert_allclose(got, jax_bwd, rtol=0, atol=lim)


def test_rope_checker_refuses_mixed_dtypes_and_partial_rotary():
    x = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16)
    cos = sin = torch.zeros(16, 64, dtype=torch.bfloat16)
    assert fusedex._rope_checker(x, cos, sin)
    assert not fusedex._rope_checker(x, cos.float(), sin.float())  # mixed dtypes
    assert not fusedex._rope_checker(x, cos[:, :32], sin[:, :32])  # partial rotary
    assert not fusedex._rope_checker(x[:, :, :12], cos[:12], sin[:12])  # T % 8 != 0


def test_rope_mixed_dtypes_stay_decomposed():
    x = _torch(_np(1, 2, 16, 64, seed=5), torch.bfloat16)
    cos, sin = (_torch(a) for a in _cos_sin(16, 64))
    jf = tt.jit(lambda x, c, s: ttorch.apply_rope(x, c, s), device="cpu")
    out = jf(x, cos, sin)
    assert "fused_apply_rope" not in tt.last_traces(jf)[-1].python()
    assert out.dtype == torch.float32  # promoted, as the decomposition does


# =============================================================================
# Cross-entropy
# =============================================================================


def _jax_ce(logits, target, **kw):
    return float(pallasex._ce_impl(jnp.asarray(logits), jnp.asarray(target), **kw))


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("tdtype", ["int32", "int64"])
def test_ce_plain_matches_pallas(reduction, tdtype):
    N, V = 64, 256
    logits = _np(N, V, seed=6, scale=3.0)
    target = np.random.RandomState(7).randint(0, V, N).astype(tdtype)
    target[::5] = -100  # ignored rows
    want = _jax_ce(logits, target.astype(np.int32), reduction=reduction)
    got = fusedex._ce_impl(_torch(logits), torch.from_numpy(target), reduction=reduction)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_ce_rows_zero_for_ignored_and_match_logsumexp():
    N, V = 16, 128
    logits = _torch(_np(N, V, seed=8))
    target = torch.arange(N) * 7 % V
    target[3] = -100
    rows = fusedex.cross_entropy_rows(logits, target, -100)
    want = torch.logsumexp(logits, -1) - logits[torch.arange(N), target.clamp_min(0)]
    assert rows[3].item() == 0.0
    keep = torch.arange(N) != 3
    torch.testing.assert_close(rows[keep], want[keep])


def test_ce_all_ignored_mean_clamps_count_at_one():
    N, V = 16, 128
    logits = _np(N, V, seed=9)
    target = np.full((N,), -100, dtype=np.int64)
    want = _jax_ce(logits, target.astype(np.int32))
    got = fusedex._ce_impl(_torch(logits), torch.from_numpy(target))
    assert want == 0.0 and got.item() == 0.0


def test_ce_bf16_logits_claimed_and_match_decomposition():
    N, V = 32, 128
    logits = _torch(_np(N, V, seed=10), torch.bfloat16)
    target = torch.from_numpy(np.random.RandomState(11).randint(0, V, N)).to(torch.int32)
    f = lambda x, t: ttorch.cross_entropy(x, t)  # noqa: E731
    fast, slow = tt.jit(f, device="cpu"), tt.jit(f, device="cpu", executors=["torch"])
    got, want = fast(logits, target), slow(logits, target)
    assert "fused_cross_entropy" in tt.last_traces(fast)[-1].python()
    # The decomposition's log_softmax rounds to bf16 before the mean.
    np.testing.assert_allclose(got.float().item(), want.float().item(), rtol=1e-2)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ce_bwd_plain_matches_pallas(reduction, dtype):
    N, V = 64, 256
    logits = _np(N, V, seed=14, scale=3.0)
    target = np.random.RandomState(15).randint(0, V, N).astype(np.int64)
    target[::5] = -100  # ignored rows
    g = np.float32(1.7)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _f32(pallasex._ce_bwd_impl(jnp.asarray(g), jnp.asarray(logits, dtype=jdt), jnp.asarray(target.astype(np.int32)),
                                      -100, reduction))
    got = fusedex._ce_bwd_impl(torch.tensor(g), _torch(logits, tdt), torch.from_numpy(target), -100, reduction)
    assert got.dtype == tdt and got.shape == (N, V)
    assert (got[::5] == 0).all()
    # f32: summation order only; bf16: both round the f32 result once, and
    # the JAX kernel reads bf16 logits the same way.
    atol = (1e-6 if dtype == "float32" else 2.0 ** -8) * np.abs(want).max()
    np.testing.assert_allclose(_f32(got), want, rtol=1e-5 if dtype == "float32" else 0, atol=atol)


def test_ce_row_scale_needs_no_host_sync_and_clamps_the_count():
    target = torch.full((8,), -100)
    scale = fusedex.ce_row_scale(torch.tensor(2.0), target, -100, "mean")
    assert scale.shape == (8,) and (scale == 0).all()
    target[:2] = 3
    assert torch.equal(fusedex.ce_row_scale(torch.tensor(2.0), target, -100, "mean")[:3], torch.tensor([1.0, 1.0, 0.0]))
    assert torch.equal(fusedex.ce_row_scale(torch.tensor(2.0), target, -100, "sum")[:3], torch.tensor([2.0, 2.0, 0.0]))


def test_ce_checker_refuses_weights_smoothing_and_none_reduction():
    x, t = torch.zeros(8, 128), torch.zeros(8, dtype=torch.int64)
    assert fusedex._ce_checker(x, t)
    assert not fusedex._ce_checker(x, t, weight=torch.ones(128))
    assert not fusedex._ce_checker(x, t, label_smoothing=0.1)
    assert not fusedex._ce_checker(x, t, reduction="none")
    assert not fusedex._ce_checker(x.half(), t)

