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
# Masked attention: the forward under segment ids (kernel row 9) and the
# recompute-path backward (row 8), through the flash executor's runtime
# plan, held against the JAX package's TestFlashMasks cases
# (tests/test_kernel_executors.py), run as those tests run them: splash in
# Pallas interpret mode with THUNDER_FLASH_FORCE=1. The tolerances are those
# tests' own (rtol 2e-2, atol 8e-3 in bf16; gradients rtol 5e-2, atol 2e-2).
# =============================================================================

_MB, _MH, _MT, _MD = 2, 2, 128, 32


def _masked_inputs():
    q, k, v = (_np(_MB, _MH, _MT, _MD, seed=s, scale=0.5) for s in (50, 51, 52))
    return q, k, v


def _sdpa_masked_both(q, k, v, m):
    """(JAX output, port output, exact-branch count) of SDPA under mask m,
    each package with its flash executor; the port's trace must claim it."""

    def jf(q, k, v, m):
        return jtorch.scaled_dot_product_attention(q, k, v, attn_mask=m)

    def tf(q, k, v, m):
        return ttorch.scaled_dot_product_attention(q, k, v, attn_mask=m)

    want = _f32(thunder_tpu.jit(jf)(*_jax_bf16(q, k, v), m))
    port = tt.jit(tf, device="cpu")
    before = flashex.sdpa_exact.launches
    got = port(*(_torch(x, torch.bfloat16) for x in (q, k, v)), torch.from_numpy(m))
    assert "flash_scaled_dot_product_attention" in tt.last_traces(port)[-1].python()
    return want, _f32(got), flashex.sdpa_exact.launches - before


def _hf_mask(pad):
    """HF-style 4D additive causal+padding mask incl. _unmask_unattended (as
    the JAX package's TestFlashMasks builds it)."""
    B, T = pad.shape
    MIN = np.finfo(np.float32).min
    m4 = np.zeros((B, 1, T, T), dtype=np.float32)
    tri = np.triu(np.ones((T, T), dtype=bool), k=1)
    for b in range(B):
        mb = np.zeros((T, T), dtype=np.float32)
        mb[tri] = MIN
        mb[:, pad[b]] = MIN
        fully = (mb == MIN).all(axis=1)
        mb[fully, :] = 0.0
        m4[b, 0] = mb
    return m4


def test_masked_bool_keypad_runs_the_kernel(_jax_flash_on_cpu):
    q, k, v = _masked_inputs()
    m = np.ones((_MB, 1, 1, _MT), dtype=bool)
    m[0, :, :, :40] = False  # left padding
    want, got, exact = _sdpa_masked_both(q, k, v, m)
    assert exact == 0
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=8e-3)


def test_masked_additive_keypad_runtime_verified(_jax_flash_on_cpu):
    q, k, v = _masked_inputs()
    m = np.zeros((_MB, 1, 1, _MT), dtype=np.float32)
    m[0, :, :, :40] = np.finfo(np.float32).min
    want, got, exact = _sdpa_masked_both(q, k, v, m)
    assert exact == 0
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=8e-3)


def test_masked_bool_keypad_all_masked_row_gives_zeros(_jax_flash_on_cpu):
    """A batch row with no valid key takes the exact branch: torch's safe
    softmax gives zeros there."""
    q, k, v = _masked_inputs()
    m = np.ones((_MB, 1, 1, _MT), dtype=bool)
    m[0] = False
    want, got, exact = _sdpa_masked_both(q, k, v, m)
    assert exact == 1
    np.testing.assert_allclose(got[0], 0.0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=8e-3)


def test_masked_additive_all_masked_row_attends_uniformly(_jax_flash_on_cpu):
    """An additive row uniformly <= -1e9 passes the 0-or-very-negative check,
    but softmax is shift-invariant: the exact branch attends uniformly where
    segment ids would mask every key."""
    q, k, v = _masked_inputs()
    m = np.zeros((_MB, 1, 1, _MT), dtype=np.float32)
    m[0] = np.finfo(np.float32).min
    want, got, exact = _sdpa_masked_both(q, k, v, m)
    assert exact == 1
    vb = _f32(_torch(v, torch.bfloat16))
    np.testing.assert_allclose(got[0], np.broadcast_to(vb[0].mean(axis=-2, keepdims=True), got[0].shape),
                               rtol=2e-2, atol=8e-3)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=8e-3)


def test_masked_additive_bias_takes_the_exact_branch(_jax_flash_on_cpu):
    """A real (ALiBi-style) bias fails the runtime check: the exact branch,
    f32 scores and torch's safe softmax, counted once."""
    q, k, v = _masked_inputs()
    m = (np.random.RandomState(3).randn(_MB, 1, 1, _MT) * 0.1).astype(np.float32)
    want, got, exact = _sdpa_masked_both(q, k, v, m)
    assert exact == 1
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=8e-3)


def test_masked_hf_4d_causal_padding_mask(_jax_flash_on_cpu):
    """The HF 4-D mask runs the kernel under segment ids; pad-query rows are
    undefined in the JAX package (finite garbage) and attend the pad keys in
    the port, so valid rows are compared, as the JAX test compares them."""
    q, k, v = _masked_inputs()
    pad = np.zeros((_MB, _MT), dtype=bool)
    pad[0, :40] = True
    want, got, exact = _sdpa_masked_both(q, k, v, _hf_mask(pad))
    assert exact == 0
    for b in range(_MB):
        rows = ~pad[b]
        np.testing.assert_allclose(got[b][:, rows], want[b][:, rows], rtol=2e-2, atol=8e-3)


def test_masked_hf_4d_mask_grads(_jax_flash_on_cpu):
    """value_and_grad through the HF 4-D mask: ``torch.sdpa_bwd`` is claimed
    by flash (the recompute-path backward) in both packages."""
    q, k, v = _masked_inputs()
    pad = np.zeros((_MB, _MT), dtype=bool)
    pad[0, :40] = True
    m4 = _hf_mask(pad)
    w = np.ones((_MB, 1, _MT, 1), dtype=np.float32)
    w[0, :, pad[0], :] = 0.0  # zero cotangents at the pad-query rows

    def jloss(q, k, v, m, w):
        o = jtorch.scaled_dot_product_attention(q, k, v, attn_mask=m)
        return jtorch.sum(o * o * w)

    def tloss(q, k, v, m, w):
        o = ttorch.scaled_dot_product_attention(q, k, v, attn_mask=m)
        return ttorch.sum(o * o * w)

    jvg = thunder_tpu.value_and_grad(jloss)
    ls, gs = jvg(*_jax_bf16(q, k, v), m4, w)
    assert "flash_sdpa_bwd" in thunder_tpu.last_traces(jvg)[-1].python()
    tvg = tt.value_and_grad(tloss, device="cpu")
    before = flashex.sdpa_exact.launches
    lf, gf = tvg(*(_torch(x, torch.bfloat16) for x in (q, k, v)), torch.from_numpy(m4), torch.from_numpy(w))
    assert "flash_sdpa_bwd(" in tt.last_traces(tvg)[-1].python()
    assert flashex.sdpa_exact.launches == before
    np.testing.assert_allclose(float(lf), float(ls), rtol=2e-2)
    for name, a, b in zip("qkv", gf[:3], gs[:3]):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=5e-2, atol=2e-2, err_msg=f"d{name}")


@pytest.mark.parametrize("pad", [("left", 40), ("right", 30), ("none", 0)])
def test_recompute_bwd_plain_matches_autograd_in_f32(pad):
    """In float32 the plain recompute backward under segment ids is the
    exact gradient of attention under the equivalent bool mask (pad queries
    attending the pad keys they may see): held against torch autograd,
    GQA included; 1e-4 relative for f32 summation order."""
    B, H, G, T, D = 2, 4, 2, 96, 32
    q, k, v, g = (_torch(_np(*shape, seed=60 + i)) for i, shape in
                  enumerate([(B, H, T, D), (B, G, T, D), (B, G, T, D), (B, H, T, D)]))
    kv = torch.ones((B, T), dtype=torch.int32)
    side, n = pad
    if side == "left":
        kv[0, :n] = 0
    elif side == "right":
        kv[1, T - n:] = 0
    seg = dict(q_seg=kv.clone(), kv_seg=kv)
    got = flashex.flash_attention_bwd_recompute(g, q, k, v, causal=True, scale=0.2, **seg)
    mask = (kv[:, None, :, None] == kv[:, None, None, :]) & torch.ones(T, T, dtype=torch.bool).tril()
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    ref = torch.nn.functional.scaled_dot_product_attention(qa, ka, va, attn_mask=mask, scale=0.2, enable_gqa=True)
    want = torch.autograd.grad(ref, (qa, ka, va), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    out = flashex.flash_attention_fwd_seg(q, k, v, seg["q_seg"], kv, causal=True, scale=0.2)
    torch.testing.assert_close(out, ref.detach(), rtol=1e-4, atol=1e-5)


def test_mask_verdict_is_read_once_per_mask():
    """Two SDPA calls on one mask tensor (two layers) read the host once; a
    new version of the mask (an in-place write) is read again."""
    q, k, v = (_torch(_np(1, 2, 128, 32, seed=s), torch.bfloat16) for s in (70, 71, 72))
    m = torch.ones((1, 1, 128, 128), dtype=torch.bool).tril()
    m[..., :10] = False
    m[..., :10, :10] = torch.ones(10, 10, dtype=torch.bool).tril()  # pad rows see pad keys: any value
    before = flashex.mask_plan.host_reads
    p1 = flashex.mask_plan(m, q, k, False)
    p2 = flashex.mask_plan(m, q, k, False)
    assert p1 is p2 and p1.flash and p1.causal and flashex.mask_plan.host_reads == before + 1
    assert p1.kv_seg[0, :10].eq(0).all() and p1.kv_seg[0, 10:].eq(1).all()
    m[0, 0, -1, 0] = True  # now the last row sees a pad key: no longer causal∧padding
    p3 = flashex.mask_plan(m, q, k, False)
    assert flashex.mask_plan.host_reads == before + 2 and not p3.flash


@pytest.mark.parametrize(
    "mask,kwargs,claimed",
    [
        (torch.ones(1, 1, 128, 128, dtype=torch.bool), {"is_causal": True}, False),  # mask and is_causal
        (torch.ones(128, 128, dtype=torch.bool), {}, False),  # 2-D: the query axis, not key padding
        (torch.ones(1, 2, 128, 128, dtype=torch.bool), {}, False),  # per-head mask
        (torch.zeros(1, 1, 128, 128, requires_grad=True), {}, False),  # a mask that requires grad
        (torch.ones(128, dtype=torch.bool), {}, True),  # (Tkv,) key padding
        (torch.zeros(2, 1, 128, 128), {}, True),  # additive 4-D
    ],
)
def test_masked_checker(mask, kwargs, claimed):
    q = torch.zeros(2, 2, 128, 32, dtype=torch.bfloat16)
    assert flashex._sdpa_checker(q, q, q, mask, **kwargs) is claimed
    assert flashex._bwd_checker(q, q, q, q, mask, **kwargs) is claimed


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

