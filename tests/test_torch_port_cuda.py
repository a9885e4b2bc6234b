"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips, with its reason, where there is
no CUDA device (the card is looked for inside each test, never at import).
This file imports neither JAX nor ``thunder_tpu``, so it also runs on a
machine that has only PyTorch and a card:

    python -m pytest tests/test_torch_port_cuda.py -m cuda

Tolerances: the kernels and their plain versions do the same arithmetic and
differ only in summation order, fused multiply-adds and, for flash attention,
where P is rounded to the input type (against the running max in the
kernel, against the row max in the plain version). Inputs are unit normal.
Flash and rope are held row by row against the row's largest |value|: one
rounding to the output type is one ulp of it, and flash's two roundings of P
and O are within two.
"""

import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpret mode")
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype)


def _assert_rows_close(got: torch.Tensor, want: torch.Tensor, n_ulps: float, floor: float = 0.0) -> None:
    """Each row (last dim) within ``n_ulps`` of the row's largest |value|, so
    a row of small values is held to its own scale, not to the tensor's;
    ``floor`` is an absolute allowance added to every row's limit."""
    eps = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10, torch.float32: 2.0 ** -23}[want.dtype]
    err = (got.float() - want.float()).abs().amax(-1)
    limit = n_ulps * eps * want.float().abs().amax(-1) + floor
    worst = (err - limit).argmax()
    assert (err <= limit).all(), f"row {worst.item()}: error {err.flatten()[worst].item()} > {limit.flatten()[worst].item()}"


@pytest.mark.parametrize(
    "B,H,G,Tq,Tkv,D,causal,dtype",
    [
        (2, 4, 4, 256, 256, 100, True, torch.bfloat16),  # head size 100: D padded to 112
        (1, 8, 2, 128, 128, 64, True, torch.bfloat16),  # GQA
        (1, 2, 2, 128, 256, 32, True, torch.float16),  # causal offset Tkv - Tq
        (1, 2, 2, 96, 96, 30, False, torch.bfloat16),  # ragged tiles, odd D/4: one-element loads
        (1, 2, 1, 70, 200, 256, True, torch.bfloat16),  # largest head size
        (1, 2, 2, 128, 64, 32, True, torch.bfloat16),  # Tq > Tkv: queries that see no key
    ],
)
def test_flash_fwd_matches_plain(dev, B, H, G, Tq, Tkv, D, causal, dtype):
    from thunder_tpu_torch.executors import flashex

    q = _randn((B, H, Tq, D), dtype, dev, 0)
    # k and v as strided views of one (B, Tkv, 2*G, D) tensor, like qkv slices.
    kv = _randn((B, Tkv, 2 * G, D), dtype, dev, 1)
    k, v = kv[:, :, :G].permute(0, 2, 1, 3), kv[:, :, G:].permute(0, 2, 1, 3)
    scale = 1.0 / math.sqrt(D)
    before = flashex.flash_attention_fwd.launches
    got = flashex.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert flashex.flash_attention_fwd.launches == before + 1
    want = flashex.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    assert got.shape == want.shape and got.dtype == dtype
    _assert_rows_close(got, want, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_rope_matches_plain(dev, dtype):
    from thunder_tpu_torch.executors import fusedex

    B, T, H, D = 2, 64, 3, 100
    qkv = _randn((B, T, 3 * H * D), dtype, dev, 2)
    x = qkv[..., H * D:2 * H * D].reshape(B, T, H, D).permute(0, 2, 1, 3)
    cos, sin = _randn((T, D), dtype, dev, 3), _randn((T, D), dtype, dev, 4)
    got = fusedex.apply_rope(x, cos, sin)
    torch.cuda.synchronize()
    want = fusedex.rope_plain(x, cos, sin)
    _assert_rows_close(got, want, 1)


@pytest.mark.parametrize(
    "N,V,dtype,tdtype",
    [(64, 32000, torch.float32, torch.int64), (33, 1001, torch.bfloat16, torch.int32), (16, 4096, torch.bfloat16, torch.int64)],
)
def test_ce_fwd_matches_plain(dev, N, V, dtype, tdtype):
    from thunder_tpu_torch.executors import fusedex

    logits = _randn((N, V), dtype, dev, 5) * 3
    t = np.random.RandomState(6).randint(0, V, N)
    t[::5] = -100
    target = torch.from_numpy(t).to(dev, tdtype)
    got = fusedex.cross_entropy_rows(logits, target, -100)
    torch.cuda.synchronize()
    want = fusedex.cross_entropy_rows_plain(logits, target, -100)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert (got[::5] == 0).all()


def test_ce_all_ignored_mean_is_zero(dev):
    from thunder_tpu_torch.executors import fusedex

    logits = _randn((8, 512), torch.float32, dev, 7)
    target = torch.full((8,), -100, device=dev)
    assert fusedex._ce_impl(logits, target).item() == 0.0


# =============================================================================
# The training path's kernels: flash forward with logsumexp, flash backward,
# cross-entropy backward, and rope with -sin (its backward)
# =============================================================================


def _qkv_views(B, H, G, T, D, dtype, dev, seed):
    """q, k, v as strided views of one (B, T, (H + 2G) * D) projection."""
    qkv = _randn((B, T, (H + 2 * G) * D), dtype, dev, seed)

    def heads(lo, n):
        return qkv[..., lo * D:(lo + n) * D].reshape(B, T, n, D).permute(0, 2, 1, 3)

    return heads(0, H), heads(H, G), heads(H + G, G)


_TRAIN_SHAPES = [
    (2, 32, 32, 2048, 2048, 100, True, torch.bfloat16),  # open_llama_3b's training path
    (1, 8, 2, 128, 128, 64, True, torch.bfloat16),  # GQA
    (1, 2, 2, 128, 256, 32, True, torch.float16),  # causal offset Tkv - Tq
    (1, 2, 2, 97, 97, 100, True, torch.bfloat16),  # odd T: ragged tiles
    (1, 2, 2, 96, 96, 30, False, torch.bfloat16),  # full attention, odd D/4: one-element loads
    (1, 2, 1, 64, 64, 256, True, torch.bfloat16),  # largest head size
]


@pytest.mark.parametrize("B,H,G,Tq,Tkv,D,causal,dtype", _TRAIN_SHAPES)
def test_flash_fwd_lse_matches_plain(dev, B, H, G, Tq, Tkv, D, causal, dtype):
    from thunder_tpu_torch.executors import flashex

    q, _, _ = _qkv_views(B, H, G, Tq, D, dtype, dev, 10)
    _, k, v = _qkv_views(B, H, G, Tkv, D, dtype, dev, 11)
    scale = 1.0 / math.sqrt(D)
    before = flashex.flash_attention_fwd_lse.launches
    out, lse = flashex.flash_attention_fwd_lse(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert flashex.flash_attention_fwd_lse.launches == before + 1
    want_out, want_lse = flashex.flash_attention_lse_plain(q, k, v, causal=causal, scale=scale)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Tq)
    _assert_rows_close(out, want_out, 2)
    # lse: an f32 logsumexp summed in another order, in base 2 in the kernel.
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,H,G,Tq,Tkv,D,causal,dtype", _TRAIN_SHAPES)
def test_flash_bwd_matches_plain(dev, B, H, G, Tq, Tkv, D, causal, dtype):
    """Kernel and plain version round P and dS to the input type at the same
    places, from f32 values that differ in the last bits (exp2 of the
    log2-scaled score in the kernel, exp in the plain version), so a few
    terms round one ulp of P or dS apart; with the one rounding of each
    output, 4 ulps of the row's largest |value| bound the difference.
    A row whose exact value is zero (query 0 sees only key 0, so
    dS = P·(dP − Di) cancels) holds f32 summation noise in both, which no
    row-relative limit can hold: every row also gets a floor of one ulp of
    one ulp (eps²) of the tensor's largest |value|."""
    from thunder_tpu_torch.executors import flashex

    q, _, _ = _qkv_views(B, H, G, Tq, D, dtype, dev, 12)
    _, k, v = _qkv_views(B, H, G, Tkv, D, dtype, dev, 13)
    scale = 1.0 / math.sqrt(D)
    out, lse = flashex.flash_attention_lse_plain(q, k, v, causal=causal, scale=scale)
    # dout as a strided view, as the backward of a transpose gives it.
    dout = _randn((B, Tq, H, D), dtype, dev, 14).permute(0, 2, 1, 3)
    before = flashex.flash_attention_bwd.launches
    got = flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert flashex.flash_attention_bwd.launches == before + 1
    want = flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype, name
        assert torch.isfinite(g).all(), name
        eps = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
        _assert_rows_close(g, w, 4, floor=eps * eps * w.float().abs().max().item())


def test_flash_bwd_is_reproducible(dev):
    from thunder_tpu_torch.executors import flashex

    q, k, v = _qkv_views(1, 4, 4, 256, 100, torch.bfloat16, dev, 15)
    out, lse = flashex.flash_attention_fwd_lse(q, k, v, causal=True, scale=0.1)
    dout = _randn(tuple(out.shape), torch.bfloat16, dev, 16)
    a = flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=True, scale=0.1)
    b = flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=True, scale=0.1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))  # no atomics: the same bits every run


def test_flash_bwd_refuses_a_device_mix(dev):
    from thunder_tpu_torch.executors import flashex

    q, k, v = _qkv_views(1, 2, 2, 64, 32, torch.bfloat16, dev, 17)
    out, lse = flashex.flash_attention_fwd_lse(q, k, v, causal=True, scale=0.1)
    with pytest.raises(ValueError, match="must be on"):
        flashex.flash_attention_bwd(out, q, k, v, out, lse.cpu(), causal=True, scale=0.1)
    with pytest.raises(ValueError, match="one CUDA device"):
        flashex.flash_attention_fwd_lse(q, k.cpu(), v, causal=True, scale=0.1)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize(
    "N,V,dtype,tdtype",
    [(4096, 32000, torch.float32, torch.int64), (33, 1001, torch.bfloat16, torch.int32), (16, 4096, torch.bfloat16, torch.int64)],
)
def test_ce_bwd_matches_plain(dev, N, V, dtype, tdtype, reduction):
    """Both compute (softmax - onehot) * row_scale in f32 and round once to
    the logits' type: f32 values agree to a few ulps of the row's largest
    |value| (summation order), and bf16 to one ulp."""
    from thunder_tpu_torch.executors import fusedex

    logits = _randn((N, V), dtype, dev, 18) * 3
    t = np.random.RandomState(19).randint(0, V, N)
    t[::7] = -100
    target = torch.from_numpy(t).to(dev, tdtype)
    g = torch.tensor(1.7, device=dev)
    scale = fusedex.ce_row_scale(g, target, -100, reduction)
    before = fusedex.cross_entropy_bwd.launches
    got = fusedex.cross_entropy_bwd(logits, target, scale)
    torch.cuda.synchronize()
    assert fusedex.cross_entropy_bwd.launches == before + 1
    want = fusedex.cross_entropy_bwd_plain(logits, target, scale)
    assert got.dtype == dtype and got.shape == (N, V)
    assert (got[::7] == 0).all()  # ignored rows
    valid = torch.from_numpy(t != -100).to(dev)
    _assert_rows_close(got[valid], want[valid], 8 if dtype == torch.float32 else 1)


def test_ce_bwd_refuses_a_device_mix(dev):
    from thunder_tpu_torch.executors import fusedex

    logits = _randn((8, 512), torch.float32, dev, 20)
    target = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="one CUDA device"):
        fusedex.cross_entropy_bwd(logits, target, torch.ones(8, device=dev))


def test_rope_with_negated_sin_undoes_rope(dev):
    """The rope backward is the rope kernel with -sin: a rotation by -theta,
    the inverse of the forward's."""
    from thunder_tpu_torch.executors import fusedex

    B, H, T, D = 2, 4, 64, 100
    x = _randn((B, H, T, D), torch.float32, dev, 21)
    pos = torch.arange(T, device=dev, dtype=torch.float32)[:, None]
    theta = 10000.0 ** (torch.arange(D // 2, device=dev, dtype=torch.float32) * -2.0 / D)
    emb = torch.cat([pos * theta, pos * theta], dim=1)
    cos, sin = emb.cos(), emb.sin()
    back = fusedex.apply_rope(fusedex.apply_rope(x, cos, sin), cos, -sin)
    torch.testing.assert_close(back, x, rtol=1e-5, atol=1e-5)
