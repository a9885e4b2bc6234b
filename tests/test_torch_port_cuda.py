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


def test_flash_fwd_is_reproducible(dev):
    from thunder_tpu_torch.executors import flashex

    q, k, v = _qkv_views(2, 4, 2, 256, 100, torch.bfloat16, dev, 18)
    a = flashex.flash_attention_fwd_lse(q, k, v, causal=True, scale=0.1)
    b = flashex.flash_attention_fwd_lse(q, k, v, causal=True, scale=0.1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))  # fixed reduction order: the same bits every run


def _check_fwd_and_bwd(dev, B, H, G, Tq, Tkv, D, causal, dtype, seed):
    """The forward with lse within 2 ulps of the row max (lse to 1e-5), and
    the backward from its (out, lse) within 4 ulps with the eps² floor: the
    limits of ``test_flash_fwd_lse_matches_plain`` and
    ``test_flash_bwd_matches_plain``."""
    from thunder_tpu_torch.executors import flashex

    q, _, _ = _qkv_views(B, H, G, Tq, D, dtype, dev, seed)
    _, k, v = _qkv_views(B, H, G, Tkv, D, dtype, dev, seed + 1)
    scale = 1.0 / math.sqrt(D)
    out, lse = flashex.flash_attention_fwd_lse(q, k, v, causal=causal, scale=scale)
    want_out, want_lse = flashex.flash_attention_lse_plain(q, k, v, causal=causal, scale=scale)
    _assert_rows_close(out, want_out, 2)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    dout = _randn((B, Tq, H, D), dtype, dev, seed + 2).permute(0, 2, 1, 3)
    got = flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=causal, scale=scale)
    torch.cuda.synchronize()
    want = flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal, scale=scale)
    eps = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype and torch.isfinite(g).all(), name
        _assert_rows_close(g, w, 4, floor=eps * eps * w.float().abs().max().item())


@pytest.mark.parametrize("D", [16, 32, 33, 64, 65, 112, 113, 128, 129, 256])
def test_flash_head_bucket_edges_match_plain(dev, D):
    """Each head size at an edge of the kernels' buckets (32, 64, 112, 128,
    256: a head runs padded to the smallest that holds it; above 128 the
    output columns are split over two blocks)."""
    _check_fwd_and_bwd(dev, 1, 4, 2, 128, 128, D, True, torch.bfloat16, 80)


@pytest.mark.parametrize(
    "Tq,Tkv,D,causal,dtype",
    [
        (100, 150, 100, True, torch.bfloat16),  # neither length a multiple of the 64-row tiles
        (150, 100, 100, True, torch.bfloat16),  # Tq > Tkv: leading queries see no key
        (77, 203, 64, False, torch.float16),
        (203, 77, 200, True, torch.bfloat16),  # heads above 128: 32-row tiles in the backward
        (33, 97, 256, False, torch.bfloat16),
    ],
)
def test_flash_ragged_tiles_match_plain(dev, Tq, Tkv, D, causal, dtype):
    _check_fwd_and_bwd(dev, 2, 2, 1, Tq, Tkv, D, causal, dtype, 84)


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


# =============================================================================
# The norm executor's kernels: RMSNorm and LayerNorm, forward and backward
# =============================================================================

# (N, D, dtype, layer_norm, bias): the path shapes (open_llama_3b's RMSNorm,
# pythia-410m's LayerNorm), an f16 row whose D is not a multiple of the
# block's 256 threads, an odd D (one-element loads) and f32.
_NORM_SHAPES = [
    (4096, 3200, torch.bfloat16, False, False),
    (4096, 1024, torch.bfloat16, True, True),
    (33, 1000, torch.float16, True, False),
    (17, 1001, torch.bfloat16, True, True),
    (7, 384, torch.float32, False, False),
    (5, 2600, torch.float32, True, True),
]


def _norm_inputs(N, D, dtype, bias, dev, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(N, D) * 2 + 0.5).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.randn(D) * 0.1 + 1).astype(np.float32)).to(dev, dtype)
    b = torch.from_numpy((rng.randn(D) * 0.1).astype(np.float32)).to(dev, dtype) if bias else None
    g = torch.from_numpy(rng.randn(N, D).astype(np.float32)).to(dev, dtype)
    return x, w, b, g


def _assert_vec_close(got: torch.Tensor, want: torch.Tensor, rel: float) -> None:
    """dw/db: f32 sums over the rows in another order, within ``rel`` of
    the vector's largest |value|."""
    assert got.dtype == want.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), err


@pytest.mark.parametrize("N,D,dtype,layer_norm,bias", _NORM_SHAPES)
def test_norm_fwd_matches_plain(dev, N, D, dtype, layer_norm, bias):
    """One rounding of an f32 result to the output type in both: within one
    ulp of the row's largest |value|. In f32 the row sums taken in another
    order show: 64 ulps (7.6e-6) of the row's largest |value|."""
    from thunder_tpu_torch.executors import normex

    x, w, b, _ = _norm_inputs(N, D, dtype, bias, dev, 30)
    if layer_norm:
        before = normex.layer_norm_fwd.launches
        got = normex.layer_norm_fwd(x, w, b, 1e-5)
        assert normex.layer_norm_fwd.launches == before + 1
    else:
        before = normex.rms_norm_fwd.launches
        got = normex.rms_norm_fwd(x, w, 1e-6)
        assert normex.rms_norm_fwd.launches == before + 1
    torch.cuda.synchronize()
    want = normex.norm_fwd_plain(x, w, b, 1e-5 if layer_norm else 1e-6, layer_norm=layer_norm)
    assert got.shape == want.shape and got.dtype == dtype
    _assert_rows_close(got, want, 64 if dtype == torch.float32 else 1)


@pytest.mark.parametrize("N,D,dtype,layer_norm,bias", _NORM_SHAPES)
def test_norm_bwd_matches_plain(dev, N, D, dtype, layer_norm, bias):
    """dx: one rounding of an f32 result, one ulp of the row's largest
    |value| (64 in f32, where the row sums taken in another order show);
    dw/db: f32 column sums in another order, 1e-5 of the largest |value|."""
    from thunder_tpu_torch.executors import normex

    x, w, _, g = _norm_inputs(N, D, dtype, bias, dev, 31)
    eps = 1e-5 if layer_norm else 1e-6
    if layer_norm:
        before = normex.layer_norm_bwd.launches
        dx, dw, db = normex.layer_norm_bwd(g, x, w, eps, with_bias=bias)
        assert normex.layer_norm_bwd.launches == before + 1
    else:
        before = normex.rms_norm_bwd.launches
        (dx, dw), db = normex.rms_norm_bwd(g, x, w, eps), None
        assert normex.rms_norm_bwd.launches == before + 1
    torch.cuda.synchronize()
    want_dx, want_dw, want_db = normex.norm_bwd_plain(g, x, w, eps, layer_norm=layer_norm, with_bias=bias)
    assert dx.shape == x.shape and dx.dtype == dtype
    _assert_rows_close(dx, want_dx, 64 if dtype == torch.float32 else 1)
    _assert_vec_close(dw, want_dw, 1e-5)
    assert (db is None) == (want_db is None)
    if db is not None:
        _assert_vec_close(db, want_db, 1e-5)


def test_norm_scalar_path_on_unaligned_rows(dev):
    """A base pointer that is not 16-byte aligned takes the one-element
    loads; the result is the same as the plain version's."""
    from thunder_tpu_torch.executors import normex

    N, D = 64, 1024
    buf = _randn((N * D + 1,), torch.bfloat16, dev, 32)
    x = buf[1:].view(N, D)
    assert x.data_ptr() % 16 != 0
    w = torch.ones(D, dtype=torch.bfloat16, device=dev)
    b = torch.zeros(D, dtype=torch.bfloat16, device=dev)
    _assert_rows_close(normex.layer_norm_fwd(x, w, b, 1e-5), normex.norm_fwd_plain(x, w, b, 1e-5, layer_norm=True), 1)
    g = _randn((N, D), torch.bfloat16, dev, 33)
    dx, dw, db = normex.layer_norm_bwd(g, x, w, 1e-5, with_bias=True)
    want_dx, want_dw, want_db = normex.norm_bwd_plain(g, x, w, 1e-5, layer_norm=True, with_bias=True)
    _assert_rows_close(dx, want_dx, 1)
    _assert_vec_close(dw, want_dw, 1e-5)
    _assert_vec_close(db, want_db, 1e-5)


def test_norm_bwd_is_reproducible(dev):
    from thunder_tpu_torch.executors import normex

    x, w, _, g = _norm_inputs(4096, 1024, torch.bfloat16, True, dev, 34)
    a = normex.layer_norm_bwd(g, x, w, 1e-5, with_bias=True)
    b = normex.layer_norm_bwd(g, x, w, 1e-5, with_bias=True)
    assert all(torch.equal(p, q) for p, q in zip(a, b))  # no atomics: the same bits every run
    c, d = normex.rms_norm_bwd(g, x, w), normex.rms_norm_bwd(g, x, w)
    assert all(torch.equal(p, q) for p, q in zip(c, d))


def test_norm_refuses_a_device_mix_and_mixed_types(dev):
    from thunder_tpu_torch.executors import normex

    x, w, b, g = _norm_inputs(8, 256, torch.bfloat16, True, dev, 35)
    with pytest.raises(ValueError, match="one CUDA device"):
        normex.layer_norm_fwd(x, w.cpu(), b)
    with pytest.raises(ValueError, match="share one of"):
        normex.rms_norm_fwd(x, w.float())
    with pytest.raises(ValueError, match="unsupported shapes"):
        normex.rms_norm_bwd(g[:, :128], x, w)


def test_embedding_backward_is_reproducible(dev):
    """The torch executor's embedding backward sums the rows of each index in
    a fixed order (``index_put`` with ``accumulate``: a stable sort, then one
    writer per row): the same bits every run, where ``index_add_``'s atomics
    differ. Against the sum of each index's rows in f64: each of the ~256
    adds into an index's row may round to bf16 (2^-9 of the partial sum),
    and those errors add as a random walk, ~16 * 2^-9 = 2^-5 of the largest
    |value|; 2^-4 of it leaves a factor of two."""
    from thunder_tpu_torch.executors import torchex

    rng = np.random.RandomState(22)
    idx = torch.from_numpy(rng.randint(0, 16, 4096)).to(dev)
    g = _randn((4096, 3200), torch.bfloat16, dev, 23)
    a = torchex._embedding_backward(g, idx, 32000, 3200)
    b = torchex._embedding_backward(g, idx, 32000, 3200)
    assert torch.equal(a, b)
    want = torch.zeros((32000, 3200), dtype=torch.float64, device=dev).index_add_(0, idx, g.double())
    assert (a.double() - want).abs().max().item() <= 2.0 ** -4 * want.abs().max().item()
    assert not a[16:].any()


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


# =============================================================================
# Masked and padded attention: the forward under segment ids (kernel row 9)
# and the recompute-path backward (row 8)
# =============================================================================

# (B, H, G, Tq, Tkv, D, causal, dtype, padding of batch row 0): the path
# shape (open_llama_3b, row 0 left-padded by 512 tokens); left padding that
# empties the first one, two and all but the last 64-key tile for every
# valid query; right padding; no padding; GQA; Tq != Tkv; odd T; full
# attention with one-element loads. q, k and v are strided views.
_SEG_SHAPES = [
    (2, 32, 32, 2048, 2048, 100, True, torch.bfloat16, ("left", 512)),
    (2, 4, 4, 256, 256, 64, True, torch.bfloat16, ("left", 64)),
    (2, 4, 4, 256, 256, 64, True, torch.bfloat16, ("left", 128)),
    (2, 4, 4, 256, 256, 64, True, torch.bfloat16, ("left", 192)),
    (2, 4, 4, 256, 256, 100, True, torch.bfloat16, ("right", 100)),
    (2, 4, 4, 256, 256, 100, True, torch.bfloat16, ("none", 0)),
    (2, 8, 2, 128, 128, 64, True, torch.bfloat16, ("left", 40)),
    (2, 2, 2, 128, 256, 32, True, torch.float16, ("left", 70)),
    (2, 2, 2, 97, 97, 100, True, torch.bfloat16, ("right", 30)),
    (2, 2, 2, 96, 96, 30, False, torch.bfloat16, ("left", 20)),
]


def _segments(B, Tq, Tkv, padding, dev):
    """(q_seg, kv_seg) int32, 1 valid and 0 pad, with batch row 0 padded as
    ``padding`` says; the queries are the last Tq key positions."""
    kind, n = padding
    kv = torch.ones((B, Tkv), dtype=torch.int32)
    if kind == "left":
        kv[0, :n] = 0
    elif kind == "right":
        kv[0, Tkv - n:] = 0
    return kv[:, Tkv - Tq:].contiguous().to(dev), kv.to(dev)


@pytest.mark.parametrize("B,H,G,Tq,Tkv,D,causal,dtype,padding", _SEG_SHAPES)
def test_flash_fwd_seg_matches_plain(dev, B, H, G, Tq, Tkv, D, causal, dtype, padding):
    """The forward under segment ids holds to the unmasked forward's limit:
    two roundings of the row's largest |value|. Every row is compared, pad
    queries too (they attend the pad keys they may see)."""
    from thunder_tpu_torch.executors import flashex

    q, _, _ = _qkv_views(B, H, G, Tq, D, dtype, dev, 40)
    _, k, v = _qkv_views(B, H, G, Tkv, D, dtype, dev, 41)
    q_seg, kv_seg = _segments(B, Tq, Tkv, padding, dev)
    scale = 1.0 / math.sqrt(D)
    before = flashex.flash_attention_fwd_seg.launches
    got = flashex.flash_attention_fwd_seg(q, k, v, q_seg, kv_seg, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert flashex.flash_attention_fwd_seg.launches == before + 1
    want = flashex.flash_attention_plain(q, k, v, causal=causal, scale=scale, q_seg=q_seg, kv_seg=kv_seg)
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.isfinite(got).all()
    _assert_rows_close(got, want, 2)
    # The forward with logsumexp, as the recompute runs it: lse within f32
    # summation noise of the plain version's, -inf for a query that sees no key.
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=dev)
    out = flashex._launch_fwd(q, k, v, causal, scale, lse, q_seg, kv_seg)
    want_out, want_lse = flashex.flash_attention_lse_plain(q, k, v, causal=causal, scale=scale, q_seg=q_seg,
                                                           kv_seg=kv_seg)
    assert torch.equal(out, got)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,H,G,Tq,Tkv,D,causal,dtype,padding", _SEG_SHAPES)
def test_flash_bwd_recompute_matches_plain(dev, B, H, G, Tq, Tkv, D, causal, dtype, padding):
    """The recompute-path backward against the plain backward from the
    kernel forward's own (out, lse), the pair the wrapper recomputes: the
    residual backward's limit, 4 ulps of the row's largest |value| with an
    eps² floor. Against the plain recompute end to end, whose out and lse
    differ from the kernel's by up to two ulps (which moves Di), 8 ulps."""
    from thunder_tpu_torch.executors import flashex

    q, _, _ = _qkv_views(B, H, G, Tq, D, dtype, dev, 42)
    _, k, v = _qkv_views(B, H, G, Tkv, D, dtype, dev, 43)
    q_seg, kv_seg = _segments(B, Tq, Tkv, padding, dev)
    scale = 1.0 / math.sqrt(D)
    dout = _randn((B, Tq, H, D), dtype, dev, 44).permute(0, 2, 1, 3)
    before = flashex.flash_attention_bwd_recompute.launches
    got = flashex.flash_attention_bwd_recompute(dout, q, k, v, causal=causal, scale=scale, q_seg=q_seg,
                                                kv_seg=kv_seg)
    torch.cuda.synchronize()
    assert flashex.flash_attention_bwd_recompute.launches == before + 1
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=dev)
    out = flashex._launch_fwd(q, k, v, causal, scale, lse, q_seg, kv_seg)
    want = flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal, scale=scale, q_seg=q_seg,
                                             kv_seg=kv_seg)
    end_to_end = flashex.flash_attention_bwd_recompute_plain(dout, q, k, v, causal=causal, scale=scale,
                                                             q_seg=q_seg, kv_seg=kv_seg)
    eps = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    for name, g, w, e in zip(("dq", "dk", "dv"), got, want, end_to_end):
        assert g.shape == w.shape and g.dtype == dtype, name
        assert torch.isfinite(g).all(), name
        _assert_rows_close(g, w, 4, floor=eps * eps * w.float().abs().max().item())
        _assert_rows_close(g, e, 8, floor=eps * eps * e.float().abs().max().item())


def test_flash_bwd_recompute_is_reproducible(dev):
    from thunder_tpu_torch.executors import flashex

    q, k, v = _qkv_views(2, 4, 4, 256, 100, torch.bfloat16, dev, 45)
    q_seg, kv_seg = _segments(2, 256, 256, ("left", 100), dev)
    dout = _randn((2, 4, 256, 100), torch.bfloat16, dev, 46)
    a = flashex.flash_attention_bwd_recompute(dout, q, k, v, causal=True, scale=0.1, q_seg=q_seg, kv_seg=kv_seg)
    b = flashex.flash_attention_bwd_recompute(dout, q, k, v, causal=True, scale=0.1, q_seg=q_seg, kv_seg=kv_seg)
    assert all(torch.equal(x, y) for x, y in zip(a, b))  # no atomics: the same bits every run


def test_flash_seg_refuses_bad_segments(dev):
    from thunder_tpu_torch.executors import flashex

    q, k, v = _qkv_views(2, 2, 2, 64, 32, torch.bfloat16, dev, 47)
    q_seg, kv_seg = _segments(2, 64, 64, ("left", 10), dev)
    with pytest.raises(ValueError, match="int32"):
        flashex.flash_attention_fwd_seg(q, k, v, q_seg.long(), kv_seg, causal=True, scale=0.1)
    with pytest.raises(ValueError, match="int32"):
        flashex.flash_attention_fwd_seg(q, k, v, q_seg, kv_seg[:, :32].contiguous(), causal=True, scale=0.1)
    with pytest.raises(ValueError, match="go together"):
        flashex.flash_attention_bwd_recompute(q, q, k, v, causal=True, scale=0.1, q_seg=q_seg)


# =============================================================================
# Kernel row 10: the legacy route (THUNDER_FLASH_IMPL=legacy)
# =============================================================================


@pytest.mark.parametrize("B,H,G,S,D,causal", [(1, 4, 2, 256, 100, True), (2, 2, 2, 128, 64, False)])
def test_legacy_flash_matches_plain(dev, B, H, G, S, D, causal):
    """The legacy wrappers launch rows 1 and 8's kernels: the forward within
    the forward kernel's 2 ulps, the backward within the recompute
    backward's 8 ulps of the plain recompute end to end (eps² floor)."""
    from thunder_tpu_torch.executors import flashex

    q, _, _ = _qkv_views(B, H, G, S, D, torch.bfloat16, dev, 60)
    _, k, v = _qkv_views(B, H, G, S, D, torch.bfloat16, dev, 61)
    dout = _randn((B, H, S, D), torch.bfloat16, dev, 62)
    scale = 1.0 / math.sqrt(D)
    before = (flashex.legacy_flash_fwd.launches, flashex.legacy_flash_bwd.launches)
    out = flashex.legacy_flash_fwd(q, k, v, causal=causal, scale=scale)
    grads = flashex.legacy_flash_bwd(dout, q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert (flashex.legacy_flash_fwd.launches, flashex.legacy_flash_bwd.launches) == (before[0] + 1, before[1] + 1)
    _assert_rows_close(out, flashex.flash_attention_plain(q, k, v, causal=causal, scale=scale), 2)
    want = flashex.flash_attention_bwd_recompute_plain(dout, q, k, v, causal=causal, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        _assert_rows_close(g, w, 8, floor=2.0 ** -14 * w.float().abs().max().item())


# =============================================================================
# Staging: entries captured as CUDA graphs (executors/staging.py)
# =============================================================================

_TINY = "llama-hs100-tiny"  # open_llama_3b's head size at a test width: n_embd 200, 2 layers


def _tiny_batch(cfg, dev, seed, B=2, T=128):
    rng = np.random.RandomState(seed)
    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, T))).to(dev)
    return idx, torch.roll(idx, -1, dims=1)


def _counts():
    from thunder_tpu_torch.executors import _build

    return {name: n for (_, name), n in _build.launch_counts().items()}


def test_staged_jit_replays_with_fresh_outputs_new_inputs_and_counted_launches(dev):
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.models import gpt

    cfg = gpt.name_to_config(_TINY)
    params = gpt.init_params(cfg, seed=0, device=dev)
    loss_fn = lambda p, i, t: gpt.loss_fn(p, i, t, cfg)  # noqa: E731
    staged, eager = tt.jit(loss_fn), tt.jit(loss_fn, disable_jit_staging=True)
    batches = [_tiny_batch(cfg, dev, s) for s in range(4)]  # a new batch tensor, at a new address, each call
    before = _counts()
    got = [staged(params, *b) for b in batches]
    counts = _counts()
    stats = tt.last_staging(staged)
    assert stats.staged and stats.reason is None
    assert (stats.captures, stats.replays, stats.guard_misses) == (1, 3, 0)
    assert stats.first_call_s > 0 and stats.capture_s > 0 and stats.copied_bytes_per_call > 0
    want = [eager(params, *b) for b in batches]
    assert not tt.last_staging(eager).staged
    # Same kernels in the same order: the same bits; and each call's result is
    # its own (the later calls did not overwrite it).
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert len({g.data_ptr() for g in got}) == len(got)
    # A replay counts what its capture launched: launches per call.
    n = cfg.n_layer
    delta = {k: counts[k] - before[k] for k in counts if counts[k] != before[k]}
    assert delta == {"flash_attention_fwd": 4 * n, "apply_rope": 8 * n, "cross_entropy_rows": 4}

    # Params at new addresses: the address guard misses, the entry captures
    # again with them copied, and the answer is that of the new params.
    moved = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in params.items()}
    moved["lm_head_w"].mul_(0.5)
    got2 = [staged(moved, *batches[0]) for _ in range(2)]
    assert stats.guard_misses == 1 and stats.captures == 2
    want2 = eager(moved, *batches[0])
    assert all(torch.equal(g, want2) for g in got2) and not torch.equal(want2, want[0])


def test_staged_grads_equal_unstaged(dev):
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.models import gpt

    cfg = gpt.name_to_config(_TINY)
    params = gpt.init_params(cfg, seed=1, device=dev)
    f = lambda p, i, t: gpt.loss_fn(p, i, t, cfg)  # noqa: E731
    staged, eager = tt.value_and_grad(f), tt.value_and_grad(f, disable_jit_staging=True)
    idx, tgt = _tiny_batch(cfg, dev, 5)
    results = [staged(params, idx, tgt) for _ in range(3)]
    assert tt.last_staging(staged).replays == 2
    want_loss, want_grads = eager(params, idx, tgt)
    for loss, grads in results:
        torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
        # The same kernels in the same order, none adding with atomics: the same bits.
        assert all(torch.equal(g, w) for g, w in zip(grads, want_grads))
    assert results[0][1][0].data_ptr() != results[1][1][0].data_ptr()


def test_an_unforeseen_host_read_raises(dev):
    """A host read inside a staged program that the predicate did not see:
    at the warm-up it raises under the sync check; from the capture on it
    raises from the capture. Neither runs the program eagerly instead."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.core.prims import PrimIDs
    from thunder_tpu_torch.executors.staging import StagingError
    from thunder_tpu_torch.extend import OperatorExecutor

    reads = {"on": False}
    ex = OperatorExecutor("host_reader")

    def neg(a):
        if reads["on"]:
            a.sum().item()
        return torch.neg(a)

    ex.register_implementation(PrimIDs.NEG, fn=neg)
    x = _randn((64,), torch.float32, dev, 70)
    jf = tt.jit(lambda x: -x * 2.0, executors=[ex, "torch"])
    assert torch.equal(jf(x), -x * 2.0)  # the warm-up, no read
    reads["on"] = True
    with pytest.raises(StagingError, match="capture failed at `.*host_reader_neg"):
        jf(x)
    jf = tt.jit(lambda x: -x * 2.0, executors=[ex, "torch"])
    with pytest.raises(StagingError, match="reads the host at `.*host_reader_neg"):
        jf(x)


def test_staged_train_step_matches_the_eager_step(dev):
    """``Train.step`` (staged) against ``Train.step_eager`` from the same
    state: the loss within the 2-layer loss limit (1e-4) each step, the params
    updated in place."""
    from thunder_tpu_torch.benchmarks import train
    from thunder_tpu_torch.models import gpt

    cfg = gpt.name_to_config(_TINY)
    a = train.build_train(cfg, 2, 128, device=dev, seed=0)
    b = train.build_train(cfg, 2, 128, device=dev, seed=0)
    ptrs = [p.data_ptr() for p in a.flat_params]
    got = [float(a.step()) for _ in range(3)]
    want = [float(b.step_eager()) for _ in range(3)]
    assert a.staging.staged and (a.staging.captures, a.staging.replays) == (1, 2)
    assert [p.data_ptr() for p in a.flat_params] == ptrs
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-4 * abs(w)
    assert got[2] < got[0]


@pytest.mark.parametrize("optimizer,donate", [("adamw", False), ("sgd", True)])
def test_staged_build_train_step(dev, optimizer, donate):
    """Without donation the staged step leaves its inputs as they were and
    returns fresh params; with it the params are the caller's, updated in
    place. Losses as the unstaged step's from the same state."""
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.parallel import build_train_step

    cfg = gpt.name_to_config(_TINY)
    idx, tgt = _tiny_batch(cfg, dev, 3)

    def run(use_eager):
        params = gpt.init_params(cfg, seed=0, device=dev)
        step, opt = build_train_step(cfg, params, idx, tgt, optimizer=optimizer, donate=donate)
        fn = step.eager if use_eager else step
        losses, p, o = [], params, opt
        for _ in range(3):
            held = {k: v.clone() for k, v in p.items() if isinstance(v, torch.Tensor)}
            new_p, o, loss = fn(p, o, idx, tgt)
            same = all(torch.equal(held[k], p[k]) for k in held)
            assert same != donate  # inputs updated only under donation
            assert (new_p["lm_head_w"] is p["lm_head_w"]) == donate
            losses.append(float(loss))
            p = new_p
        return losses, step

    got, step = run(False)
    want, _ = run(True)
    assert step.staging.staged and step.staging.replays == 2
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-4 * abs(w)
