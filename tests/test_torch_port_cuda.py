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
import time

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


_BF16, _F16, _F32 = torch.bfloat16, torch.float16, torch.float32

# (B, T, H, G, D, which, dtype, offset): x is head group `which` (q, k or v)
# of a fused qkv projection (B, T, (H + 2G) * D) whose last dim starts
# `offset` elements into its buffer, or a contiguous (B, H, T, D). The cases
# cover every route of fusedex.rope_plan: copies of 16, 8, 4 and 2 bytes,
# flat tiles, partner reads of 8, 4, 2 and 1 elements, 16-byte or
# one-element stores, ragged tiles and head groups, and the direct route.
_ROPE_CASES = [
    (2, 64, 3, 3, 100, "k", _BF16, 0),  # head size 100: rows 8- and 16-byte aligned
    (2, 64, 3, 3, 100, "k", _F16, 0),
    (2, 64, 3, 3, 100, "k", _F32, 0),
    (2, 64, 4, 4, 64, "q", _BF16, 0),  # pythia-410m's head size: 16-byte copies, 8-element partners
    (2, 64, 4, 2, 80, "k", _BF16, 0),
    (2, 64, 4, 2, 72, "q", _BF16, 0),  # 4-element partners
    (2, 64, 4, 2, 128, "v", _BF16, 0),
    (2, 64, 8, 2, 100, "q", _BF16, 0),  # GQA: q, k and v of one projection
    (2, 64, 8, 2, 100, "k", _BF16, 0),
    (2, 64, 8, 2, 100, "v", _BF16, 0),
    (2, 64, 4, 4, 100, "contiguous", _BF16, 0),  # the backward's dq: flat 16-byte copies
    (2, 100, 4, 4, 100, "q", _BF16, 0),  # T not a multiple of the tile
    (2, 100, 4, 4, 100, "contiguous", _BF16, 0),  # a ragged flat tile
    (1, 77, 1, 1, 100, "q", _BF16, 0),  # B = H = 1, odd T: one-element stores
    (1, 64, 1, 1, 64, "contiguous", _BF16, 0),
    (8, 512, 7, 7, 100, "q", _BF16, 0),  # head groups of 2, the last one short
    (2, 64, 4, 4, 100, "q", _BF16, 2),  # rows 4-byte aligned only
    (2, 64, 4, 4, 100, "q", _BF16, 1),  # 2-byte aligned: one element a copy
    (2, 64, 2, 2, 98, "q", _BF16, 0),  # D / 2 odd: one-element partners
    (2, 64, 4, 4, 100, "q", _F16, 0),
    (2, 64, 4, 4, 100, "q", _F32, 0),
    (2, 64, 4, 4, 64, "contiguous", _F32, 0),
    (2, 64, 2, 2, 98, "q", _F32, 0),
    (10, 2048, 32, 32, 100, "q", _BF16, 0),  # the B=10 forward's q
    (1, 3, 1, 1, 60000, "contiguous", _F32, 0),  # a row too wide for shared memory
]


def _rope_input(B, T, H, G, D, which, dtype, offset, dev, seed):
    if which == "contiguous":
        return _randn((B, H, T, D), dtype, dev, seed)
    buf = _randn((B, T, (H + 2 * G) * D + offset), dtype, dev, seed)
    qkv = buf[..., offset:]
    lo, n = {"q": (0, H), "k": (H * D, G), "v": ((H + G) * D, G)}[which]
    return qkv[..., lo:lo + n * D].reshape(B, T, n, D).permute(0, 2, 1, 3)


@pytest.mark.parametrize("B,T,H,G,D,which,dtype,offset", _ROPE_CASES)
def test_rope_matches_plain(dev, B, T, H, G, D, which, dtype, offset):
    from thunder_tpu_torch.executors import fusedex

    x = _rope_input(B, T, H, G, D, which, dtype, offset, dev, 2)
    cos, sin = _randn((T, D), dtype, dev, 3), _randn((T, D), dtype, dev, 4)
    before = fusedex.apply_rope.launches
    got = fusedex.apply_rope(x, cos, sin)
    torch.cuda.synchronize()
    assert fusedex.apply_rope.launches == before + 1
    want = fusedex.rope_plain(x, cos, sin)
    assert got.shape == want.shape and got.dtype == dtype and got.is_contiguous()
    _assert_rows_close(got, want, 1)


@pytest.mark.parametrize("which", ["q", "contiguous"])
def test_rope_replays_in_a_cuda_graph(dev, which):
    """Rope captured in a CUDA graph and replayed on new inputs copied into
    the captured buffers gives the eager call's bits, three times over: the
    path's strided q view with sin, and the backward's contiguous input with
    -sin."""
    from thunder_tpu_torch.executors import fusedex

    B, T, H, D = 2, 2048, 32, 100
    x = _rope_input(B, T, H, H, D, which, torch.bfloat16, 0, dev, 40)
    cos, sin = _randn((T, D), torch.bfloat16, dev, 41), _randn((T, D), torch.bfloat16, dev, 42)
    if which == "contiguous":
        sin = -sin
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fusedex.apply_rope(x, cos, sin)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fusedex.apply_rope(x, cos, sin)
    for seed in (43, 44, 45):
        x.copy_(_rope_input(B, T, H, H, D, which, torch.bfloat16, 0, dev, seed))
        cos.copy_(_randn((T, D), torch.bfloat16, dev, seed + 10))
        graph.replay()
        assert torch.equal(out, fusedex.apply_rope(x, cos, sin))


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
# block's 256 threads, an odd D (one-element loads) and f32. Then the
# backward's plans (normex.bwd_plan): 16384 (above the old 14336 limit; the
# column sums in device memory), falcon-7b's 4544 and 5120 (8 warps a row),
# fewer rows than blocks (1, 5), a ragged last round of row groups (4097),
# rows 4-byte aligned only (1002: 4-byte loads from device memory), and
# 60000, too wide for one ring slot (and, in the forward, for shared memory).
# The forward's plans (normex.fwd_plan): rows in registers in 16-byte units
# (1, 4 and 8 warps a row), 4-byte units (1002) and one element (1001);
# 16384 takes a block a row, 60000 a block a row read twice.
_NORM_SHAPES = [
    (4096, 3200, torch.bfloat16, False, False),
    (4096, 1024, torch.bfloat16, True, True),
    (33, 1000, torch.float16, True, False),
    (17, 1001, torch.bfloat16, True, True),
    (7, 384, torch.float32, False, False),
    (5, 2600, torch.float32, True, True),
    (16, 16384, torch.bfloat16, False, False),
    (64, 4544, torch.bfloat16, True, True),
    (64, 5120, torch.bfloat16, False, False),
    (1, 1024, torch.bfloat16, True, True),
    (5, 3200, torch.bfloat16, False, False),
    (4097, 1024, torch.bfloat16, True, True),
    (33, 1002, torch.bfloat16, True, True),
    (3, 60000, torch.bfloat16, True, True),
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


@pytest.mark.parametrize("N,D,layer_norm", [(4096, 1024, True), (4096, 3200, False)])
def test_norm_bwd_is_reproducible(dev, N, D, layer_norm):
    """No atomics: dx, dw and db have the same bits every run, at both path
    shapes."""
    from thunder_tpu_torch.executors import normex

    x, w, _, g = _norm_inputs(N, D, torch.bfloat16, layer_norm, dev, 34)
    if layer_norm:
        a = normex.layer_norm_bwd(g, x, w, 1e-5, with_bias=True)
        b = normex.layer_norm_bwd(g, x, w, 1e-5, with_bias=True)
    else:
        a, b = normex.rms_norm_bwd(g, x, w), normex.rms_norm_bwd(g, x, w)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("N,D,layer_norm", [(4096, 1024, True), (4096, 3200, False), (16, 16384, False)])
def test_norm_bwd_replays_in_a_cuda_graph(dev, N, D, layer_norm):
    """A backward captured in a CUDA graph and replayed on new inputs copied
    into the captured buffers gives the eager call's bits, three times over:
    its two launches (rows, then the column sums) hold no state between
    calls."""
    from thunder_tpu_torch.executors import normex

    def bwd(g, x, w):
        if layer_norm:
            return normex.layer_norm_bwd(g, x, w, 1e-5, with_bias=True)
        return normex.rms_norm_bwd(g, x, w)

    x, w, _, g = _norm_inputs(N, D, torch.bfloat16, layer_norm, dev, 36)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bwd(g, x, w)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bwd(g, x, w)
    for seed in (37, 38, 39):
        nx, nw, _, ng = _norm_inputs(N, D, torch.bfloat16, layer_norm, dev, seed)
        x.copy_(nx), w.copy_(nw), g.copy_(ng)
        graph.replay()
        want = bwd(ng, nx, nw)
        assert all(torch.equal(p, q) for p, q in zip(out, want))


@pytest.mark.parametrize("N,D,layer_norm", [(4096, 1024, True), (4096, 3200, False), (16, 16384, False)])
def test_norm_fwd_is_reproducible(dev, N, D, layer_norm):
    """The forward has the same bits every run, at both path shapes and on
    the block-a-row route (16384)."""
    from thunder_tpu_torch.executors import normex

    x, w, b, _ = _norm_inputs(N, D, torch.bfloat16, layer_norm, dev, 46)
    fwd = (lambda: normex.layer_norm_fwd(x, w, b, 1e-5)) if layer_norm else (lambda: normex.rms_norm_fwd(x, w))
    assert torch.equal(fwd(), fwd())


@pytest.mark.parametrize("N,D,layer_norm", [(4096, 1024, True), (4096, 3200, False), (16, 16384, False)])
def test_norm_fwd_replays_in_a_cuda_graph(dev, N, D, layer_norm):
    """A forward captured in a CUDA graph and replayed on new inputs copied
    into the captured buffers gives the eager call's bits, three times over."""
    from thunder_tpu_torch.executors import normex

    def fwd(x, w, b):
        return normex.layer_norm_fwd(x, w, b, 1e-5) if layer_norm else normex.rms_norm_fwd(x, w)

    x, w, b, _ = _norm_inputs(N, D, torch.bfloat16, layer_norm, dev, 47)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fwd(x, w, b)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fwd(x, w, b)
    for seed in (48, 49, 50):
        nx, nw, nb, _ = _norm_inputs(N, D, torch.bfloat16, layer_norm, dev, seed)
        x.copy_(nx), w.copy_(nw)
        if b is not None:
            b.copy_(nb)
        graph.replay()
        assert torch.equal(out, fwd(nx, nw, nb))


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


# -- Keyed random draws (csrc/rng.cu) ------------------------------------------

_DRAW_CASES = [((1,), torch.float32), ((7,), torch.bfloat16), ((3, 1031), torch.float16),
               ((2, 2048, 3200), torch.bfloat16), ((4096, 32000), torch.float32), ((33, 65), torch.float32)]


@pytest.mark.parametrize("shape,dtype", _DRAW_CASES)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 3.7)])
def test_draw_kernel_is_bit_equal_to_plain(dev, shape, dtype, lo, hi):
    """The kernel and the plain version compute the same integer hash and
    round the float steps alike: the same bits."""
    from thunder_tpu_torch.executors import rngex

    key = torch.tensor(rngex.prng_key_words(1234), dtype=torch.int64, device=dev)
    for salt in (0, 5, None):
        got = rngex.draw(key, salt, shape, dtype, lo, hi)
        want = rngex.draw_plain(key, salt, shape, dtype, lo, hi)
        torch.cuda.synchronize()
        assert got.shape == shape and got.dtype == dtype
        assert torch.equal(got, want), f"salt {salt}: {(got != want).sum().item()} of {got.numel()} differ"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_normal_draw_kernel_matches_plain(dev, dtype):
    """The same uniform bits; erfinv is CUDA's erfinvf in the kernel and
    torch's erfinv in the plain version: within two ulps of the result."""
    from thunder_tpu_torch.executors import rngex

    key = torch.tensor(rngex.prng_key_words(7), dtype=torch.int64, device=dev)
    got = rngex.draw(key, 3, (257, 129), dtype, normal=True)
    want = rngex.draw_plain(key, 3, (257, 129), dtype, normal=True)
    eps = torch.finfo(dtype).eps
    torch.testing.assert_close(got, want, rtol=2 * eps, atol=2 * eps)


def test_staged_dropout_draws_afresh_on_each_replay_and_equals_unstaged(dev):
    import torch.nn.functional as F

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.executors import rngex

    x = _randn((4, 64, 256), torch.bfloat16, dev, 0)
    staged = tt.jit(lambda x: F.dropout(x, 0.1))
    eager = tt.jit(lambda x: F.dropout(x, 0.1), disable_jit_staging=True)
    before = rngex.draw.launches
    tt.seed(77)
    got = [staged(x) for _ in range(5)]
    stats = tt.last_staging(staged)
    assert stats.staged and (stats.captures, stats.replays) == (1, 4)
    assert rngex.draw.launches - before == 5
    masks = [g == 0 for g in got]
    assert all(not torch.equal(a, b) for a, b in zip(masks, masks[1:]))
    tt.seed(77)
    want = [eager(x) for _ in range(5)]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_staged_input_update_is_copied_back(dev):
    """An input updated in place by the program: its final value comes out
    of the graph and is copied into the caller's tensor each call."""
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ltorch

    def f(a, b):
        ltorch.add_(a, b)
        return ltorch.mul(a, 2.0)

    b = _randn((64, 128), torch.float32, dev, 1)
    a_staged, a_eager = _randn((64, 128), torch.float32, dev, 0), _randn((64, 128), torch.float32, dev, 0)
    staged, eager = tt.jit(f), tt.jit(f, disable_jit_staging=True)
    for _ in range(4):
        out_s, out_e = staged(a_staged, b), eager(a_eager, b)
        assert torch.equal(out_s, out_e) and torch.equal(a_staged, a_eager)
    assert tt.last_staging(staged).replays == 3
    torch.testing.assert_close(a_staged, _randn((64, 128), torch.float32, dev, 0) + 4 * b, rtol=1e-6, atol=1e-6)


def test_staged_module_equals_the_unstaged_module(dev):
    """``jit(module)``'s forward and backward staged as a graph each: the
    outputs and grads of three calls as the unstaged module's, dropout draws
    included (the same seed)."""
    import thunder_tpu_torch as tt

    def make():
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Linear(64, 128), torch.nn.GELU(), torch.nn.Dropout(0.1),
                                   torch.nn.Linear(128, 32)).to(dev)

    m_s, m_e = make(), make()
    staged, eager = tt.jit(m_s), tt.jit(m_e, disable_jit_staging=True)
    x = _randn((16, 64), torch.float32, dev, 2)
    for net, tm in ((m_s, staged), (m_e, eager)):
        tt.seed(5)
        outs = []
        for _ in range(3):
            net.zero_grad(set_to_none=True)
            out = tm(x)
            out.square().sum().backward()
            outs.append((out.detach(), [p.grad.clone() for p in net.parameters()]))
        net.outs = outs
    assert tt.last_staging(staged).staged and tt.last_staging(staged).replays == 2
    assert tt.compile_stats(staged).last_backward_staging.staged
    assert not tt.last_staging(eager).staged
    for (o_s, g_s), (o_e, g_e) in zip(m_s.outs, m_e.outs):
        assert torch.equal(o_s, o_e)
        assert all(torch.equal(a, b) for a, b in zip(g_s, g_e))
    assert not torch.equal(m_s.outs[0][0], m_s.outs[1][0])


@pytest.mark.parametrize("batches", ["same_input_twice", "fresh_input_each_call"])
def test_staged_module_lends_its_saved_tensors_and_two_forwards_keep_theirs(dev, batches):
    """The staged forward lends its saved tensors to the backward's graph (no
    copy either way once the backward has settled). Two forwards in flight,
    the second a replay with no guard miss: the same input twice (R-Drop, its
    dropout drawing two masks), or a fresh batch tensor each call (a copied
    input). The second replay first moves the first forward's saved tensors
    out of the graph's buffers: the forward is not captured again, and the
    grads of the two losses' sum are the unstaged module's."""
    import thunder_tpu_torch as tt

    def make():
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.GELU(), torch.nn.Dropout(0.1),
                                   torch.nn.Linear(256, 64)).to(dev)

    x = _randn((32, 64), torch.float32, dev, 0)
    fresh = [x + i for i in range(6)]  # six live tensors: six addresses
    batch = (lambda i: x) if batches == "same_input_twice" else (lambda i: fresh[i])
    m_s, m_e = make(), make()
    staged, eager = tt.jit(m_s), tt.jit(m_e, disable_jit_staging=True)
    for net, tm in ((m_s, staged), (m_e, eager)):
        tt.seed(11)
        for i in range(4):  # warm-up, capture, settle, replays
            net.zero_grad(set_to_none=True)
            tm(batch(i)).square().sum().backward()
        net.zero_grad(set_to_none=True)
        a, b = tm(batch(4)), tm(batch(5))  # two forwards in flight
        (a.square().sum() + b.square().sum()).backward()
        net.outs = (a.detach(), b.detach())
        net.grads = [p.grad.clone() for p in net.parameters()]
    fst = tt.compile_stats(staged).last_staging
    assert fst.staged and (fst.captures, fst.guard_misses, fst.replays) == (1, 0, 5)
    assert all(torch.equal(s, e) for s, e in zip(m_s.outs, m_e.outs))
    assert not torch.equal(*m_s.outs)
    assert all(torch.equal(s, e) for s, e in zip(m_s.grads, m_e.grads))


def test_staged_module_keeps_one_graph_per_mask_verdict(dev):
    """A module's masked attention, staged, over masks of three verdicts
    (causal, full, the exact branch) in turn: each verdict is an entry of its
    own (a value guard) with its own graph, so no replay runs under another
    mask's verdict. Outputs equal to the unstaged module's; no mask read on
    the host."""
    import torch.nn.functional as F

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.executors import flashex

    class Attn(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.randn(64, 64, dtype=torch.bfloat16) * 0.1)

        def forward(self, x, mask):
            q = (x @ self.w).reshape(2, 128, 4, 16).transpose(1, 2)
            return F.scaled_dot_product_attention(q, q, q, attn_mask=mask)

    torch.manual_seed(0)
    m = Attn().to(dev)
    staged, eager = tt.jit(m), tt.jit(m, disable_jit_staging=True)
    x = _randn((2, 128, 64), torch.bfloat16, dev, 0)
    i = torch.arange(128, device=dev)
    masks = {2: (i[None, :] <= i[:, None])[None, None].expand(2, 1, 128, 128).contiguous(),
             1: torch.ones((2, 1, 128, 128), dtype=torch.bool, device=dev),
             0: torch.rand((2, 1, 128, 128), device=dev) > 0.3}
    reads = flashex.mask_plan.host_reads
    with torch.no_grad():
        for n, verdict in enumerate([2, 1, 0] * 3):
            assert torch.equal(staged(x, masks[verdict]), eager(x, masks[verdict]))
            st = tt.last_staging(staged)
            assert st.staged and (st.captures, st.replays) == (int(n >= 3), n // 3)
    assert tt.compile_stats(staged).cache_misses == 3
    assert flashex.mask_plan.host_reads == reads


def test_settled_backward_copies_only_its_cotangents(dev):
    import thunder_tpu_torch as tt

    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.GELU(), torch.nn.Linear(256, 64)).to(dev)
    tm = tt.jit(m)
    x = _randn((32, 64), torch.float32, dev, 0)
    for _ in range(4):
        m.zero_grad(set_to_none=True)
        tm(x).sum().backward()
    cs = tt.compile_stats(tm)
    fst, bst = cs.last_staging, cs.last_backward_staging
    assert (bst.captures, bst.guard_misses) == (1, 0)
    # In: the (32, 64) f32 cotangent; out: nothing, the grads are lent.
    assert bst.copied_bytes_per_call == 32 * 64 * 4
    assert fst.copied_bytes_per_call == 32 * 64 * 4  # only the output: the saved tensors are lent


def test_staged_module_lends_its_grads_unless_they_are_kept(dev):
    """The staged backward lends its grads: autograd takes them as ``.grad``
    with no copy. Under gradient accumulation a ``.grad`` still holds a lent
    buffer when the backward's graph would run again: the graph is captured
    anew, the old buffers left to the grads, and it copies its grads from
    then on. The accumulated grads are the unstaged module's."""
    import thunder_tpu_torch as tt

    def make():
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.GELU(), torch.nn.Linear(256, 64)).to(dev)

    m_s, m_e = make(), make()
    staged, eager = tt.jit(m_s), tt.jit(m_e, disable_jit_staging=True)
    x = _randn((32, 64), torch.float32, dev, 0)
    for net, tm in ((m_s, staged), (m_e, eager)):
        for _ in range(4):  # warm-up, settle, capture, replay
            net.zero_grad(set_to_none=True)
            tm(x).square().sum().backward()
        for _ in range(3):  # accumulated
            tm(x).square().sum().backward()
        net.grads = [p.grad.clone() for p in net.parameters()]
    bst = tt.compile_stats(staged).last_backward_staging
    grads = sum(p.numel() * 4 for p in m_s.parameters())
    assert (bst.captures, bst.guard_misses, bst.copied_bytes_per_call) == (2, 0, 32 * 64 * 4 + grads)
    assert all(torch.equal(a, b) for a, b in zip(m_s.grads, m_e.grads))


# The int8 linear's product (csrc/int8_gemm.cu, wgmma/TMA; csrc/int8_gemm_sync.cu,
# mma.sync, for operands TMA cannot describe): int32 sums are exact and the
# epilogue rounds as the plain version does, so each route is bit-equal to it.
_INT8_SHAPES = [(4096, 9600, 3200), (333, 517, 64), (129, 65, 100), (77, 250, 8640), (1, 3, 3200), (200, 300, 65),
                (130, 257, 128), (255, 513, 3200), (4096, 3200, 8640)]


def _int8_operands(M, N, K, dev):
    gen = torch.Generator(device="cpu").manual_seed(M + N + K)
    qa = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8).to(dev)
    qw = torch.randint(-127, 128, (N, K), generator=gen, dtype=torch.int8).to(dev)
    scale = (torch.rand(N, generator=gen) * 1e-3 + 1e-5).to(dev)
    return qa, qw, scale


@pytest.mark.parametrize("M,N,K", _INT8_SHAPES)
@pytest.mark.parametrize("dtype,with_bias", [(torch.bfloat16, False), (torch.float32, True), (torch.float16, True)])
def test_int8_gemm_is_bit_equal_to_plain(dev, M, N, K, dtype, with_bias):
    from thunder_tpu_torch.executors import quantex

    qa, qw, scale = _int8_operands(M, N, K, dev)
    bias = _randn((N,), dtype, dev, 3) if with_bias else None
    n = quantex.int8_gemm.launches + quantex.int8_gemm_sync.launches
    got = quantex.int8_gemm(qa, qw, scale, bias, dtype)
    torch.cuda.synchronize()
    assert quantex.int8_gemm.launches + quantex.int8_gemm_sync.launches == n + 1
    want = quantex.int8_gemm_plain(qa, qw, scale, bias, dtype)
    assert got.dtype == dtype and torch.equal(got, want)


def test_int8_gemm_reads_an_unaligned_operand(dev):
    """A view whose base is not 16-byte aligned takes the byte-wise path."""
    from thunder_tpu_torch.executors import quantex

    gen = torch.Generator(device="cpu").manual_seed(0)
    qa = torch.randint(-127, 128, (64 * 129 + 1,), generator=gen, dtype=torch.int8).to(dev)[1:].view(64, 129)
    qw = torch.randint(-127, 128, (96, 129), generator=gen, dtype=torch.int8).to(dev)
    scale = torch.full((96,), 0.01, device=dev)
    got = quantex.int8_gemm(qa, qw, scale, None, torch.float32)
    assert torch.equal(got, quantex.int8_gemm_plain(qa, qw, scale, None, torch.float32))


@pytest.mark.parametrize("K,offset,route", [(3200, 0, "int8_gemm"), (128, 0, "int8_gemm"), (100, 0, "int8_gemm_sync"),
                                            (3200, 16, "int8_gemm"), (3200, 8, "int8_gemm_sync")])
def test_int8_gemm_route_is_chosen_by_shape(dev, K, offset, route):
    """An operand TMA can describe (16-byte-aligned base and rows) launches
    the wgmma kernel, any other the mma.sync kernel; each route counts its
    own launches, and both are bit-equal to the plain version."""
    from thunder_tpu_torch.executors import quantex

    qa, qw, scale = _int8_operands(64, 96, K, dev)
    buf = torch.zeros(64 * K + offset, dtype=torch.int8, device=dev)
    qa = buf[offset:].view(64, K).copy_(qa)
    counts = {r: getattr(quantex, r).launches for r in ("int8_gemm", "int8_gemm_sync")}
    got = quantex.int8_gemm(qa, qw, scale, None, torch.bfloat16)
    torch.cuda.synchronize()
    assert {r: getattr(quantex, r).launches - n for r, n in counts.items()} == {
        r: int(r == route) for r in counts}
    assert torch.equal(got, quantex.int8_gemm_plain(qa, qw, scale, None, torch.bfloat16))


def test_int8_gemm_k_tail_is_read(dev):
    """K = 8640 leaves half of the last 128-byte stage past the end: the sum
    must hold the tail's terms (the K tail left unread differs)."""
    from thunder_tpu_torch.executors import quantex

    qa, qw, scale = _int8_operands(256, 256, 8640, dev)
    want = quantex.int8_gemm_plain(qa, qw, scale, None, torch.float32)
    assert torch.equal(quantex.int8_gemm(qa, qw, scale, None, torch.float32), want)
    cut = quantex.int8_gemm(qa[:, :8640 - 16].contiguous(), qw[:, :8640 - 16].contiguous(), scale, None,
                            torch.float32)
    assert not torch.equal(cut, want)


# The quantization kernels (csrc/quantize.cu) against their plain versions:
# the same division, rounding and max, so the same bits.
_QUANT_SHAPES = [(9600, 3200), (3200, 8640), (77, 101), (5, 3, 8), (4096, 3200), (33, 8640), (1, 7)]


def _quant_input(shape, dtype, dev, seed, contiguous=True):
    x = _randn(shape[:-1] + (shape[-1] + (0 if contiguous else 24),), dtype, dev, seed) * 0.05
    return x if contiguous else x[..., 24:]


@pytest.mark.parametrize("shape", _QUANT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("contiguous", [True, False])
def test_quantize_kernels_are_bit_equal_to_plain(dev, shape, dtype, contiguous):
    from thunder_tpu_torch.executors import quantex

    x = _quant_input(shape, dtype, dev, sum(shape), contiguous)
    n = quantex.quantize_tensor.launches
    q, s = quantex.quantize_tensor(x, 127.0)
    torch.cuda.synchronize()
    assert quantex.quantize_tensor.launches == n + 1
    qp, sp = quantex.quantize_per_tensor(x, 127.0)
    assert q.dtype == torch.int8 and tuple(q.shape) == shape and torch.equal(q, qp) and torch.equal(s, sp)
    if x.ndim == 2:
        n = quantex.quantize_rows.launches
        q, s = quantex.quantize_rows(x, 127.0)
        torch.cuda.synchronize()
        assert quantex.quantize_rows.launches == n + 1
        qp, sp = quantex.quantize_per_channel(x, 127.0)
        assert tuple(s.shape) == (shape[0], 1) and torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.parametrize("qmax", [127.0, 127.0 / 4])
def test_quantize_kernels_zero_rows_ties_and_nan(dev, qmax):
    """An all-zero row takes the 1e-6 floor; halves round to even; a NaN in
    the input makes the scale NaN, as torch.amax propagates it."""
    from thunder_tpu_torch.executors import quantex

    x = _randn((6, 256), torch.float32, dev, 5)
    x[1] = 0.0
    x[2, :4] = torch.tensor([qmax, 0.5, 1.5, -2.5], device=dev)
    x[2, 4:] = 0.25
    q, s = quantex.quantize_rows(x, qmax)
    qp, sp = quantex.quantize_per_channel(x, qmax)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    assert s[2, 0].item() == 1.0 and q[2, :4].tolist() == [127 if qmax == 127.0 else 32, 0, 2, -2]
    x[4, 7] = float("nan")
    q, s = quantex.quantize_rows(x, qmax)
    qp, sp = quantex.quantize_per_channel(x, qmax)
    assert torch.isnan(s[4, 0]) and torch.isnan(sp[4, 0])
    keep = torch.arange(6, device=dev) != 4
    assert torch.equal(s[keep], sp[keep]) and torch.equal(q[keep], qp[keep])
    qt, st = quantex.quantize_tensor(x, qmax)
    assert torch.isnan(st) and torch.isnan(quantex.quantize_per_tensor(x, qmax)[1])


def test_quantize_tensor_replayed_graph_takes_each_calls_max(dev):
    """The amax word is zeroed inside the captured work: two replays on
    inputs with different maxima give different scales, each the plain
    version's."""
    from thunder_tpu_torch.executors import quantex

    x = _randn((512, 3200), torch.bfloat16, dev, 7)
    quantex.quantize_tensor(x, 127.0)  # load the library outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q, s = quantex.quantize_tensor(x, 127.0)
    scales = []
    for factor in (4.0, 0.5):
        x.copy_(_randn((512, 3200), torch.bfloat16, dev, 7) * factor)
        graph.replay()
        torch.cuda.synchronize()
        qp, sp = quantex.quantize_per_tensor(x, 127.0)
        assert torch.equal(q, qp) and torch.equal(s, sp)
        scales.append(s.item())
    assert scales[0] > scales[1]


def test_quantize_reciprocal_fault_differs(dev):
    """The planted fault (products with the reciprocal in place of the
    divisions) moves the per-row scales' bits: the comparison sees it."""
    from thunder_tpu_torch.executors import quantex

    w = _randn((9600, 3200), torch.bfloat16, dev, 8) * 0.02
    q, s = quantex._quantize_rows_launch(w, 127.0, fault_reciprocal=True)
    qp, sp = quantex.quantize_per_channel(w, 127.0)
    assert not torch.equal(s, sp)


def test_quant_linear_claims_and_launches_the_kernel(dev):
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ltorch
    from thunder_tpu_torch.executors import quantex

    a, w = _randn((4, 32, 256), torch.bfloat16, dev, 0), _randn((512, 256), torch.bfloat16, dev, 1) * 0.05
    f = tt.jit(lambda a, w: ltorch.linear(a, w), executors=["quant", "torch"], disable_jit_staging=True)
    n = quantex.int8_gemm.launches
    out = f(a, w)
    assert quantex.int8_gemm.launches == n + 1
    want = quantex.quant_linear(a.cpu(), w.cpu())
    assert torch.equal(out.cpu(), want)


def test_staged_container_write_survives_the_next_call(dev):
    """A staged entry's tensor written into the caller's dict is a fresh
    tensor, not a buffer of the graph's pool: the next replay leaves it."""
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ltorch

    def f(d):
        d["k"] = ltorch.mul(d["x"], 2.0)
        return ltorch.sum(d["x"])

    jf = tt.jit(f)
    held = []
    for i in range(4):
        d = {"x": torch.full((64, 128), float(i), device=dev)}
        jf(d)
        held.append(d["k"])
    assert tt.last_staging(jf).staged and tt.last_staging(jf).replays == 3
    for i, k in enumerate(held):
        assert torch.equal(k, torch.full((64, 128), 2.0 * i, device=dev)), i


def test_one_graph_per_bucket_and_replays_equal_unstaged(dev):
    """``cache="symbolic values"``: lengths 100 and 120 share the (0, 128]
    bucket, one entry and one graph, captured at 128; 200 is the next
    bucket. Every call equals the unstaged entry's, and the shorter call
    after the longer reads no leftover row (the padded tail is zeroed)."""
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ltorch

    def f(x, w):
        return ltorch.mean(ltorch.matmul(ltorch.exp(x), w), 1)

    w = _randn((64, 32), torch.float32, dev, 1)
    opts = dict(cache="symbolic values", symbolic_dims={0: (1,)}, buckets={"seq": 128})
    staged, eager = tt.jit(f, **opts), tt.jit(f, disable_jit_staging=True, **opts)
    for T in (120, 100, 120, 100, 200, 100):
        x = _randn((2, T, 64), torch.float32, dev, T)
        got, want = staged(x, w), eager(x, w)
        assert got.shape == (2, 32) and torch.equal(got, want), T
        torch.testing.assert_close(got, torch.exp(x).matmul(w).mean(1), rtol=1e-5, atol=1e-5)
    info = tt.cache_info(staged)
    assert info["compiles"] == 2 and [e["buckets"] for e in info["entries"]] == ["leaf0.dim1∈(0,128]",
                                                                                   "leaf0.dim1∈(128,256]"]
    first = tt.compile_stats(staged).cache_entries[0].staging
    assert first.staged and (first.captures, first.replays, first.guard_misses) == (1, 4, 0)


def test_staged_module_step_shares_one_pool_and_frees_saved_tensors(dev):
    """The staged module's forward and backward graphs share one memory
    pool: the backward's capture reuses the saved tensors' memory as they
    die, so a staged step's peak is the unstaged step's within a margin, and
    its grads equal the unstaged module's."""
    import thunder_tpu_torch as tt

    def make():
        torch.manual_seed(0)
        layers = [m for _ in range(8) for m in (torch.nn.Linear(1024, 1024), torch.nn.GELU())]
        return torch.nn.Sequential(*layers, torch.nn.Linear(1024, 8)).to(dev)

    import gc

    x = _randn((4096, 1024), torch.float32, dev, 0)
    peaks, grads = {}, {}
    for label, kw in (("unstaged", dict(disable_jit_staging=True)), ("staged", {})):
        gc.collect()  # the previous run's module and graphs, held in reference cycles
        net = make()
        tm = tt.jit(net, **kw)
        for step in range(4):
            net.zero_grad(set_to_none=True)
            if step == 1:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            tm(x).square().mean().backward()
        torch.cuda.synchronize()
        peaks[label] = torch.cuda.max_memory_allocated() - base  # above what the run holds between steps
        grads[label] = [p.grad.cpu() for p in net.parameters()]
        if label == "staged":
            cs = tt.compile_stats(tm)
            assert (cs.last_staging.captures, cs.last_backward_staging.captures) == (1, 1)
        del tm, net
    assert all(torch.equal(a, b) for a, b in zip(grads["staged"], grads["unstaged"]))
    # The saved activations are 8 x 16 MiB; the backward's grads (32 MiB)
    # and its 16 MiB temporaries go where they die, as in eager. The gap
    # left is cuBLAS's workspace for the capture's stream (32 MiB on an
    # H100, allocated in the pool at the first product captured), and the
    # small output's copies; without the reuse it is over 96 MiB.
    assert peaks["staged"] <= peaks["unstaged"] + (40 << 20), (peaks["staged"] / 2**20, peaks["unstaged"] / 2**20)


def test_staged_seq_bucket_module_trains_as_unstaged(dev):
    """``jit(module, seq_bucket=64)`` staged: lengths 50 and 60 share one
    entry, one forward graph and one backward graph (the padded inputs are
    copied in each call), and each step's output and grads equal the
    unstaged module's."""
    import thunder_tpu_torch as tt

    class Causal(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.wte = torch.nn.Embedding(64, 128)
            self.qkv = torch.nn.Linear(128, 384)
            self.head = torch.nn.Linear(128, 64)

        def forward(self, idx):
            x = self.wte(idx)
            B, T, C = x.shape
            qkv = self.qkv(x).view(B, T, 3, 4, 32).permute(2, 0, 3, 1, 4)
            y = torch.nn.functional.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], is_causal=True)
            return self.head(x + y.transpose(1, 2).reshape(B, T, C))

    def make():
        torch.manual_seed(0)
        return Causal().to(dev, torch.bfloat16)

    m_s, m_e = make(), make()
    staged, eager = tt.jit(m_s, seq_bucket=64), tt.jit(m_e, seq_bucket=64, disable_jit_staging=True)
    gen = torch.Generator(device="cpu").manual_seed(1)
    for T in (50, 60, 50, 60):
        idx = torch.randint(0, 64, (2, T), generator=gen).to(dev)
        outs = []
        for net, tm in ((m_s, staged), (m_e, eager)):
            net.zero_grad(set_to_none=True)
            out = tm(idx)
            out.float().square().mean().backward()
            outs.append((out.detach(), [p.grad.clone() for p in net.parameters()]))
        (o_s, g_s), (o_e, g_e) = outs
        assert o_s.shape == (2, T, 64) and torch.equal(o_s, o_e), T
        assert all(torch.equal(a, b) for a, b in zip(g_s, g_e)), T
    cs = tt.compile_stats(staged)
    assert cs.cache_misses == 1 and cs.last_staging.captures == 1 and cs.last_backward_staging.captures == 1
    assert cs.last_staging.guard_misses == 0


# =============================================================================
# vmap: the kernels' batching rules on the card (executors/batching.py)
# =============================================================================

_V = 3


def _launched(*wrappers):
    return [w.launches for w in wrappers]


@pytest.mark.parametrize("in_dims", [(0, 0, 0), (0, None, None), (1, 1, None)], ids=str)
def test_flash_rules_under_vmap_launch_once_and_match_plain(dev, in_dims):
    from thunder_tpu_torch.executors import batching, flashex

    shapes = [(1, 4, 256, 100), (1, 2, 256, 100), (1, 2, 256, 100)]
    ops = [_randn(s, torch.bfloat16, dev, 30 + i) if d is None
           else torch.stack([_randn(s, torch.bfloat16, dev, 40 + 3 * i + j) for j in range(_V)], d)
           for i, (s, d) in enumerate(zip(shapes, in_dims))]
    dout = torch.stack([_randn(shapes[0], torch.bfloat16, dev, 60 + j) for j in range(_V)])

    def sl(t, d, j):
        return t if d is None else t.select(d, j)

    wrappers = (flashex.flash_attention_fwd_lse, flashex.flash_attention_bwd)
    before = _launched(*wrappers)
    out, lse = torch.func.vmap(lambda q, k, v: batching.flash_fwd_lse(q, k, v, True, 0.1), in_dims=in_dims)(*ops)
    grads = torch.func.vmap(lambda g, q, k, v, o, s: batching.flash_bwd(g, q, k, v, o, s, True, 0.1),
                            in_dims=(0,) + in_dims + (0, 0))(dout, *ops, out, lse)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launched(*wrappers), before)] == [1, 1]
    for j in range(_V):
        q, k, v = (sl(t, d, j) for t, d in zip(ops, in_dims))
        wo, wl = flashex.flash_attention_lse_plain(q, k, v, causal=True, scale=0.1)
        _assert_rows_close(out[j], wo, 2)
        torch.testing.assert_close(lse[j], wl, rtol=0, atol=2e-2)
        want = flashex.flash_attention_bwd_plain(dout[j], q, k, v, wo, wl, causal=True, scale=0.1)
        for g, w in zip(grads, want):
            _assert_rows_close(g[j], w, 8, floor=2e-2 * float(w.float().abs().max()))


def test_legacy_and_recompute_rules_under_vmap(dev):
    """Row 10's wrappers and the recompute backward fold the slices as the
    flash rules do: one launch a call."""
    from thunder_tpu_torch.executors import batching, flashex

    q, k, v, dout = (torch.stack([_randn((1, 4, 256, 64), torch.bfloat16, dev, 10 * i + j) for j in range(_V)])
                     for i in range(4))
    wrappers = (flashex.legacy_flash_fwd, flashex.legacy_flash_bwd, flashex.flash_attention_bwd_recompute)
    before = _launched(*wrappers)
    out = torch.func.vmap(lambda a, b, c: batching.legacy_fwd(a, b, c, True, 0.125))(q, k, v)
    lg = torch.func.vmap(lambda g, a, b, c: batching.legacy_bwd(g, a, b, c, True, 0.125))(dout, q, k, v)
    rg = torch.func.vmap(lambda g, a, b, c: batching.flash_bwd_recompute(g, a, b, c, True, 0.125))(dout, q, k, v)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launched(*wrappers), before)] == [1, 1, 1]
    for j in range(_V):
        _assert_rows_close(out[j], flashex.flash_attention_plain(q[j], k[j], v[j], causal=True, scale=0.125), 2)
        want = flashex.flash_attention_bwd_recompute_plain(dout[j], q[j], k[j], v[j], causal=True, scale=0.125)
        for got in (lg, rg):
            for g, w in zip(got, want):
                _assert_rows_close(g[j], w, 8, floor=2e-2 * float(w.float().abs().max()))


def test_rope_and_cross_entropy_rules_under_vmap(dev):
    from thunder_tpu_torch.executors import batching, fusedex

    x = torch.stack([_randn((2, 4, 128, 100), torch.bfloat16, dev, j) for j in range(_V)], 1)
    cos, sin = _randn((128, 100), torch.bfloat16, dev, 7), _randn((128, 100), torch.bfloat16, dev, 8)
    before = fusedex.apply_rope.launches
    got = torch.func.vmap(batching.rope, in_dims=(1, None, None))(x, cos, sin)
    assert fusedex.apply_rope.launches == before + 1
    for j in range(_V):
        _assert_rows_close(got[j], fusedex.rope_plain(x[:, j], cos, sin), 1)
    logits = torch.stack([_randn((256, 32000), torch.float32, dev, 10 + j) for j in range(_V)])
    target = torch.randint(0, 32000, (_V, 256), device=dev, generator=torch.Generator(dev).manual_seed(0))
    target[:, ::7] = -100
    scale = torch.rand(_V, 256, device=dev, generator=torch.Generator(dev).manual_seed(1))
    wrappers = (fusedex.cross_entropy_rows, fusedex.cross_entropy_bwd)
    before = _launched(*wrappers)
    rows = torch.func.vmap(lambda a, t: batching.ce_rows(a, t, -100))(logits, target)
    dl = torch.func.vmap(batching.ce_bwd)(logits, target, scale)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launched(*wrappers), before)] == [1, 1]
    for j in range(_V):
        torch.testing.assert_close(rows[j], fusedex.cross_entropy_rows_plain(logits[j], target[j], -100),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dl[j], fusedex.cross_entropy_bwd_plain(logits[j], target[j], scale[j]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("layer_norm,D", [(False, 3200), (True, 1024), (False, 100)])
def test_norm_rules_under_vmap_keep_dw_per_slice(dev, layer_norm, D):
    """The backward's column sums run in V segments: dw (and db) come a row
    a slice, each the sum over its own slice's rows only."""
    from thunder_tpu_torch.executors import batching, normex

    x = torch.stack([_randn((2, 512, D), torch.bfloat16, dev, j) for j in range(_V)])
    g = torch.stack([_randn((2, 512, D), torch.bfloat16, dev, 20 + j) for j in range(_V)])
    w = _randn((D,), torch.bfloat16, dev, 40)
    b = _randn((D,), torch.bfloat16, dev, 41) if layer_norm else None
    fwd, bwd = (normex.layer_norm_fwd, normex.layer_norm_bwd) if layer_norm else (normex.rms_norm_fwd,
                                                                                 normex.rms_norm_bwd)
    before = _launched(fwd, bwd)
    y = torch.func.vmap(lambda a: batching.norm_fwd(a, w, b, 1e-5, layer_norm))(x)
    dx, dw, db = torch.func.vmap(lambda gg, a: batching.norm_bwd(gg, a, w, 1e-5, layer_norm, layer_norm, 1),
                                 out_dims=(0, 0, 0 if layer_norm else None))(g, x)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_launched(fwd, bwd), before)] == [1, 1]
    assert dw.shape == (_V, D) and (db is None) == (not layer_norm)
    for j in range(_V):
        _assert_rows_close(y[j], normex.norm_fwd_plain(x[j], w, b, 1e-5, layer_norm=layer_norm), 1)
        wdx, wdw, wdb = normex.norm_bwd_plain(g[j], x[j], w, 1e-5, layer_norm=layer_norm, with_bias=layer_norm)
        _assert_rows_close(dx[j], wdx, 2)
        torch.testing.assert_close(dw[j], wdw, rtol=1e-4, atol=1e-4 * float(wdw.abs().max()))
        if layer_norm:
            torch.testing.assert_close(db[j], wdb, rtol=1e-4, atol=1e-4 * float(wdb.abs().max()))


def test_per_sample_grads_on_the_card_launch_once_a_call_site(dev):
    """vmap(grad(loss)) of a 2-layer model at open_llama_3b's head size: the
    B = 1 grad program's launches, once each, and each slice's grads within
    phase 4's limit (2^-4 of the largest element) of grad at B = 1."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.executors import _build
    from thunder_tpu_torch.models import gpt

    cfg = gpt.name_to_config("llama-hs100-tiny")
    params = gpt.init_params(cfg, dtype=torch.bfloat16, seed=0, device=dev)
    idx = torch.randint(0, cfg.vocab_size, (2, 1, 128), device=dev, generator=torch.Generator(dev).manual_seed(0))
    g = tt.grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg))
    ps = tt.vmap(g, in_axes=(None, 0, 0))
    for _ in range(3):  # warm-up, capture, replay
        before = _build.launch_counts()
        got = ps(params, idx, idx.roll(1, -1))
        torch.cuda.synchronize()
        n_vmap = {k: v - before[k] for k, v in _build.launch_counts().items() if v != before[k]}
    before = _build.launch_counts()
    want = [g(params, idx[s], idx[s].roll(1, -1)) for s in range(2)]
    torch.cuda.synchronize()
    n_grad = {k: (v - before[k]) // 2 for k, v in _build.launch_counts().items() if v != before[k]}
    assert n_vmap == n_grad and n_vmap
    assert tt.last_staging(ps).staged
    for s in range(2):
        for a, w in zip(got, want[s]):
            err = float((a[s].float() - w.float()).abs().max())
            assert err <= 2.0 ** -4 * float(w.float().abs().max()) + 1e-6


def test_same_input_call_with_other_shapes_raises_from_staging(dev):
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.clang as clang
    from thunder_tpu_torch.executors.staging import StagingError

    jf = tt.jit(lambda x: clang.mul(x, 2.0), cache="same input")
    a = torch.ones(64, device=dev)
    for _ in range(3):
        torch.testing.assert_close(jf(a), a * 2)
    big = torch.ones(4096, device=dev)
    with pytest.raises(StagingError, match="same input"):
        jf(big)
    torch.testing.assert_close(jf(a), a * 2)  # the graph still holds its own buffers


def test_no_caching_entry_runs_eagerly(dev):
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.clang as clang

    jf = tt.jit(lambda x: clang.mul(x, 2.0), cache="no caching")
    a = torch.ones(64, device=dev)
    for _ in range(3):
        torch.testing.assert_close(jf(a), a * 2)
    assert not tt.last_staging(jf).staged and "no caching" in tt.last_staging(jf).reason


def test_kernel_wrapper_refuses_a_dual_tensor(dev):
    from torch.autograd import forward_ad

    from thunder_tpu_torch.executors import flashex, fusedex

    x = _randn((1, 2, 128, 64), torch.bfloat16, dev, 0)
    cos, sin = _randn((128, 64), torch.bfloat16, dev, 1), _randn((128, 64), torch.bfloat16, dev, 2)
    before = fusedex.apply_rope.launches, flashex.flash_attention_fwd.launches
    with forward_ad.dual_level():
        dual = forward_ad.make_dual(x, torch.ones_like(x))
        with pytest.raises(NotImplementedError, match="rope"):
            fusedex.apply_rope(dual, cos, sin)
        with pytest.raises(NotImplementedError, match="flash_fwd"):
            flashex.flash_attention_fwd(dual, x, x, causal=True, scale=0.125)
    with pytest.raises(NotImplementedError, match="flash_fwd"):
        torch.func.jvp(lambda q: flashex.flash_attention_fwd(q, x, x, causal=True, scale=0.125), (x,), (x,))
    assert (fusedex.apply_rope.launches, flashex.flash_attention_fwd.launches) == before


def test_jvp_on_the_card_launches_no_kernel(dev):
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.executors import _build
    from thunder_tpu_torch.models import gpt

    cfg = gpt.name_to_config("llama-hs100-tiny")
    params = gpt.init_params(cfg, dtype=torch.bfloat16, seed=0, device=dev)
    idx = torch.randint(0, cfg.vocab_size, (1, 128), device=dev, generator=torch.Generator(dev).manual_seed(0))
    tangent = {k: v for k, v in params.items()}
    before = _build.launch_counts()
    loss, t = tt.jvp(lambda p, i, tg: gpt.loss_fn(p, i, tg, cfg), (params, idx, idx.roll(1, -1)),
                     (tangent, 0, 0))
    torch.cuda.synchronize()
    assert _build.launch_counts() == before
    assert torch.isfinite(loss) and torch.isfinite(t)


# =============================================================================
# The last batching rules: masked attention, the int8 linear, a norm weight
# and rope tables a slice. Each slice's result against the unbatched wrapper
# on that slice, bit for bit where the kernel computes a row (or a problem)
# independently of the others; launches once a call site (masked attention:
# once a verdict present).
# =============================================================================


def _slice_masks(T: int, pad: int, dev) -> torch.Tensor:
    """(3, 1, 1, T, T) bool masks whose verdicts are 0, 1 and 2: a random
    mask (the exact branch), a left-padded full mask, a left-padded causal one."""
    gen = torch.Generator().manual_seed(5)
    kv = torch.arange(T) >= pad
    tri = torch.ones(T, T, dtype=torch.bool).tril()
    full = kv[None, :].expand(T, T)
    return torch.stack([torch.rand(T, T, generator=gen) > 0.3, full, tri & full])[:, None, None].to(dev)


def test_masked_attention_rule_takes_each_slices_verdict(dev):
    """Slices with verdicts 0, 1 and 2 in one call: one launch a verdict
    present, and each slice bit-equal to the unbatched claim on it."""
    from thunder_tpu_torch.executors import batching, flashex

    T = 256
    masks = _slice_masks(T, 64, dev)
    q, k, v, g = (torch.stack([_randn((1, 4, T, 100), torch.bfloat16, dev, 10 * i + j) for j in range(3)])
                  for i in range(4))
    wrappers = (flashex.sdpa_exact, flashex.flash_attention_fwd_seg, flashex.flash_attention_bwd_recompute)
    before = _launched(*wrappers)
    out = torch.func.vmap(lambda a, b, c, m: batching.masked_fwd(a, b, c, m, False, 0.1, None, 1))(q, k, v, masks)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launched(*wrappers), before)] == [1, 2, 0]
    before = _launched(*wrappers)
    grads = torch.func.vmap(lambda gg, a, b, c, m: batching.masked_bwd(gg, a, b, c, m, False, 0.1, (0, 1, 2), 1))(
        g, q, k, v, masks)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launched(*wrappers), before)] == [1, 0, 2]
    for j in range(3):
        assert torch.equal(out[j], flashex._sdpa_impl(q[j], k[j], v[j], attn_mask=masks[j].clone(), scale=0.1))
        want = flashex._sdpa_bwd_impl(g[j], q[j], k[j], v[j], masks[j].clone(), False, 0.1)
        for a, w in zip(grads, want):
            assert torch.equal(a[j], w)


def test_staged_masked_vmap_takes_the_branch_of_each_calls_verdicts(dev):
    """A staged vmap of masked attention whose masks change verdicts between
    calls: each set of verdicts is an entry with its own graph, held by one
    guard read a call, and every call equals the unbatched jit on each slice."""
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ttorch
    from thunder_tpu_torch.core.concrete import check_value_guards

    T = 256
    masks = _slice_masks(T, 64, dev)
    q = torch.stack([_randn((1, 4, T, 64), torch.bfloat16, dev, j) for j in range(2)])
    f = lambda a, m: ttorch.scaled_dot_product_attention(a, a, a, attn_mask=m)  # noqa: E731
    vf, one = tt.vmap(f), tt.jit(f, disable_jit_staging=True)
    for pair in ((1, 2), (1, 2), (1, 2), (0, 2), (1, 2), (0, 2), (0, 2)):
        m = masks[list(pair)]
        reads = check_value_guards.host_reads
        got = vf(q, m)
        assert check_value_guards.host_reads - reads >= 1
        for j in range(2):
            assert torch.equal(got[j], one(q[j], m[j]))
    assert tt.compile_stats(vf).compile_count == 2
    assert tt.last_staging(vf).staged


def test_norm_rules_with_a_weight_a_slice(dev):
    """RMSNorm and LayerNorm with a weight (and bias) a slice: one launch of
    each kernel, y and dx bit-equal to each slice's own call, dw a row a
    slice; a per-segment weight equal in every row to a shared one gives the
    shared call's bits."""
    from thunder_tpu_torch.executors import batching, normex

    for layer_norm, D in ((False, 3200), (True, 1024)):
        x = torch.stack([_randn((2, 256, D), torch.bfloat16, dev, j) for j in range(_V)])
        g = torch.stack([_randn((2, 256, D), torch.bfloat16, dev, 20 + j) for j in range(_V)])
        w = torch.stack([_randn((D,), torch.bfloat16, dev, 40 + j) for j in range(_V)])
        b = torch.stack([_randn((D,), torch.bfloat16, dev, 50 + j) for j in range(_V)]) if layer_norm else None
        fwd, bwd = (normex.layer_norm_fwd, normex.layer_norm_bwd) if layer_norm else (normex.rms_norm_fwd,
                                                                                     normex.rms_norm_bwd)
        before = _launched(fwd, bwd)
        y = torch.func.vmap(lambda a, ww, bb: batching.norm_fwd(a, ww, bb, 1e-5, layer_norm, 1),
                            in_dims=(0, 0, 0 if layer_norm else None))(x, w, b)
        dx, dw, db = torch.func.vmap(lambda gg, a, ww: batching.norm_bwd(gg, a, ww, 1e-5, layer_norm, layer_norm, 1),
                                     out_dims=(0, 0, 0 if layer_norm else None))(g, x, w)
        torch.cuda.synchronize()
        assert [a - c for a, c in zip(_launched(fwd, bwd), before)] == [1, 1]
        for j in range(_V):
            bj = b[j] if layer_norm else None
            want_y = normex.layer_norm_fwd(x[j], w[j], bj, 1e-5) if layer_norm else normex.rms_norm_fwd(x[j], w[j],
                                                                                                       1e-5)
            assert torch.equal(y[j], want_y)
            wdx, wdw, wdb = normex.norm_bwd_plain(g[j], x[j], w[j], 1e-5, layer_norm=layer_norm, with_bias=layer_norm)
            own = (normex.layer_norm_bwd(g[j], x[j], w[j], 1e-5, with_bias=True) if layer_norm
                   else normex.rms_norm_bwd(g[j], x[j], w[j], 1e-5))
            assert torch.equal(dx[j], own[0])
            torch.testing.assert_close(dw[j], wdw, rtol=1e-4, atol=1e-4 * float(wdw.abs().max()))
        same = normex.rms_norm_fwd(x.reshape(-1, x.shape[-1]), w[0]) if not layer_norm else None
        if same is not None:
            assert torch.equal(normex.rms_norm_fwd(x.reshape(-1, x.shape[-1]), w[0].expand(_V, -1).contiguous()),
                               same)


def test_rope_rule_with_tables_a_slice(dev):
    """Per-sample position offsets: cos/sin a slice, one launch, each slice
    bit-equal to its own call."""
    from thunder_tpu_torch.executors import batching, fusedex

    x = torch.stack([_randn((1, 32, 256, 100), torch.bfloat16, dev, j) for j in range(_V)])
    cos = torch.stack([_randn((256, 100), torch.bfloat16, dev, 60 + j) for j in range(_V)])
    sin = torch.stack([_randn((256, 100), torch.bfloat16, dev, 70 + j) for j in range(_V)])
    before = fusedex.apply_rope.launches
    got = torch.func.vmap(batching.rope)(x, cos, sin)
    torch.cuda.synchronize()
    assert fusedex.apply_rope.launches == before + 1
    for j in range(_V):
        assert torch.equal(got[j], fusedex.apply_rope(x[j], cos[j], sin[j]))
        _assert_rows_close(got[j], fusedex.rope_plain(x[j], cos[j], sin[j]), 1)


@pytest.mark.parametrize("K", [3200, 100])
def test_int8_gemm_problems_are_bit_equal_to_each_problem(dev, K):
    """P problems in one launch, on either route, each operand shared or a
    problem's own: each problem's bits are the plain product's."""
    from thunder_tpu_torch.executors import quantex

    gen = torch.Generator().manual_seed(K)
    qa = torch.randint(-127, 128, (3, 200, K), generator=gen, dtype=torch.int8).to(dev)
    qw = torch.randint(-127, 128, (3, 300, K), generator=gen, dtype=torch.int8).to(dev)
    scale = (torch.rand(3, 300, generator=gen) * 1e-3 + 1e-5).to(dev)
    bias = _randn((3, 300), torch.float32, dev, 1)
    route = quantex.int8_gemm if K % 16 == 0 else quantex.int8_gemm_sync
    for a, w, s, bb in ((qa, qw[0], scale, None), (qa[0], qw, scale, bias), (qa, qw, scale[0], bias[1]),
                        (qa, qw, scale, bias)):
        before = route.launches
        got = quantex.int8_gemm(a, w, s, bb, torch.bfloat16)
        torch.cuda.synchronize()
        assert route.launches == before + 1 and got.shape == (3, 200, 300)
        for p in range(3):
            pick = lambda t, r: t if t is None or t.ndim == r else t[p]  # noqa: E731
            want = quantex.int8_gemm_plain(pick(a, 2), pick(w, 2), pick(s, 1), pick(bb, 1), torch.bfloat16)
            assert torch.equal(got[p], want)


def test_quant_linear_under_vmap_scales_each_slice_as_b1(dev):
    """The int8 linear under vmap, the activation, the weight or both
    batched: one launch of each quantization kernel and of the GEMM, and each
    slice's output bit-equal to the jit call on it (its own amax and scale)."""
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ttorch
    from thunder_tpu_torch.executors import quantex

    x = torch.stack([_randn((2, 128, 3200), torch.bfloat16, dev, j) * (j + 1) for j in range(_V)])
    w = torch.stack([_randn((1024, 3200), torch.bfloat16, dev, 30 + j) for j in range(_V)])
    lin = lambda a, b: ttorch.linear(a, b)  # noqa: E731
    one = tt.jit(lin, executors=["quant", "torch"], disable_jit_staging=True)
    wrappers = (quantex.quantize_tensor, quantex.quantize_rows, quantex.int8_gemm)
    for axes, a, b in (((0, None), x, w[0]), ((None, 0), x[0], w), ((0, 0), x, w)):
        vf = tt.vmap(lin, in_axes=axes, executors=["quant", "torch"], disable_jit_staging=True)
        before = _launched(*wrappers)
        got = vf(a, b)
        torch.cuda.synchronize()
        assert [c - d for c, d in zip(_launched(*wrappers), before)] == [1, 1, 1]
        for j in range(_V):
            assert torch.equal(got[j], one(a if axes[0] is None else a[j], b if axes[1] is None else b[j]))
    q, s = quantex.quantize_tensor(x.reshape(-1, 3200), 127.0, _V)
    for j in range(_V):
        qj, sj = quantex.quantize_per_tensor(x[j].reshape(-1, 3200), 127.0)
        assert torch.equal(s[j], sj) and torch.equal(q.reshape(_V, -1, 3200)[j], qj)


def test_capacity_and_spec_read_the_card(dev, monkeypatch):
    """``device_capacity_bytes`` reads the card's ``total_memory`` (the
    environment override first), ``resolve_device_spec`` its name; the
    predicted-OOM rule fires on a trace over the capacity with nothing
    allocated."""
    import thunder_tpu_torch.torch as ttorch
    from thunder_tpu_torch import analysis
    from thunder_tpu_torch.analysis.liveness import claimed_trace

    monkeypatch.delenv("THUNDER_TPU_HBM_BYTES", raising=False)
    assert analysis.device_capacity_bytes() == torch.cuda.get_device_properties(0).total_memory
    spec = analysis.resolve_device_spec()
    if "H100" in torch.cuda.get_device_name(0):
        assert spec.name == "h100"
    monkeypatch.setenv("THUNDER_TPU_HBM_BYTES", "1000")
    assert analysis.device_capacity_bytes() == 1000
    x = torch.ones(64, 64, device=dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    trc = claimed_trace(lambda a: ttorch.sum(ttorch.tanh(ttorch.matmul(a, a)) * 2.0), (x,), {})
    found = [d for d in analysis.verify(trc) if d.rule == "mem.predicted-oom"]
    assert len(found) == 1 and torch.cuda.memory_allocated() == before


# =============================================================================
# The observability layer on the card
# =============================================================================


def test_profiled_cuda_call_with_no_kernel_event_raises(dev, tmp_path):
    """No degraded mode: a profiled call that ran on CUDA and left no kernel
    event in the trace raises, and counts a failed capture."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.observability import metrics as obsm

    x = torch.ones(4, device=dev)
    before = obsm.PROFILE_CAPTURES.value(ok="false")
    with pytest.raises(RuntimeError, match="no kernel event"):
        tt.profile(lambda: x, steps=1, warmup=0, trace_dir=str(tmp_path / "p"))
    assert obsm.PROFILE_CAPTURES.value(ok="false") == before + 1
    res = tt.profile(lambda: x * 2, steps=2, warmup=0, trace_dir=str(tmp_path / "q"))
    assert res["profiler"] and res["attribution"] is None  # kernels, but no line's range


def test_instrumented_entry_runs_on_the_card(dev):
    """``debug_watch``/``instrument`` on CUDA inputs: the entry is not
    staged, runs eagerly on the card, and its hooks read the card (OpTimer's
    device times, MemoryHighWater's allocator peak)."""
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ttorch
    from thunder_tpu_torch.observability.instrument import MemoryHighWater, OpTimer, instrument_reports

    timer, hw = OpTimer(), MemoryHighWater()
    f = lambda a: ttorch.sum(ttorch.tanh(ttorch.matmul(a, a)))  # noqa: E731
    jf = tt.jit(f, debug_watch="nan", instrument=[timer, hw])
    x = torch.randn(512, 512, device=dev)
    torch.matmul(x, x)  # cuBLAS's one-time set-up on the host is not the op's time
    out = jf(x)
    assert out.is_cuda and not tt.last_staging(jf).staged and "debug_watch" in tt.last_staging(jf).reason
    assert torch.equal(out, tt.jit(f, disable_jit_staging=True)(x))
    rep = {r["hook"]: r for r in instrument_reports(jf)}
    ops = {o["symbol"]: o for o in rep["OpTimer"]["ops"]}
    assert ops["matmul"]["calls"] == 1 and 0 < ops["matmul"]["total_s"] < 0.1
    assert hw.exact and hw.peak_bytes >= 512 * 512 * 4 * 2 and hw.peak_op


def test_op_timer_sleep_is_capped_for_a_syncing_op(dev):
    """An op that synchronizes inside (here the card is synchronized between
    the hook's two calls) finishes after any sleep: each counts a host gap
    and the sleep stops at ``OpTimer.MAX_SLEEP_S``, so forty such ops take
    well under a second of sleep."""
    import time

    from thunder_tpu_torch.observability.instrument import OpRecord, OpTimer

    timer = OpTimer()
    rec = OpRecord(0, "item", None, "t0 = item(x)", None, "computation", device="cuda")
    t0 = time.perf_counter()
    for _ in range(40):
        timer.on_op_start(rec)
        torch.cuda.synchronize()
        timer.on_op_end(rec, ())
    assert timer.host_gaps == 40 and timer._sleep_s == OpTimer.MAX_SLEEP_S
    assert time.perf_counter() - t0 < 40 * OpTimer.MAX_SLEEP_S * 2


def test_sampled_staged_calls_draw_as_unsampled(dev, monkeypatch):
    """The roofline sampler on a staged entry with random draws: the first
    probe runs the caller's call eagerly (its stage swapped for the eager
    program) and takes the launch-order map from it, later probes profile
    the graph and place its kernels by the map. Six sampled calls give the
    outputs and leave the RNG counter of six unsampled calls; the graph is
    captured once."""
    import torch.nn.functional as F

    import thunder_tpu_torch as tt
    from thunder_tpu_torch import api
    from thunder_tpu_torch.observability.roofline import RooflineSampler

    monkeypatch.setenv("THUNDER_ANNOTATE_TRACES", "1")
    f = lambda x, w: F.dropout(torch.tanh(torch.matmul(x, w)), 0.5)  # noqa: E731
    plain, sampled = tt.jit(f), tt.jit(f)
    x, w = torch.randn(256, 256, device=dev), torch.randn(256, 256, device=dev)
    monkeypatch.setitem(api._global_rng, "seed", 5)
    want = [plain(x, w) for _ in range(6)]
    counter = api._global_rng["seed"]
    api._global_rng["seed"] = 5
    sampler = RooflineSampler(sampled, every=2, device="h100")
    got = [sampler.maybe_sample(sampled, x, w) for _ in range(6)]
    assert sampler.probes == 3 and api._global_rng["seed"] == counter
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tt.last_staging(sampled).staged and tt.last_staging(sampled).captures == 1
    attr = sampler.last_join.attribution
    assert sampler._launch_map and attr.graph_ops > 0 and attr.graph_placed == attr.graph_ops


def test_staged_attribution_places_every_graph_kernel(dev, tmp_path, monkeypatch):
    """A staged entry built under annotation, profiled over its replays:
    the launch-order map of its eager program places every kernel the graph
    launched on a line; what stays unattributed is the stage's own copies."""
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ttorch
    from thunder_tpu_torch.observability.attribution import scope_map_of

    monkeypatch.setenv("THUNDER_ANNOTATE_TRACES", "1")
    jf = tt.jit(lambda a, b: ttorch.sum(ttorch.gelu(ttorch.matmul(a, b)) * 2.0))
    a, b = torch.randn(256, 512, device=dev), torch.randn(512, 256, device=dev)
    for _ in range(2):  # warm-up, capture
        jf(a, b)
    assert tt.last_staging(jf).staged
    lmap = scope_map_of(jf, a, b)
    assert tt.last_staging(jf).captures == 1  # the map's eager call left the graph alone
    res = tt.profile(jf, a, b, steps=3, warmup=0, trace_dir=str(tmp_path / "p"), launch_map=lmap)
    attr = res["attribution"]
    assert attr.graph_ops >= 3 * 3 and attr.graph_placed == attr.graph_ops
    final = tt.last_traces(jf)[-1]
    assert all(final.bound_symbols[r.line].sym.name == r.sym for r in attr.by_line)
    assert {"matmul", "sum"} <= {r.sym for r in attr.by_line} and attr.coverage > 0.5


# -- distribution: a process group of one NCCL rank ----------------------------


@pytest.fixture(scope="module")
def nccl_rank(tmp_path_factory):
    """One NCCL rank on this card, on a FileStore, for this file's
    distribution tests; torn down after them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on one")
    import thunder_tpu_torch.distributed as td

    store = torch.distributed.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    info = td.init(store=store, num_processes=1, process_id=0)
    yield info
    td.shutdown()


def _one_rank_prims():
    from thunder_tpu_torch.distributed import prims as dist

    return {
        "all_reduce": lambda a: dist.all_reduce(a, "dp", 1),
        "all_reduce_avg": lambda a: dist.all_reduce(a, "dp", 1, op="avg"),
        "all_gather_dim1": lambda a: dist.all_gather(a, "dp", 1, dim=1),
        "reduce_scatter": lambda a: dist.reduce_scatter(a, "dp", 1),
        "broadcast": lambda a: dist.broadcast(a, "dp", 1),
        "synchronize_fsdp": lambda a: dist.synchronize(a, "dp", 1, "fsdp"),
        "async_wait": lambda a: dist.wait(dist.all_gather(a, "dp", 1, async_op=True)),
        "ppermute": lambda a: dist.ppermute(a, "dp", [(0, 0)]),
        "all_to_all": lambda a: dist.all_to_all(a, "dp", 1, split_dim=1, concat_dim=0),
        "mask_to_rank": lambda a: dist.mask_to_rank(a, "dp", 0),
        "hier_all_reduce": lambda a: dist.hier_all_reduce(a, "dp", "dp", 1, 1),
    }


# The collective each prim calls once at one rank. synchronize and
# hier_all_reduce are the identity there, ppermute's one pair (0, 0) is a
# copy, and mask_to_rank is local: they call none.
_ONE_RANK_CALLS = {"all_reduce": "all_reduce", "all_reduce_avg": "all_reduce", "all_gather_dim1": "all_gather",
                   "reduce_scatter": "reduce_scatter", "broadcast": "broadcast", "async_wait": "all_gather",
                   "all_to_all": "all_to_all"}


@pytest.mark.parametrize("prim", sorted(_one_rank_prims()))
def test_each_prim_staged_through_one_nccl_rank(nccl_rank, prim):
    """A collective of a one-rank group is its input; staged, the NCCL call
    it issues there (if any) is captured with the program and replayed."""
    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives

    x = _randn((64, 48), torch.bfloat16, torch.device("cuda"), 7)
    before = dist.collective_launches()
    jf, extrace = compile_with_collectives(_one_rank_prims()[prim], (x,), None, (P(),), P())
    outs = [jf(x) for _ in range(3)]
    torch.cuda.synchronize()
    assert jf.staging.staged and jf.staging.captures == 1 and jf.staging.replays >= 2
    assert all(torch.equal(o, x) for o in outs)
    assert extrace.tags["collective_order"]
    # Warm-up, capture and one replay: each runs the program's calls once.
    calls = {k: v - before[k] for k, v in dist.collective_launches().items() if v != before[k]}
    assert calls == ({_ONE_RANK_CALLS[prim]: 3} if prim in _ONE_RANK_CALLS else {})


def test_checkpoint_loads_every_leaf_onto_the_card(nccl_rank, tmp_path):
    """A state of sharded and replicated leaves saved on one NCCL rank loads
    back whole, every leaf on the card."""
    from thunder_tpu_torch.distributed import checkpoint as ck
    from thunder_tpu_torch.distributed.runtime import P

    dev = torch.device("cuda")
    state = {"w": _randn((64, 48), torch.bfloat16, dev, 1), "b": _randn((48,), torch.float32, dev, 2),
             "step": torch.tensor(3, device=dev)}
    specs = {"w": P("fsdp"), "b": P(), "step": P()}
    ck.save(state, str(tmp_path / "sharded"), specs=specs)
    ck.save(state, str(tmp_path / "full"), specs=specs, options=ck.StateDictOptions(full_state_dict=True))
    for name in ("sharded", "full"):
        got = ck.load(str(tmp_path / name), specs=specs)
        assert all(v.is_cuda for v in got.values()), {k: v.device for k, v in got.items()}
        assert all(torch.equal(got[k], state[k]) for k in state)


def _dist_module(mode):
    import torch.nn as nn
    import torch.nn.functional as F

    from thunder_tpu_torch.distributed import FSDPType, ddp, fsdp

    class Block(nn.Module):
        def __init__(self, dim=64, heads=2):
            super().__init__()
            self.heads = heads
            self.emb = nn.Embedding(128, dim)
            self.qkv = nn.Linear(dim, 3 * dim, bias=False)
            self.out = nn.Linear(dim, 128, bias=False)

        def forward(self, idx):
            x = self.emb(idx)
            B, T, C = x.shape
            q, k, v = self.qkv(x).view(B, T, 3, self.heads, C // self.heads).unbind(2)
            y = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True)
            return self.out(x + y.transpose(1, 2).reshape(B, T, C))

    torch.manual_seed(0)
    m = Block().to("cuda", torch.bfloat16)
    if mode == "ddp":
        return ddp(m)
    if mode in ("zero2", "zero3"):
        return fsdp(m, sharding_strategy=FSDPType.ZERO2 if mode == "zero2" else FSDPType.ZERO3)
    return m


@pytest.mark.parametrize("mode", ["ddp", "zero2", "zero3"])
def test_staged_dist_step_is_bit_equal_to_untagged(nccl_rank, mode):
    """Three staged SGD steps of a jitted module under ddp or fsdp on one
    NCCL rank: each loss and grad equal to the untagged module's, both
    staged, the collectives in the traces."""
    import torch.nn.functional as F

    import thunder_tpu_torch as tt

    idx = torch.from_numpy(np.random.RandomState(0).randint(0, 128, (2, 128))).cuda()
    runs = {}
    for tag in (None, mode):
        m = _dist_module(tag)
        tm = tt.jit(m)
        opt = torch.optim.SGD(m.parameters(), lr=0.1)
        record = []
        for _ in range(3):
            loss = F.cross_entropy(tm(idx).float().reshape(-1, 128), idx.reshape(-1))
            loss.backward()
            record.append((loss.detach().clone(), [p.grad.clone() for p in m.parameters()]))
            opt.step()
            opt.zero_grad(set_to_none=True)
        cs = tt.compile_stats(tm)
        assert cs.last_staging.staged and cs.last_backward_staging.staged
        runs[tag] = (record, tt.last_traces(tm)[-1].python(), tt.last_backward_traces(tm)[-1].python())
    (want, _, _), (got, fw, bw) = runs[None], runs[mode]
    for (lw, gw), (lg, gg) in zip(want, got):
        assert torch.equal(lw, lg) and all(torch.equal(a, b) for a, b in zip(gw, gg))
    assert "synchronize" in fw and ("all_reduce" if mode == "ddp" else "reduce_scatter") in bw


# -- the mesh and the sharded training step (parallel/), C.2, the timeline ------


def _step_counts():
    from thunder_tpu_torch.executors import flashex, fusedex

    return {"flash_fwd_lse": flashex.flash_attention_fwd_lse.launches, "flash_bwd": flashex.flash_attention_bwd.launches,
            "rope": fusedex.apply_rope.launches, "ce_fwd": fusedex.cross_entropy_rows.launches,
            "ce_bwd": fusedex.cross_entropy_bwd.launches}


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_meshed_step_at_one_nccl_rank_is_bit_equal(nccl_rank, optimizer):
    """open_llama_3b's width at 2 layers, T=256: 3 staged steps of
    ``build_train_step`` on ``make_mesh(dp=1, fsdp=1, tp=1)`` (the blocks by
    ``gpt_param_specs``/``shard_pytree``) and unmeshed, from the same
    weights: every loss and param after the last step ``torch.equal``, the
    same kernel launches a step, both staged, no collective in the
    program."""
    from dataclasses import replace

    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.distributed.prims import is_collective_bsym
    from thunder_tpu_torch.executors import flashex, fusedex
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.parallel import build_train_step, gpt_param_specs, make_mesh, shard_pytree

    cfg = replace(gpt.name_to_config("open_llama_3b"), n_layer=2)
    idx_np = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 256))
    ids, tgt = torch.from_numpy(idx_np).cuda(), torch.from_numpy(np.roll(idx_np, -1, axis=1)).cuda()
    mesh = make_mesh(dp=1, fsdp=1, tp=1)
    runs = []
    for meshed in (False, True):
        params = gpt.init_params(cfg, seed=0, device="cuda")
        kw = dict(donate=True, optimizer=optimizer, grads_in_f32=optimizer == "adamw", return_extrace=True)
        if meshed:
            specs = gpt_param_specs(cfg, mesh)
            params = shard_pytree(params, mesh, specs)
            step, opt, ex = build_train_step(cfg, params, ids, tgt, mesh=mesh, param_specs=specs, **kw)
        else:
            step, opt, ex = build_train_step(cfg, params, ids, tgt, **kw)
        losses, counts = [], []
        for _ in range(3):
            for fn in (flashex.flash_attention_fwd_lse, flashex.flash_attention_bwd, fusedex.apply_rope,
                       fusedex.cross_entropy_rows, fusedex.cross_entropy_bwd):
                fn.launches = 0
            params, opt, loss = step(params, opt, ids, tgt)
            losses.append(loss.clone())
            counts.append(_step_counts())
        assert step.staging.staged
        assert not [b for b in ex.bound_symbols if is_collective_bsym(b)]
        runs.append((losses, counts, [p.clone() for p in tree_flatten(params)[0]]))
    (l0, c0, p0), (l1, c1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert c0 == c1 and c1[-1] == {"flash_fwd_lse": 2, "flash_bwd": 2, "rope": 8, "ce_fwd": 1, "ce_bwd": 1}


def test_compile_stats_timers_on_a_staged_hit(dev):
    """C.2: a staged hit (the third call, a replay) sets the host, cache and
    host-execution timers; the compile set the tracing ones."""
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ltorch

    jf = tt.jit(lambda x: ltorch.sum(ltorch.tanh(x) * 2.0))
    x = torch.randn(64, 64, device=dev)
    for _ in range(3):
        jf(x)
    cs = tt.compile_stats(jf)
    assert cs.last_staging.staged and cs.cache_hits == 2
    assert cs.last_compile_time_ms > 0 and cs.last_cache_lookup_us >= 0
    assert 0 < cs.last_trace_host_start <= cs.last_trace_cache_start <= cs.last_trace_cache_stop
    assert cs.last_trace_cache_stop <= cs.last_trace_host_execution_start <= cs.last_trace_host_execution_stop
    assert cs.last_trace_host_execution_stop == cs.last_trace_host_stop


def test_recorder_folds_a_staged_step(dev):
    """The timeline recorder driven by a staged program: 5 steps' wall
    spans folded, each breakdown's classes summing to its wall, the
    ledger's steps and the always-export counter counting them."""
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ltorch
    from thunder_tpu_torch import monitor
    from thunder_tpu_torch.observability import metrics as obsm

    jf = tt.jit(lambda a, b: ltorch.sum(ltorch.matmul(a, b)))
    a, b = torch.randn(256, 256, device=dev), torch.randn(256, 256, device=dev)
    for _ in range(2):
        jf(a, b)
    before = obsm.CRITPATH_STEPS.value()
    rec = monitor.critpath(emit_events=False)
    try:
        for i in range(5):
            t = time.perf_counter()
            jf(a, b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            bd = rec.record_step(i, {0: {"total_s": wall, "compute_s": wall / 2}})
            assert sum(bd.classes.values()) == pytest.approx(bd.total_s, rel=1e-9)
        assert rec.ledger.steps == 5 and "critical path" in monitor.critpath_report()
    finally:
        monitor.shutdown_critpath()
    assert obsm.CRITPATH_STEPS.value() - before == 5
    assert tt.compile_stats(jf).last_staging.staged


# -- context, pipeline and expert parallelism (ROADMAP 11b) -------------------


def _pp_launches() -> dict:
    from thunder_tpu_torch.executors import flashex

    return {"flash_fwd": flashex.flash_attention_fwd.launches, **_step_counts()}


_PP_SITES = {"flash_scaled_dot_product_attention(": "flash_fwd", "flash_sdpa_fwd_res(": "flash_fwd_lse",
             "flash_sdpa_bwd_res(": "flash_bwd", "fused_apply_rope(": "rope", "fused_cross_entropy(": "ce_fwd",
             "fused_cross_entropy_bwd(": "ce_bwd"}


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipelined_step_on_the_card(nccl_rank, schedule):
    """open_llama_3b's width at 2 layers, T=256, B=4 in 4 microbatches on a
    pp=1 mesh with the default executors: 3 calls (eager, capture, replay)
    of ``gpt_pp_loss_and_grads``, staged, each with the launches of the
    claimed stage programs times their calls, the loss within 1e-4 and each
    grad within 2^-4 (norm-relative) of the unpipelined program's."""
    from dataclasses import replace

    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.executors import flashex, fusedex
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.parallel import build_train_step, gpt_pp, make_mesh

    cfg = replace(gpt.name_to_config("open_llama_3b"), n_layer=2)
    idx_np = np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 256))
    ids, tgt = torch.from_numpy(idx_np).cuda(), torch.from_numpy(np.roll(idx_np, -1, axis=1)).cuda()
    params = gpt.init_params(cfg, seed=0, device="cuda")
    ref, _ = build_train_step(cfg, params, ids, tgt, donate=False, optimizer="sgd")
    ref_loss, ref_grads = ref.loss_and_grads(*tree_flatten(params)[0], ids, tgt)
    mesh = make_mesh(pp=1)
    gpt_pp.gpt_pp_loss_and_grads.last_step = None
    try:
        for _ in range(3):
            for fn in (flashex.flash_attention_fwd, flashex.flash_attention_fwd_lse, flashex.flash_attention_bwd,
                       fusedex.apply_rope, fusedex.cross_entropy_rows, fusedex.cross_entropy_bwd):
                fn.launches = 0
            loss, grads = gpt_pp.gpt_pp_loss_and_grads(cfg, params, ids, tgt, mesh, n_micro=4, schedule=schedule,
                                                       executors=None)
            torch.cuda.synchronize()
            step = gpt_pp.gpt_pp_loss_and_grads.last_step
            calls = (1,) if step.schedule is None else (4,)  # the one stage is the last: no stage forward
            want = {}
            for tr, n in zip(step.traces, calls):
                for op, row in _PP_SITES.items():
                    want[row] = want.get(row, 0) + n * tr.python().count(op)
            assert _pp_launches() == want
            assert abs(float(loss) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
            for g, w in zip(tree_flatten(grads)[0], ref_grads):
                assert g.device.type == "cuda"
                assert ((g.float() - w.float()).norm() / w.float().norm()).item() <= 2.0 ** -4
        assert step.staging.staged and step.staging.captures == 1 and step.staging.replays >= 1
        assert want["flash_fwd"] == 0 and want["flash_bwd"] == 8
    finally:
        gpt_pp.gpt_pp_loss_and_grads.last_step = None


@pytest.mark.parametrize("which", ["ring", "ulysses"])
def test_sequence_parallel_attention_on_the_card(nccl_rank, which):
    """Ring and Ulysses attention at sp=1 on (1, 8, 512, 100) bf16 against
    the flash kernel and its backward, row by row (phase 3's limits: 2^-6
    and 2^-5), every output on the card. The grads are held against exact
    f32 grads too; dq against the flash backward's over the tensor
    (norm-relative), since the flash backward's rows whose exact dq nearly
    cancels hold its bf16 rounding (``chip_smoke.py`` phase 24 (c))."""
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ltorch
    from thunder_tpu_torch.distributed import runtime
    from thunder_tpu_torch.executors import flashex
    from thunder_tpu_torch.parallel import context, make_mesh

    fn = context.ring_attention if which == "ring" else context.ulysses_attention
    dev = torch.device("cuda")
    q, k, v, dout = (_randn((1, 8, 512, 100), torch.bfloat16, dev, s) for s in range(4))
    scale = 0.1
    with runtime.bound_axes(runtime.mesh_groups(make_mesh(sp=1))):
        got = tt.jit(lambda q, k, v: fn(q, k, v, "sp", scale=scale))(q, k, v)
        _, grads = tt.value_and_grad(lambda q, k, v, d: ltorch.sum(fn(q, k, v, "sp", scale=scale).float()
                                                                     * d.float()))(q, k, v, dout)
    out, lse = flashex.flash_attention_fwd_lse(q, k, v, causal=True, scale=scale)
    want_g = flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=True, scale=scale)

    def row_rel(a, b, floor=0.0):
        a, b = a.float(), b.float()
        ref = b.abs().amax(-1).clamp_min(max(floor * b.abs().max().item(), 1e-30))
        return ((a - b).abs().amax(-1) / ref).max().item()

    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) * scale
    s = s.masked_fill(~torch.ones(512, 512, dtype=torch.bool, device=dev).tril(), float("-inf"))
    (torch.softmax(s, -1) @ vf).mul(dout.float()).sum().backward()
    assert got.device.type == "cuda" and all(g.device.type == "cuda" for g in grads)
    assert row_rel(got, out) <= 2.0 ** -6
    assert max(row_rel(g, w.grad, 2.0 ** -14) for g, w in zip(grads[:3], (qf, kf, vf))) <= 2.0 ** -5
    assert max(row_rel(g, w, 2.0 ** -14) for g, w in zip(grads[1:3], want_g[1:])) <= 2.0 ** -5
    assert ((grads[0].float() - want_g[0].float()).norm() / want_g[0].float().norm()).item() <= 2.0 ** -5


def test_moe_mlp_on_the_card(nccl_rank):
    """``moe_mlp`` at ep=1 on the card (E=8, d=256, h=512, n=512, f32)
    against the dense oracle (rtol 1e-4, atol 1e-5) and its grads (1e-3,
    1e-4); at a capacity that drops, the kept count against the host's slot
    accounting; topk's indices on the card equal the CPU's, ties lower
    index first."""
    import math

    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ltorch
    from thunder_tpu_torch.distributed import runtime
    from thunder_tpu_torch.parallel import make_mesh, moe

    E, d, h, n = 8, 256, 512, 512
    dev = torch.device("cuda")
    x = _randn((n, d), torch.float32, dev, 0)
    rw, w1, w2 = (_randn(s, torch.float32, dev, i) / math.sqrt(s[-2]) for i, s in
                  ((1, (d, E)), (2, (E, d, h)), (3, (E, h, d))))
    args, cap = (x, rw, w1, w2), 100
    with runtime.bound_axes(runtime.mesh_groups(make_mesh(ep=1))):
        got = tt.jit(lambda *a: moe.moe_mlp(*a, "ep"))(*args)
        want = tt.jit(moe.moe_mlp_dense_reference)(*args)
        _, g_ep = tt.value_and_grad(lambda *a: ltorch.sum(moe.moe_mlp(*a, "ep") ** 2))(*args)
        _, g_dn = tt.value_and_grad(lambda *a: ltorch.sum(moe.moe_mlp_dense_reference(*a) ** 2))(*args)
        dispatch, _ = tt.jit(lambda x, rw: moe.dispatch_plan(x, rw, E, 2, cap))(x, rw)
        probs = tt.jit(lambda x, rw: ltorch.softmax(ltorch.matmul(x, rw), -1))(x, rw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    for a, b in zip(g_ep[1:], g_dn[1:]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)
    ids = tt.jit(lambda p: ltorch.topk(p, 2, -1)[1])(probs)
    assert torch.equal(ids.cpu(), tt.jit(lambda p: ltorch.topk(p, 2, -1)[1], device="cpu")(probs.cpu()))
    ties = torch.tensor([[0.25, 0.5, 0.25, 0.5, 0.0, 0.5, 0.0, 0.0]], device=dev)
    assert tt.jit(lambda p: ltorch.topk(p, 3, -1)[1])(ties).tolist() == [[1, 3, 5]]  # lax.top_k's order
    used, kept = [0] * E, 0
    for row in ids.tolist():
        for e in row:
            kept += used[e] < cap
            used[e] += 1
    assert int(dispatch.sum().item()) == kept < 2 * n


def test_mesh_naming_pp_ep_sp_at_one_nccl_rank_is_bit_equal(nccl_rank):
    """``make_mesh(pp=1, ep=1, sp=1)``: open_llama_3b's width at 2 layers,
    3 staged SGD steps bit-equal to the unmeshed step's, no collective."""
    from dataclasses import replace

    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.distributed.prims import is_collective_bsym
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.parallel import build_train_step, make_mesh

    cfg = replace(gpt.name_to_config("open_llama_3b"), n_layer=2)
    idx_np = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 256))
    ids, tgt = torch.from_numpy(idx_np).cuda(), torch.from_numpy(np.roll(idx_np, -1, axis=1)).cuda()
    runs = []
    for mesh in (None, make_mesh(pp=1, ep=1, sp=1)):
        params = gpt.init_params(cfg, seed=0, device="cuda")
        step, opt, ex = build_train_step(cfg, params, ids, tgt, mesh=mesh, optimizer="sgd", return_extrace=True)
        losses = []
        for _ in range(3):
            params, opt, loss = step(params, opt, ids, tgt)
            losses.append(loss.clone())
        assert step.staging.staged and not [b for b in ex.bound_symbols if is_collective_bsym(b)]
        runs.append((losses, [p.clone() for p in tree_flatten(params)[0]]))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


# =============================================================================
# The recovery layer on the card (thunder_tpu_torch/resilience)
# =============================================================================


def _tiny_llama(dev, n_layer=2):
    """open_llama_3b's head size and layout at a test width, on the card."""
    from dataclasses import replace

    from thunder_tpu_torch.models import gpt

    cfg = replace(gpt.name_to_config("open_llama_3b"), n_layer=n_layer, n_embd=400, n_head=4, n_query_groups=4,
                  intermediate_size=1088, vocab_size=512, padded_vocab_size=512)
    params = gpt.init_params(cfg, dtype=torch.bfloat16, seed=0, device=dev)
    gen = np.random.RandomState(0)
    batches = []
    for _ in range(4):
        a = gen.randint(0, cfg.vocab_size, (2, 256))
        batches.append((torch.from_numpy(a).to(dev), torch.from_numpy(np.roll(a, -1, axis=1)).to(dev)))
    return cfg, params, batches


def _vg(cfg, **options):
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.models import gpt

    return tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg), **options)


def _sgd_step(vg, batches):
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.parallel.train import sgd_update

    def step(state):
        k = int(state["k"])
        loss, grads = vg(state["params"], *batches[k])
        sgd_update(tree_flatten(state["params"])[0], list(grads), 1e-3, 0.0, in_place=True)
        return {"params": state["params"], "k": k + 1}, loss

    return step


def test_resume_is_bit_equal_on_the_card(dev, tmp_path, monkeypatch):
    """A 2-layer staged step preempted at step 2 and resumed by a fresh
    manager and a fresh jit: losses and final params ``torch.equal`` to the
    uninterrupted run's."""
    from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
    from thunder_tpu_torch.resilience import CheckpointManager, Preempted, chaos_scope, run_training

    monkeypatch.setenv("THUNDER_TPU_RETRY_BACKOFF_S", "0")
    cfg, params, batches = _tiny_llama(dev)
    init = [p.clone() for p in tree_flatten(params)[0]]
    spec = tree_flatten(params)[1]
    final, losses = run_training(_sgd_step(_vg(cfg), batches), {"params": params, "k": 0}, 4,
                                 manager=CheckpointManager(str(tmp_path / "a"), backoff_s=0))
    ref = [p.clone() for p in tree_flatten(final["params"])[0]]
    first = []
    mgr = CheckpointManager(str(tmp_path / "b"), backoff_s=0)
    with chaos_scope("preempt@2"):
        with pytest.raises(Preempted):
            run_training(_sgd_step(_vg(cfg), batches), {"params": tree_unflatten([p.clone() for p in init], spec),
                                                        "k": 0}, 4, manager=mgr,
                         on_loss=lambda k, x: first.append(x))
    template = {"params": tree_unflatten([torch.empty(0, device=dev) for _ in init], spec), "k": 0}
    resumed, tail = run_training(_sgd_step(_vg(cfg), batches), template, 4,
                                 manager=CheckpointManager(str(tmp_path / "b"), backoff_s=0))
    assert all(torch.equal(a, b) for a, b in zip(losses, first + tail))
    got = tree_flatten(resumed["params"])[0]
    assert all(x.device.type == "cuda" for x in got)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))


def test_oom_during_capture_recovers_and_frees(dev, monkeypatch):
    """An OOM planted at the capturing call (the second; chaos ``oom``, the
    dispatch seam running inside the capture) ends the capture, drops its
    pool, climbs to ladder level 1 and recompiles; after it
    ``memory_allocated`` equals a fresh compile's, and the result is right."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.resilience import chaos_scope

    monkeypatch.setenv("THUNDER_TPU_RETRY_BACKOFF_S", "0")
    cfg, params, batches = _tiny_llama(dev)
    ids, tgt = batches[0]
    ref = _vg(cfg)
    want = ref(params, ids, tgt)[0]
    ref(params, ids, tgt)  # its capture
    del ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    vg = _vg(cfg)
    vg(params, ids, tgt)  # warm-up, eager
    torch.cuda.synchronize()
    fresh = torch.cuda.memory_allocated()
    with chaos_scope("oom*1"):
        loss, grads = vg(params, ids, tgt)  # the capture fails, the ladder recompiles at L1
    assert tt.cache_info(vg)["degradation_level"] == 1
    assert len(tt.compile_stats(vg).cache_entries) == 1
    assert torch.equal(loss, want)
    del loss, grads
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == fresh
    loss, _ = vg(params, ids, tgt)  # the L1 entry captures and replays
    assert tt.last_staging(vg).staged and torch.equal(loss, want)


def test_demotion_and_restore_on_the_card(dev, caplog):
    """``kernel_raise`` on the flash wrapper: a WARNING, no flash launch by
    the demoted entry (eager, capture, replay), the loss of the default
    executors less flash bit for bit; after ``clear_quarantine`` a recompile
    launches flash again."""
    from thunder_tpu_torch.executors import flashex
    from thunder_tpu_torch.resilience import clear_quarantine

    cfg, params, batches = _tiny_llama(dev)
    ids, tgt = batches[0]
    torch_loss = _vg(cfg, executors=["fused", "torch"])(params, ids, tgt)[0]
    flashex.flash_attention_fwd_lse.launches = flashex.flash_attention_bwd.launches = 0
    try:
        with caplog.at_level("WARNING", logger="thunder_tpu_torch"):
            vg = _vg(cfg, chaos="kernel_raise@flash*1")
            losses = [vg(params, ids, tgt)[0] for _ in range(3)]
        assert any("flash" in r.getMessage() for r in caplog.records if r.levelname == "WARNING")
        assert flashex.flash_attention_fwd_lse.launches == flashex.flash_attention_bwd.launches == 0
        assert all(torch.equal(x, torch_loss) for x in losses)
    finally:
        clear_quarantine()
    _vg(cfg)(params, ids, tgt)
    assert flashex.flash_attention_fwd_lse.launches == flashex.flash_attention_bwd.launches == cfg.n_layer


def test_nan_guard_after_a_replay(dev):
    """The isfinite guard checks a replayed call's outputs too: the third
    call of a staged entry, given a NaN, raises."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.resilience import NonFiniteOutputError

    jf = tt.jit(lambda a, b: (a * b).sum(dim=1), on_nan="raise")
    a = torch.randn(64, 128, device=dev)
    b = torch.randn(64, 128, device=dev)
    # b is a new tensor each call, so the stage copies it into its own
    # buffer before each replay: the third call is a replay.
    jf(a, b.clone())
    jf(a, b.clone())  # the capture, and its first replay
    stats = tt.last_staging(jf)
    assert stats.staged and stats.captures == 1 and stats.replays == 1
    bad = b.clone()
    bad[3, 5] = float("nan")
    with pytest.raises(NonFiniteOutputError):
        jf(a, bad)
    assert stats.captures == 1 and stats.replays == 2


# =============================================================================
# The fleet layer on the card (resilience/autopilot.py, observability/opsplane.py)
# =============================================================================


def test_autopiloted_hang_recovery_at_one_nccl_rank(nccl_rank, dev, tmp_path, monkeypatch):
    """``run_autopiloted_training`` of a 2-layer staged SGD step on the
    one-rank NCCL mesh, a RAM snapshot a step, a 1 s watchdog and a
    collective hang planted at step 2: one same-mesh elastic_resume decision,
    the resume from the RAM tier, the losses ``torch.equal`` to the same run
    with no fault."""
    from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
    from thunder_tpu_torch.parallel import make_mesh
    from thunder_tpu_torch.parallel.train import sgd_update
    from thunder_tpu_torch.resilience import (
        Autopilot,
        CheckpointManager,
        SnapshotStore,
        chaos,
        chaos_scope,
        run_autopiloted_training,
    )

    monkeypatch.setenv("THUNDER_TPU_RETRY_BACKOFF_S", "0")
    cfg, params, batches = _tiny_llama(dev)
    vg = _vg(cfg)

    def step(state):
        k = int(state["k"])
        loss, grads = vg(state["params"], *batches[k])
        flat, spec = tree_flatten(state["params"])
        return {"params": tree_unflatten(sgd_update(flat, list(grads), 1e-3, 0.0, in_place=False), spec),
                "k": k + 1}, loss

    def drive(name, on_step=None):
        ap = Autopilot()
        with chaos_scope(""):
            _, report = run_autopiloted_training(
                ap, lambda m: step, {"params": params, "k": 0}, 4,
                manager=CheckpointManager(str(tmp_path / name), backoff_s=0, store=SnapshotStore()),
                mesh=make_mesh(dp=1), specs_for_mesh=lambda m: None, sdc_guard=False, watchdog_timeout_s=1.0,
                snapshot_every=1, on_step=on_step)
        return ap, report

    _, base = drive("base")

    def hang_at_2(k, loss):
        if k == 1:
            chaos.active().rules.append(chaos.FaultRule("collective_hang", delay_s=3.0))

    ap, hung = drive("hang", hang_at_2)
    assert [(d.signal.kind, d.actuator, d.mode) for d in hung.decisions] == [
        ("collective_hang", "elastic_resume", "same_mesh")]
    assert hung.recoveries == 1
    assert all(torch.equal(a, b) for a, b in zip(base.losses, hung.losses)) and len(hung.losses) == 4


def test_flight_dump_after_a_dispatch_fault_on_the_card(dev, tmp_path):
    """The NaN guard's raise out of a staged entry's replay is an unhandled
    dispatch fault: the flight recorder dumps, and the dump replays with no
    error and holds the guard's record."""
    import glob
    import json

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.analysis.events import replay_events
    from thunder_tpu_torch.observability import opsplane
    from thunder_tpu_torch.resilience import NonFiniteOutputError

    opsplane.enable(serve=False, flightrec_dir=str(tmp_path))
    try:
        jf = tt.jit(lambda a, b: (a * b).sum(dim=1), on_nan="raise")
        a = torch.randn(64, 128, device=dev)
        b = torch.randn(64, 128, device=dev)
        jf(a, b.clone())
        jf(a, b.clone())  # the capture
        bad = b.clone()
        bad[3, 5] = float("nan")
        with pytest.raises(NonFiniteOutputError):
            jf(a, bad)
    finally:
        opsplane.disable()
    dumps = glob.glob(str(tmp_path / "flightrec-*-dispatch_fault.jsonl"))
    assert len(dumps) == 1
    summary, diags = replay_events(dumps[0])
    assert not [d for d in diags if d.severity.name == "ERROR"]
    assert summary["flightrec_dumps"] == 1 and summary["kinds"].get("nan_guard", 0) >= 1
    assert json.loads(open(dumps[0]).read().splitlines()[-1])["reason"] == "dispatch_fault"


# -- the compiled-program audit (analysis/hlo_audit.py) -----------------------


def _audit_loss(dev, **jit_options):
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ttorch

    jf = tt.jit(lambda a, b: ttorch.sum(ttorch.tanh(ttorch.matmul(a, b))), **jit_options)
    a, b = torch.randn(256, 512, device=dev), torch.randn(512, 256, device=dev)
    return jf, a, b


def test_audit_phase_attaches_report(dev, tmp_path):
    """The ``hlo_audit`` compile phase after a staged entry's capture
    (tests/test_hlo_audit.py:256): the report on the entry, in the last
    trace's tags and in ``stats.phases``, one ``compile_phase`` event with
    its fields; every node on a line, so the priced operations are the
    trace's; the stage keeps no dump once audited."""
    import json

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.analysis.cost import trace_cost
    from thunder_tpu_torch.analysis.hlo_audit import HloScheduleReport

    log = str(tmp_path / "ev.jsonl")
    jf, a, b = _audit_loss(dev, events=log)
    for _ in range(3):  # warm-up, capture (and audit), replay
        jf(a, b)
    entry = tt.compile_stats(jf).cache_entries[0]
    rep = entry.hlo_audit
    assert isinstance(rep, HloScheduleReport) and rep.source == "graph" and tt.last_staging(jf).staged
    assert rep.n_ops > 0 and rep.matmuls >= 1 and rep.host_transfers == 0 and rep.unpriced == 0
    assert rep.flops == pytest.approx(trace_cost(entry.computation_traces[-1]).total_flops, rel=1e-9)
    assert entry.stats.phases.get("hlo_audit", 0) > 0
    assert entry.computation_traces[-1].tags.get("hlo_audit") is rep
    assert entry.computation_fn.graph_dump is None
    recs = [json.loads(line) for line in open(log)]
    spans = [r for r in recs if r.get("kind") == "compile_phase" and r.get("phase") == "hlo_audit"]
    assert len(spans) == 1 and spans[0]["hlo_ops"] == rep.n_ops
    assert spans[0]["hlo_acquire_s"] >= 0 and spans[0]["hlo_analyze_s"] >= 0


def test_kill_switch_disables_phase(dev, monkeypatch):
    """``THUNDER_TPU_HLO_AUDIT=0``: no report, no phase, no kept graph
    and no line marks; ``examine.hlo_report`` still audits on demand, from
    the record of one more call."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.examine import hlo_report

    monkeypatch.setenv("THUNDER_TPU_HLO_AUDIT", "0")
    jf, a, b = _audit_loss(dev)
    for _ in range(3):
        jf(a, b)
    entry = tt.compile_stats(jf).cache_entries[0]
    assert entry.hlo_audit is None and "hlo_audit" not in entry.stats.phases
    stage = entry.computation_fn
    assert stage.graph_dump is None and stage.line_marks == [] and tt.last_staging(jf).captures == 1
    rep = hlo_report(jf, a, b, verbose=False)
    assert rep.source == "record" and rep.matmuls >= 1 and tt.last_staging(jf).captures == 1


def test_corrupt_auditor_never_breaks_compile(dev, monkeypatch):
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.analysis import hlo_audit

    def boom(*args, **kwargs):
        raise ValueError("seeded parser corruption")

    monkeypatch.setattr(hlo_audit, "parse_graph_dump", boom)
    jf, a, b = _audit_loss(dev)
    want = torch.tanh(a @ b).sum()
    outs = [jf(a, b) for _ in range(3)]
    assert all(torch.allclose(o, want, rtol=1e-4) for o in outs)
    assert tt.last_staging(jf).staged and tt.last_staging(jf).replays == 2
    assert tt.compile_stats(jf).cache_entries[0].hlo_audit is None


def test_graph_and_record_readers_agree(dev):
    """A staged ``value_and_grad`` of a 2-layer GPT at open_llama_3b's head
    size: the graph's audit (reader (a), the compile phase's) and the audit
    of the profiler's record of one eager call (reader (b)) find the same
    kernels by name, and price the same operations; the graph's port kernels
    equal the launches the capture counted."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.analysis import hlo_audit
    from thunder_tpu_torch.models import gpt

    cfg = gpt.name_to_config(_TINY)
    params = gpt.init_params(cfg, seed=0, device=dev)
    vg = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg))
    batch = _tiny_batch(cfg, dev, 0)
    for _ in range(2):
        vg(params, *batch)
    entry = tt.compile_stats(vg).cache_entries[-1]
    graph = entry.hlo_audit
    record = hlo_audit.audit_record(vg, params, *batch)
    assert graph.source == "graph" and record.source == "record"
    assert graph.kernels == record.kernels and sum(graph.kernels.values()) > 20
    assert graph.flops == pytest.approx(record.flops, rel=1e-9) and graph.flops > 0
    launched = {name: n for (_, name), n in entry.computation_fn._delta.items()}
    assert graph.port_kernels["flash_fwd_kernel"] == launched["flash_attention_fwd_lse"]
    assert graph.port_kernels["flash_bwd_dkdv_kernel"] == launched["flash_attention_bwd"]
    assert graph.port_kernels["rope_kernel"] == launched["apply_rope"]
    assert graph.port_kernels["ce_fwd_kernel"] == launched["cross_entropy_rows"]
    assert graph.port_kernels["ce_bwd_kernel"] == launched["cross_entropy_bwd"]
    assert graph.host_transfers == 0 and graph.unpriced == 0


def test_example_trainer_step_launches_the_counted_kernels(dev):
    """``examples.train.run`` on the card, staged: its timed steps launch
    flash forward-with-lse and backward, CE forward and backward, and rope
    (the tiny config's rotary covers the whole head); the losses are finite
    and the step replays its graph."""
    from thunder_tpu_torch.examples import train

    args = train.parse_args(["--model", _TINY, "--iters", "3", "--warmup", "2", "--seq-len", "128"])
    assert args.device == "cuda"
    before = _counts()
    out = {}
    losses = train.run(args, out=out)
    counts = {k: v - before.get(k, 0) for k, v in _counts().items()}
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    for name in ("flash_attention_fwd_lse", "flash_attention_bwd", "cross_entropy_rows", "cross_entropy_bwd",
                 "apply_rope"):
        assert counts.get(name, 0) > 0, (name, counts)
    assert out["step"].staging.staged and out["step"].staging.replays >= 4
    assert all(p.is_cuda for p in out["params"].values() if isinstance(p, torch.Tensor))


def test_tools_default_to_the_card(dev):
    """Every runnable tool's ``--device`` defaults to ``cuda``; the lint
    corpus runs there clean."""
    from thunder_tpu_torch.examples import train, train_fsdp
    from thunder_tpu_torch.scripts import lint_traces, profile_train

    assert train.parse_args([]).device == train_fsdp.parse_args([]).device == "cuda"
    assert profile_train.parse_args([]).device == "cuda"
    # A call that asked for the CPU leaves the next call on the card.
    assert lint_traces.main(["reduction-mix", "--device", "cpu"]) == 0
    assert lint_traces.main(["gpt-tiny"]) == 0 and lint_traces._DEVICE == "cuda"
