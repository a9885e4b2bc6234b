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


def _assert_rows_close(got: torch.Tensor, want: torch.Tensor, n_ulps: float) -> None:
    """Each row (last dim) within ``n_ulps`` of the row's largest |value|, so
    a row of small values is held to its own scale, not to the tensor's."""
    eps = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10, torch.float32: 2.0 ** -23}[want.dtype]
    err = (got.float() - want.float()).abs().amax(-1)
    limit = n_ulps * eps * want.float().abs().amax(-1)
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
