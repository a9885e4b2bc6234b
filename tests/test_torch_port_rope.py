"""The rope kernel's launch plan, and its plain version against the JAX package, on the CPU.

``fusedex.rope_plan`` is the pure function that picks how the CUDA kernel
(``csrc/rope.cu``) walks x (B, H, T, D): the tile of t and the heads a block
takes, the stages it walks them in, and the width of every
copy, load and store. Here each choice is held on the views the path gives
the kernel (q, k and v of a fused qkv projection, the contiguous input of
the backward), on views with only 8-, 4- or 2-byte aligned rows, and on
other head sizes; and the rules each choice must keep (alignment, shared
memory) on a grid of shapes. On CPU tensors ``apply_rope`` runs its plain
version, held here against ``pallasex._rope_impl`` (Pallas interpret mode)
on the views of a fused qkv with GQA and at head sizes 64, 72, 80 and 128.

Tolerances: both compute in f32 and round once, so f32 agrees to 1e-5
relative and bf16 to one ulp (2^-7) of the tensor's largest |value|.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.executors import pallasex

from thunder_tpu_torch.executors import fusedex

_T = 2048
_SMEM = 232448  # shared memory a block may ask for on sm_90


def _qkv_strides(B, T, H, G, D):
    """Element strides (b, h, t) of q, k or v viewed from a fused (B, T, (H + 2G) * D) projection."""
    W = (H + 2 * G) * D
    return (T * W, D, W)


# (B, H, T, D, elem_size, strides, align, sm_count[, table_align]) ->
# (rows, heads, stage, load, flat, vec, pair, direct, grid, smem).
_PLANS = [
    # open_llama_3b's q at B=2: 200-byte rows 16-byte aligned at even heads
    # only, so 8-byte copies; a 16-row tile (3200 bytes) and all 32 heads a
    # block, in two-buffered stages of 8; 16-byte stores; D/2 = 50, so
    # 2-element partner reads.
    ((2, 32, _T, 100, 2, _qkv_strides(2, _T, 32, 32, 100), 16, 132),
     (16, 32, 8, 8, False, 8, 2, False, (128, 1, 2), 57600)),
    ((10, 32, _T, 100, 2, _qkv_strides(10, _T, 32, 32, 100), 16, 132),  # the B=10 forward
     (16, 32, 8, 8, False, 8, 2, False, (128, 1, 10), 57600)),
    ((2, 32, _T, 100, 2, _qkv_strides(2, _T, 32, 32, 100), 8, 132),  # k: the base 8-byte aligned
     (16, 32, 8, 8, False, 8, 2, False, (128, 1, 2), 57600)),
    # The backward's dq is contiguous: a head's tile is one 3200-byte run,
    # copied in 16-byte units though a row is 200 bytes.
    ((2, 32, _T, 100, 2, (32 * _T * 100, _T * 100, 100), 16, 132),
     (16, 32, 8, 16, True, 8, 2, False, (128, 1, 2), 57600)),
    ((2, 8, _T, 100, 2, _qkv_strides(2, _T, 32, 8, 100), 16, 132),  # GQA k: 8 heads a block
     (16, 8, 8, 8, False, 8, 2, False, (128, 1, 2), 57600)),
    # Head size 64: 128-byte rows, 16-byte copies, 8-element partners; 32
    # rows a tile, and half the heads a block so the grid covers the SMs.
    ((2, 16, _T, 64, 2, _qkv_strides(2, _T, 16, 16, 64), 16, 132),
     (32, 8, 8, 16, False, 8, 8, False, (64, 2, 2), 73728)),
    ((2, 8, _T, 72, 2, _qkv_strides(2, _T, 8, 8, 72), 16, 132),  # D/2 = 36: 4-element partners
     (16, 8, 8, 16, False, 8, 4, False, (128, 1, 2), 41472)),
    ((2, 8, _T, 98, 2, _qkv_strides(2, _T, 8, 8, 98), 16, 132),  # D/2 odd: one element
     (16, 8, 8, 4, False, 8, 1, False, (128, 1, 2), 56448)),
    ((2, 32, _T, 100, 2, _qkv_strides(2, _T, 32, 32, 100), 4, 132),  # rows 4-byte aligned only
     (16, 32, 8, 4, False, 8, 2, False, (128, 1, 2), 57600)),
    ((2, 32, _T, 100, 2, _qkv_strides(2, _T, 32, 32, 100), 2, 132),  # 2-byte aligned: element copies
     (16, 32, 8, 2, False, 8, 2, False, (128, 1, 2), 57600)),
    # T = 77: a head's output run (77 * 200 bytes) breaks 16 bytes, so one
    # element a store; a small grid, so one head a block.
    ((1, 32, 77, 100, 2, _qkv_strides(1, 77, 32, 32, 100), 16, 132),
     (16, 1, 1, 8, False, 1, 1, False, (5, 32, 1), 12800)),
    ((2, 32, _T, 100, 4, _qkv_strides(2, _T, 32, 32, 100), 16, 132),  # f32: 8 rows a tile, 4-element stores
     (8, 32, 8, 16, False, 4, 2, False, (256, 1, 2), 57600)),
    ((2, 8, _T, 128, 4, (8 * _T * 128, _T * 128, 128), 16, 132),
     (8, 8, 8, 16, True, 4, 4, False, (256, 1, 2), 73728)),
    ((1, 32, 256, 100, 2, _qkv_strides(1, 256, 32, 32, 100), 16, 114),  # heads cut to fill 114 SMs
     (16, 4, 4, 8, False, 8, 2, False, (16, 8, 1), 32000)),
    ((2, 32, _T, 100, 2, _qkv_strides(2, _T, 32, 32, 100), 16, 132, 2),  # cos/sin only 2-byte aligned
     (16, 32, 8, 8, False, 1, 1, False, (128, 1, 2), 57600)),
    ((1, 2, 3, 60000, 4, (2 * 3 * 60000, 3 * 60000, 60000), 16, 132),  # a row too wide: direct
     (1, 1, 1, 4, False, 1, 1, True, (3, 2, 1), 0)),
    ((4, 32, 1, 100, 2, (32 * 100, 100, 100), 16, 132),  # T = 1: a tile of one row
     (1, 1, 1, 8, True, 1, 1, False, (1, 32, 4), 800)),
]


@pytest.mark.parametrize("args,want", _PLANS)
def test_rope_plan(args, want):
    p = fusedex.rope_plan(*args)
    assert (p.rows, p.heads, p.stage, p.load, p.flat, p.vec, p.pair, p.direct, p.grid, p.smem) == want


# Shapes for the plan's rules: head sizes, T off the tile, odd head counts,
# GQA and contiguous views, each base alignment, bf16 and f32.
_RULE_SHAPES = [
    c for c in itertools.product(
        [(1, 3, 77), (2, 32, 2048), (3, 7, 40), (2, 71, 24)],  # (B, H, T)
        [2, 6, 64, 98, 100, 128, 256],  # D
        [2, 4],  # element size
        ["qkv", "contiguous"],
        [16, 8, 4, 2],  # base alignment
    ) if c[4] >= c[2]  # an f32 tensor is at least 4-byte aligned
]


@pytest.mark.parametrize("BHT,D,es,view,align", _RULE_SHAPES)
def test_rope_plan_keeps_the_kernels_rules(BHT, D, es, view, align):
    """Every copy's unit divides the base pointer, the strides of every
    dimension with more than one index and every run; a 16-byte store or
    cos/sin read starts on 16 bytes in every tile and head; a partner read
    never straddles a half; the grid covers x and the shared memory fits."""
    B, H, T = BHT
    strides = _qkv_strides(B, T, H, H, D) if view == "qkv" else (H * T * D, T * D, D)
    p = fusedex.rope_plan(B, H, T, D, es, strides, align, 132)
    assert p.grid[0] * p.rows >= T > (p.grid[0] - 1) * p.rows
    assert p.grid[1] * p.heads >= H > (p.grid[1] - 1) * p.heads and p.grid[2] == B
    assert 1 <= p.stage <= p.heads and p.smem <= _SMEM
    assert p.rows & (p.rows - 1) == 0
    if p.direct:
        return
    assert p.smem == (2 + 2 * p.stage) * p.rows * D * es
    sb, sh, st = strides
    assert p.load >= es and align % p.load == 0
    assert all(s * es % p.load == 0 for s, n in ((sb, B), (sh, H)) if n > 1)
    if p.flat:
        assert st == D or T == 1
        assert all(n * D * es % p.load == 0 for n in (p.rows, T % p.rows))
    else:
        assert st * es % p.load == 0 and D * es % p.load == 0
    if p.vec > 1:
        assert p.vec * es == 16 and p.rows * D * es % 16 == 0 and T * D * es % 16 == 0
    assert p.vec % p.pair == 0 and (D // 2) % p.pair == 0


def _cos_sin(T, D):
    pos = np.arange(T, dtype=np.float32)[:, None]
    theta = 10000.0 ** (np.arange(D // 2, dtype=np.float32) * -2.0 / D)
    emb = np.concatenate([pos * theta, pos * theta], axis=1)
    return np.cos(emb), np.sin(emb)


# (B, T, H, G, D, which): x is head group `which` of a fused qkv projection.
_VIEWS = [
    (2, 16, 4, 2, 100, "q"),
    (2, 16, 4, 2, 100, "k"),
    (2, 16, 4, 2, 100, "v"),
    (1, 24, 2, 2, 64, "k"),
    (2, 8, 3, 1, 72, "q"),
    (1, 16, 2, 2, 80, "v"),
    (2, 8, 2, 1, 128, "k"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,G,D,which", _VIEWS)
def test_rope_on_views_of_a_fused_qkv_matches_pallas(B, T, H, G, D, which, dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    qkv = torch.from_numpy(np.random.RandomState(B * T + D).randn(B, T, (H + 2 * G) * D).astype(np.float32)).to(tdt)
    lo, n = {"q": (0, H), "k": (H * D, G), "v": ((H + G) * D, G)}[which]
    x = qkv[..., lo:lo + n * D].reshape(B, T, n, D).permute(0, 2, 1, 3)
    cos, sin = (torch.from_numpy(a).to(tdt) for a in _cos_sin(T, D))
    got = fusedex.apply_rope(x, cos, sin)
    assert torch.equal(got, fusedex.rope_plain(x, cos, sin))  # CPU: the plain version
    want = np.asarray(pallasex._rope_impl(*(jnp.asarray(t.float().numpy(), dtype=jdt) for t in (x, cos, sin))),
                      dtype=np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2.0 ** -7 * np.abs(want).max())
