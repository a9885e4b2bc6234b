"""The norm executor's plain versions against the JAX package's Pallas kernels, on the CPU.

``thunder_tpu_torch/executors/normex.py`` holds the RMSNorm and LayerNorm
kernels' wrappers; on CPU tensors they run their plain PyTorch versions.
Here each is held against ``thunder_tpu/executors/pallasex.py``'s
``_rms_impl``, ``_rms_bwd_impl``, ``_ln_impl`` and ``_ln_bwd_impl``, called
directly on ``jnp`` arrays (Pallas interpret mode on the CPU), with inputs
made with numpy from a seed.

Tolerances: both compute in f32 and round each output once, so they differ
by summation order only. f32 outputs: 1e-5 relative to the row's largest
|value|. bf16 outputs (y, dx, and dw/db, which both packages round to the
weight's type): one bf16 ulp of the row's (or the vector's) largest |value|,
a rounding that f32 noise tipped the other way. The port's f32 dw/db before
that rounding: 1e-5 of the vector's largest |value| against the JAX
package's f32 result.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.executors import pallasex

import thunder_tpu_torch as tt
import thunder_tpu_torch.torch as ttorch
from thunder_tpu_torch.executors import normex

_ULP = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
_JDT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _inputs(N, D, dtype, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(N, D) * 2 + 0.5).astype(np.float32)
    w = (rng.randn(D) * 0.1 + 1).astype(np.float32)
    b = (rng.randn(D) * 0.1).astype(np.float32)
    g = rng.randn(N, D).astype(np.float32)
    t = [torch.from_numpy(a).to(dtype) for a in (x, w, b, g)]
    # The same values on the JAX side: each rounded to bf16 by torch first.
    j = [jnp.asarray(a.float().numpy(), dtype=_JDT[dtype]) for a in t]
    return t, j


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, dtype=np.float32)


def _assert_rows_close(got, want, rel):
    got, want = _f32(got), _f32(want)
    if got.ndim == 1:
        got, want = got[None], want[None]
    err = np.abs(got - want).max(-1)
    limit = rel * np.abs(want).max(-1)
    assert (err <= limit).all(), f"worst row: {err.max()} > {limit[err.argmax()]}"


SHAPES = [(64, 256), (48, 384)]
DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("N,D", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_plain_matches_pallas(N, D, dtype):
    (x, w, _, g), (jx, jw, _, jg) = _inputs(N, D, dtype, 0)
    eps = 1e-6
    y = normex.rms_norm_fwd(x, w, eps)
    assert torch.equal(y, normex.norm_fwd_plain(x, w, None, eps, layer_norm=False))  # CPU: the plain version
    _assert_rows_close(y, pallasex._rms_impl(jx, (D,), jw, eps), _ULP[dtype])
    assert y.dtype == dtype

    dx, dw = normex.rms_norm_bwd(g, x, w, eps)
    jdx, jdw = pallasex._rms_bwd_impl(jg, jx, jw, eps)
    _assert_rows_close(dx, jdx, _ULP[dtype])
    assert dw.dtype == torch.float32
    _assert_rows_close(dw.to(dtype), jdw, _ULP[dtype])
    # The claimed implementation casts dw to the weight's type, as the JAX one does.
    cdx, cdw = normex._rms_bwd_impl(g, x, w, eps)
    assert torch.equal(cdx, dx) and cdw.dtype == dtype and torch.equal(cdw, dw.to(dtype))


def test_rms_eps_defaults_to_1e_6():
    (x, w, _, _), (jx, jw, _, _) = _inputs(8, 256, torch.float32, 1)
    y = normex._rms_impl(x, (256,), w)
    assert torch.equal(y, normex.rms_norm_fwd(x, w, 1e-6))
    _assert_rows_close(y, pallasex._rms_impl(jx, (256,), jw), 1e-5)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("N,D", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ln_plain_matches_pallas(N, D, dtype, bias):
    (x, w, b, g), (jx, jw, jb, jg) = _inputs(N, D, dtype, 2)
    b, jb = (b, jb) if bias else (None, None)
    eps = 1e-5
    y = normex.layer_norm_fwd(x, w, b, eps)
    assert torch.equal(y, normex.norm_fwd_plain(x, w, b, eps, layer_norm=True))
    _assert_rows_close(y, pallasex._ln_impl(jx, (D,), jw, jb, eps), _ULP[dtype])

    dx, dw, db = normex.layer_norm_bwd(g, x, w, eps, with_bias=bias)
    jdx, jdw, jdb = pallasex._ln_bwd_impl(jg, jx, jw, jb, eps)
    _assert_rows_close(dx, jdx, _ULP[dtype])
    _assert_rows_close(dw.to(dtype), jdw, _ULP[dtype])
    assert (db is None) == (jdb is None) == (not bias)
    if bias:
        _assert_rows_close(db.to(dtype), jdb, _ULP[dtype])
    cdx, cdw, cdb = normex._ln_bwd_impl(g, x, w, b, eps)
    assert torch.equal(cdx, dx) and cdw.dtype == dtype and (cdb is None) == (not bias)


@pytest.mark.parametrize("layer_norm", [True, False])
def test_f32_dw_db_match_pallas_before_the_cast(layer_norm):
    (x, w, b, g), (jx, jw, jb, jg) = _inputs(64, 256, torch.float32, 3)
    if layer_norm:
        _, dw, db = normex.layer_norm_bwd(g, x, w, 1e-5, with_bias=True)
        _, jdw, jdb = pallasex._ln_bwd_impl(jg, jx, jw, jb, 1e-5)
        _assert_rows_close(db, jdb, 1e-5)
    else:
        _, dw = normex.rms_norm_bwd(g, x, w, 1e-6)
        _, jdw = pallasex._rms_bwd_impl(jg, jx, jw, 1e-6)
    _assert_rows_close(dw, jdw, 1e-5)


def test_plain_versions_differ_from_the_decomposition_by_one_rounding():
    """The kernels apply the weight in f32 and round once; the ltorch
    decomposition rounds the normed value to bf16 first. Two roundings
    against one: within two ulps of the row max, and not equal."""
    (x, w, b, _), _ = _inputs(64, 256, torch.bfloat16, 4)
    f = lambda x, w, b: ttorch.layer_norm(x, (256,), w, b, eps=1e-5)  # noqa: E731
    dec = tt.jit(f, executors=["torch"], device="cpu")(x, w, b)
    plain = normex.norm_fwd_plain(x, w, b, 1e-5, layer_norm=True)
    _assert_rows_close(plain, dec, 2 * 2.0 ** -7)
    assert not torch.equal(plain, dec)


def _norm_program(D):
    def f(x, w, b):
        y = ttorch.rms_norm(x, (D,), w, eps=1e-6) + ttorch.layer_norm(x, (D,), w, b, eps=1e-5)
        return ttorch.sum(y.float() ** 2)

    return f


CLAIMS = ("norm_rms_norm(", "norm_rms_norm_bwd(", "norm_layer_norm(", "norm_layer_norm_bwd(")


def test_norm_executor_claims_all_four_ops_and_is_opt_in():
    (x, w, b, _), _ = _inputs(16, 256, torch.bfloat16, 5)
    vg = tt.value_and_grad(_norm_program(256), executors=["norm", "torch"], device="cpu")
    loss, grads = vg(x, w, b)
    src = tt.last_traces(vg)[-1].python()
    assert all(c in src for c in CLAIMS)
    dflt = tt.value_and_grad(_norm_program(256), device="cpu")
    want_loss, want_grads = dflt(x, w, b)
    assert not any(c in tt.last_traces(dflt)[-1].python() for c in CLAIMS)  # not a default executor
    # One bf16 rounding apart per norm (see above), summed over 16x256 squares.
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-2)
    for got, want in zip(grads, want_grads):
        assert got.shape == want.shape and got.dtype == want.dtype


def test_checkers_refuse_2d_normalized_shape_missing_weight_and_mixed_types():
    (x, w, b, _), _ = _inputs(4, 256, torch.bfloat16, 6)
    x3 = x.reshape(4, 16, 16)
    w2 = w.reshape(16, 16)

    def claims(f, *args):
        jf = tt.jit(f, executors=["norm", "torch"], device="cpu")
        jf(*args)
        return [c for c in CLAIMS if c in tt.last_traces(jf)[-1].python()]

    assert claims(lambda x, w: ttorch.rms_norm(x, (16, 16), w), x3, w2) == []
    assert claims(lambda x, w, b: ttorch.layer_norm(x, (16, 16), w, b.reshape(16, 16)), x3, w2, b) == []
    assert claims(lambda x: ttorch.rms_norm(x, (256,)), x) == []
    assert claims(lambda x: ttorch.layer_norm(x, (256,)), x) == []
    assert claims(lambda x, w: ttorch.rms_norm(x, (256,), w), x, w.float()) == []
    assert claims(lambda x, w: ttorch.layer_norm(x, (256,), w), x, w) == ["norm_layer_norm("]
    # D % 128 and rows % 8, the TPU's tiling, are not conditions here.
    assert claims(lambda x, w: ttorch.rms_norm(x, (100,), w), x[:3, :100], w[:100]) == ["norm_rms_norm("]


def test_wrappers_refuse_what_the_kernels_do_not_take_on_the_card():
    """On a tensor that is not on the CPU the wrapper launches or raises:
    the checks before the launch run without a card."""
    (x, w, _, _), _ = _inputs(4, 256, torch.bfloat16, 7)
    with pytest.raises(ValueError, match="one CUDA device"):
        normex._check_cuda("rms_fwd", x, None, w)


# A width above the old kernels' 14336 limit (Llama-3.1-405B's 16384): the JAX
# package's checkers take any D % 128 == 0, and so does the port's.
WIDE = 16384


@pytest.mark.parametrize("layer_norm", [False, True])
def test_wide_rows_plain_matches_pallas_and_are_claimed(layer_norm):
    (x, w, b, g), (jx, jw, jb, jg) = _inputs(8, WIDE, torch.float32, 8)
    if layer_norm:
        y = normex.layer_norm_fwd(x, w, b, 1e-5)
        _assert_rows_close(y, pallasex._ln_impl(jx, (WIDE,), jw, jb, 1e-5), 1e-5)
        dx, dw, db = normex.layer_norm_bwd(g, x, w, 1e-5, with_bias=True)
        jdx, jdw, jdb = pallasex._ln_bwd_impl(jg, jx, jw, jb, 1e-5)
        _assert_rows_close(db, jdb, 1e-5)
    else:
        y = normex.rms_norm_fwd(x, w, 1e-6)
        _assert_rows_close(y, pallasex._rms_impl(jx, (WIDE,), jw, 1e-6), 1e-5)
        dx, dw = normex.rms_norm_bwd(g, x, w, 1e-6)
        jdx, jdw = pallasex._rms_bwd_impl(jg, jx, jw, 1e-6)
    _assert_rows_close(dx, jdx, 1e-5)
    _assert_rows_close(dw, jdw, 1e-5)

    vg = tt.value_and_grad(_norm_program(WIDE), executors=["norm", "torch"], device="cpu")
    vg(x.bfloat16(), w.bfloat16(), b.bfloat16())
    src = tt.last_traces(vg)[-1].python()
    assert all(c in src for c in CLAIMS)


# (N, D, elem_size, layer_norm, sm_count, align) -> (mode, warps a row, groups,
# ring depth, ctas, sums in registers), from csrc/norm.cu's limits: 8 warps a
# block, lanes holding at most 32 columns, 3 ring slots, 232448 bytes.
_PLANS = [
    ((4096, 1024, 2, True, 132, 16), ("ring", 1, 8, 3, 132, True)),  # pythia-410m's LayerNorm
    ((4096, 3200, 2, False, 132, 16), ("ring", 4, 2, 3, 132, True)),  # open_llama_3b's RMSNorm
    ((4096, 3200, 2, False, 114, 16), ("ring", 4, 2, 3, 114, True)),  # the CTA count follows the SMs
    ((1, 1024, 2, True, 132, 16), ("ring", 1, 8, 3, 1, True)),  # fewer rows than CTAs
    ((5, 3200, 2, False, 132, 16), ("ring", 4, 2, 3, 3, True)),
    ((64, 4544, 2, True, 132, 16), ("ring", 8, 1, 3, 64, True)),  # falcon-7b
    ((8, 16384, 2, False, 132, 16), ("ring", 8, 1, 3, 8, False)),  # sums in device memory
    ((8192, 8192, 4, True, 132, 16), ("ring", 8, 1, 2, 132, True)),  # the fold buffers cut the ring
    ((3, 60000, 2, True, 132, 16), ("direct", 8, 1, 0, 3, False)),  # too wide for one slot
    ((64, 1024, 2, True, 132, 1), ("scalar", 1, 8, 0, 8, True)),  # an unaligned base pointer
    ((17, 1001, 2, True, 132, 1), ("scalar", 1, 8, 0, 3, True)),  # an odd D in bf16
    ((33, 1002, 2, True, 132, 4), ("direct", 1, 8, 0, 5, True)),  # rows 4-byte aligned only
    ((0, 1024, 2, False, 132, 16), ("ring", 1, 8, 3, 1, True)),  # no rows: one block writes zero sums
]


@pytest.mark.parametrize("args,want", _PLANS)
def test_bwd_launch_plan(args, want):
    plan = normex.bwd_plan(*args)
    assert (plan.mode, plan.warps_per_row, plan.groups, plan.depth, plan.ctas, plan.registers) == want
    N, D, size, layer_norm, _, _ = args
    assert plan.groups * plan.warps_per_row == 8
    assert plan.smem <= 232448
    if plan.mode == "ring":  # ring slots of (x row, g row) after the fold buffers
        fold = -(-plan.groups * D * 4 * (2 if layer_norm else 1) // 16) * 16 if plan.registers else 0
        assert plan.smem == fold + plan.groups * plan.depth * 2 * D * size


def test_align_takes_the_largest_common_divisor_of_offsets_and_pointers():
    buf = torch.zeros(4096 + 8, dtype=torch.bfloat16)
    base = buf.data_ptr() % 16 // 2  # elements to the next 16-byte boundary
    start = (8 - base) % 8
    x = buf[start:start + 4096].view(4, 1024)
    assert normex._align(1024, x) == 16
    assert normex._align(1002, buf[start:start + 4008].view(4, 1002)) == 4
    assert normex._align(1024, buf[start + 2:start + 2 + 4096].view(4, 1024)) == 4
    assert normex._align(1024, buf[start + 1:start + 1 + 4096].view(4, 1024)) == 1
    assert normex._align(1024, x, None) == 16


# (N, D, elem_size, sm_count, align, blocks_per_sm) -> (mode, unit, warps a
# row, groups, ctas): every _NORM_SHAPES width of the card tests, and the
# widths beyond 8 warps' registers. One warp a row at pythia-410m's 1024
# (four 16-byte units a lane), four at open_llama_3b's 3200; the grid is
# the blocks the SMs hold at once (the LayerNorm kernel's registers allow
# one 8-warp block an SM, the RMSNorm kernel's two).
_FWD_PLANS = [
    ((4096, 3200, 2, 132, 16, 2), ("rows", 8, 4, 2, 264)),  # open_llama_3b's RMSNorm
    ((4096, 1024, 2, 132, 16, 1), ("rows", 8, 1, 8, 132)),  # pythia-410m's LayerNorm
    ((4096, 1024, 2, 114, 16, 1), ("rows", 8, 1, 8, 114)),  # the grid follows the SMs
    ((33, 1000, 2, 132, 16, 1), ("rows", 8, 1, 8, 5)),
    ((17, 1001, 2, 132, 1, 1), ("rows", 1, 1, 8, 3)),  # an odd D in bf16: one element
    ((7, 384, 4, 132, 16, 1), ("rows", 4, 1, 8, 1)),
    ((5, 2600, 4, 132, 16, 1), ("rows", 4, 4, 2, 3)),
    ((16, 16384, 2, 132, 16, 1), ("block", 8, 8, 1, 16)),  # wider than 8 warps' registers
    ((64, 4544, 2, 132, 16, 1), ("rows", 8, 8, 1, 64)),  # falcon-7b
    ((64, 5120, 2, 132, 16, 2), ("rows", 8, 8, 1, 64)),
    ((1, 1024, 2, 132, 16, 1), ("rows", 8, 1, 8, 1)),
    ((5, 3200, 2, 132, 16, 2), ("rows", 8, 4, 2, 3)),
    ((4097, 1024, 2, 132, 16, 1), ("rows", 8, 1, 8, 132)),
    ((33, 1002, 2, 132, 4, 1), ("rows", 2, 1, 8, 5)),  # rows 4-byte aligned only
    ((64, 1024, 2, 132, 1, 1), ("rows", 1, 1, 8, 8)),  # an unaligned base pointer
    ((3, 60000, 2, 132, 16, 1), ("stream", 8, 8, 1, 3)),  # too wide for shared memory as f32
    ((8, 8192, 2, 132, 16, 1), ("rows", 8, 8, 1, 8)),  # the widest row in registers
    ((8, 8200, 2, 132, 16, 1), ("block", 8, 8, 1, 8)),
    ((4, 60000, 2, 132, 4, 1), ("stream", 1, 8, 1, 4)),
    ((0, 1024, 2, 132, 16, 1), ("rows", 8, 1, 8, 1)),  # no rows: the C side launches nothing
]


@pytest.mark.parametrize("args,want", _FWD_PLANS)
def test_fwd_launch_plan(args, want):
    plan = normex.fwd_plan(*args)
    assert (plan.mode, plan.unit, plan.warps_per_row, plan.groups, plan.ctas) == want
    N, D, size, sm_count, align, per_sm = args
    assert plan.groups * plan.warps_per_row == 8 and D % plan.unit == 0
    if plan.mode == "rows":  # a lane holds at most 32 columns; one wave of blocks
        assert math.ceil(D / plan.unit / (32 * plan.warps_per_row)) * plan.unit <= 32
        assert plan.ctas <= sm_count * per_sm and plan.unit * size in (16, 4, size)
    else:
        assert plan.unit in (1, 16 // size) and (plan.mode == "stream") == (D * 4 > 232448)


@pytest.mark.parametrize("size,align,unit", [(2, 16, 8), (2, 4, 2), (2, 1, 1), (4, 16, 4), (4, 4, 1), (4, 1, 1)])
def test_fwd_unit_is_the_widest_load_the_rows_allow(size, align, unit):
    assert normex.fwd_unit(size, align) == unit
