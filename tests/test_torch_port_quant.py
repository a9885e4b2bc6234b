"""The int8 linear (``executors/quantex.py``) against the JAX package's
``thunder_tpu/executors/quantex.py`` on the CPU, where the kernel's wrapper
runs its plain version.

The quantization is the same arithmetic in both (amax, one division, round
half to even, clip, cast), so ``q`` and the scales are bit-equal; the int32
product is exact in both (``lax.dot_general`` in int32, the plain version in
f64); the output is one f32 multiply (and add) away, rounded to its dtype,
so within one ulp of it. Then the cases of ``tests/test_quantex.py``
through the port: opt-in claims, not claimed by default, small K left alone,
the straight-through grad, the margin, the skip recipe, and a small model's
convergence tracking the unquantized run (the reference test's bands).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

import thunder_tpu
import thunder_tpu.torch as jtorch
from thunder_tpu.executors import quantex as jq

import thunder_tpu_torch as tt
import thunder_tpu_torch.torch as ttorch
from thunder_tpu_torch.executors import quantex as tq


def _t(*shape, seed=0, scale=1.0):
    rng = np.random.RandomState(seed + sum(shape))
    return (rng.randn(*shape) * scale).astype(np.float32)


def _as(x: np.ndarray, dtype: str):
    """The values of x rounded to ``dtype``, as f32 numpy (exact) and as a
    torch tensor of that dtype."""
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t.float().numpy(), t


_SHAPES = [((8, 128), (64, 128)), ((3, 5, 100), (48, 100)), ((16, 3200), (96, 3200))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("a_shape,w_shape", _SHAPES)
def test_q_scales_and_int32_product_are_the_jax_packages(dtype, a_shape, w_shape):
    a32, a = _as(_t(*a_shape), dtype)
    w32, w = _as(_t(*w_shape, seed=1, scale=0.05), dtype)
    qa, sa = tq.quantize_per_tensor(a.float(), 127.0)
    qw, sw = tq.quantize_per_channel(w.float(), 127.0)
    jqa, jsa = jq._quantize_per_tensor(jnp.asarray(a32), 127.0)
    jqw, jsw = jq._quantize_per_channel(jnp.asarray(w32), 127.0)
    np.testing.assert_array_equal(qa.numpy(), np.asarray(jqa))
    np.testing.assert_array_equal(qw.numpy(), np.asarray(jqw))
    assert sa.numpy().tobytes() == np.asarray(jsa).tobytes()
    assert sw.numpy().tobytes() == np.asarray(jsw).tobytes()
    K = a_shape[-1]
    acc = lax.dot_general(jqa.reshape(-1, K), jqw, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32)
    ours = (qa.reshape(-1, K).double() @ qw.double().T)
    np.testing.assert_array_equal(ours.numpy().astype(np.int64), np.asarray(acc).astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("a_shape,w_shape", _SHAPES)
def test_quant_linear_within_one_ulp_of_the_jax_packages(dtype, with_bias, a_shape, w_shape):
    a32, a = _as(_t(*a_shape), dtype)
    w32, w = _as(_t(*w_shape, seed=1, scale=0.05), dtype)
    b32, b = _as(_t(w_shape[0], seed=2, scale=0.1), dtype) if with_bias else (None, None)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jq._quant_linear_impl(jnp.asarray(a32, jdt), jnp.asarray(w32, jdt),
                                            None if b32 is None else jnp.asarray(b32, jdt))).astype(np.float32)
    got = tq.quant_linear(a, w, b)
    assert got.dtype == a.dtype and tuple(got.shape) == want.shape
    ulp = np.spacing(np.abs(want).astype(np.float32)) * (2 ** 16 if dtype == "bfloat16" else 1)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()


def test_int8_gemm_plain_is_exact_at_the_largest_sums():
    """Every partial sum in f64 is an integer below 2**53: the product of
    K = 8640 terms of ±127·±127 is the int32 sum exactly."""
    K = 8640
    qa = torch.full((3, K), 127, dtype=torch.int8)
    qw = torch.full((2, K), -127, dtype=torch.int8)
    out = tq.int8_gemm_plain(qa, qw, torch.ones(2), None, torch.float32)
    assert (out == float(-127 * 127 * K)).all()


def test_the_wrapper_runs_the_plain_version_on_cpu_tensors():
    qa = torch.randint(-127, 128, (5, 96), dtype=torch.int8)
    qw = torch.randint(-127, 128, (7, 96), dtype=torch.int8)
    n = tq.int8_gemm.launches
    out = tq.int8_gemm(qa, qw, torch.full((7,), 0.5), torch.ones(7), torch.bfloat16)
    assert tq.int8_gemm.launches == n  # nothing launched on the CPU
    assert torch.equal(out, tq.int8_gemm_plain(qa, qw, torch.full((7,), 0.5), torch.ones(7), torch.bfloat16))


# =============================================================================
# tests/test_quantex.py through the port
# =============================================================================


def _jit(f, executors):
    return tt.jit(f, device="cpu", executors=executors)


class TestQuantLinear:
    def test_opt_in_claims_and_close(self):
        x, w, b = _t(8, 128), _t(64, 128, seed=1) * 0.1, _t(64, seed=2) * 0.1
        f = lambda x, w, b: ttorch.linear(x, w, b)  # noqa: E731
        qf, pf = _jit(f, ["quant", "torch"]), _jit(f, ["torch"])
        got, want = qf(x, w, b).numpy(), pf(x, w, b).numpy()
        assert "quant_linear" in tt.last_traces(qf)[-1].python()
        assert np.abs(got - want).max() / (np.abs(want).max() + 1e-9) < 0.02  # int8 per channel: ~1%
        jgot = np.asarray(thunder_tpu.jit(lambda x, w, b: jtorch.linear(x, w, b), executors=["quant", "jax"])(x, w, b))
        np.testing.assert_allclose(got, jgot, rtol=1e-6, atol=1e-6)  # the same quantization as the JAX package

    def test_not_claimed_by_default(self):
        jf = tt.jit(lambda x, w: ttorch.linear(x, w), device="cpu")
        jf(_t(8, 128), _t(64, 128, seed=1))
        assert "quant_linear" not in tt.last_traces(jf)[-1].python()

    def test_small_k_falls_back(self):
        qf = _jit(lambda x, w: ttorch.linear(x, w), ["quant", "torch"])
        qf(_t(8, 16), _t(4, 16, seed=1))  # K = 16 < 64
        assert "quant_linear" not in tt.last_traces(qf)[-1].python()

    def test_integer_and_f64_linears_are_not_claimed(self):
        qf = _jit(lambda x, w: ttorch.linear(x, w), ["quant", "torch"])
        qf(_t(8, 128).astype(np.float64), _t(64, 128, seed=1).astype(np.float64))
        assert "quant_linear" not in tt.last_traces(qf)[-1].python()

    def test_grad_straight_through(self):
        """The backward runs unquantized: grads close to the f32 path."""
        x, w = _t(8, 128), _t(64, 128, seed=1) * 0.1
        loss = lambda x, w: ttorch.sum(ttorch.linear(x, w) ** 2.0)  # noqa: E731
        qvg = tt.value_and_grad(loss, device="cpu", executors=["quant", "torch"])
        pvg = tt.value_and_grad(loss, device="cpu", executors=["torch"])
        (lq, gq), (lp, gp) = qvg(x, w), pvg(x, w)
        src = tt.last_traces(qvg)[-1].python()
        assert src.count("quant_linear(") == 1 and "matmul" in src  # the forward's product only
        np.testing.assert_allclose(float(lq), float(lp), rtol=5e-2)
        for a, b in zip(gq, gp):
            assert (a - b).abs().max() <= 5e-2 * b.abs().max() + 1e-4


class TestQuantRecipe:
    def test_margin_backs_off_scale(self):
        x, w = _t(8, 128), _t(64, 128, seed=1) * 0.1
        f = lambda x, w: ttorch.linear(x, w)  # noqa: E731
        try:
            tq.set_recipe(tq.QuantRecipe(margin=2, per_channel_weights=False))
            jq.set_recipe(jq.QuantRecipe(margin=2, per_channel_weights=False))
            got = _jit(f, ["quant", "torch"])(x, w).numpy()
            jgot = np.asarray(thunder_tpu.jit(lambda x, w: jtorch.linear(x, w), executors=["quant", "jax"])(x, w))
        finally:
            tq.set_recipe(tq.QuantRecipe())
            jq.set_recipe(jq.QuantRecipe())
        want = _jit(f, ["torch"])(x, w).numpy()
        assert np.abs(got - want).max() / (np.abs(want).max() + 1e-9) < 0.08  # two bits of resolution fewer
        np.testing.assert_allclose(got, jgot, rtol=1e-6, atol=1e-6)

    def test_skip_out_features_excludes_layer(self):
        x, wb, wh = _t(8, 128), _t(64, 128, seed=1) * 0.1, _t(96, 64, seed=2) * 0.1
        old = tq.get_recipe()
        try:
            tq.set_recipe(tq.QuantRecipe(skip_out_features=(96,)))
            qf = _jit(lambda x, wb, wh: ttorch.linear(ttorch.linear(x, wb), wh), ["quant", "torch"])
            qf(x, wb, wh)
            assert tt.last_traces(qf)[-1].python().count("quant_linear(") == 1  # the body, not the head
        finally:
            tq.set_recipe(old)

    def test_default_recipe_skips_nothing(self):
        assert tq.get_recipe().skip_out_features == () and jq.get_recipe().skip_out_features == ()


class TestQuantTraining:
    def test_convergence_tracks_unquantized(self):
        """A small MLP trained 30 SGD steps with every linear in int8: it
        converges and tracks the unquantized run (the reference test's
        bands), and its losses stay within 1e-3 of the JAX package's
        quantized run on the same module (the same quantization; f32 sums in
        another order may flip a rounding of q late in training)."""

        def make():
            torch.manual_seed(3)
            return torch.nn.Sequential(torch.nn.Linear(128, 128), torch.nn.GELU(), torch.nn.Linear(128, 8))

        rng = np.random.RandomState(0)
        X = torch.from_numpy(rng.randn(64, 128).astype(np.float32))
        Y = torch.from_numpy(rng.randint(0, 8, (64,)))

        def train(jit, steps=30):
            m = make()
            tm = jit(m)
            opt = torch.optim.SGD(m.parameters(), lr=0.1)
            losses = []
            for _ in range(steps):
                opt.zero_grad()
                loss = F.cross_entropy(tm(X), Y)
                loss.backward()
                opt.step()
                losses.append(float(loss.detach()))
            return losses

        lq = train(lambda m: tt.jit(m, device="cpu", executors=["quant", "torch"]))
        lp = train(lambda m: tt.jit(m, device="cpu", executors=["torch"]))
        lj = train(lambda m: thunder_tpu.jit(m, executors=["quant", "jax"]))
        assert lq[-1] < 0.5 * lq[0], lq
        assert abs(lq[-1] - lp[-1]) < 0.25, (lq[-1], lp[-1])
        assert max(abs(a - b) for a, b in zip(lq, lj)) < 1e-3, (lq, lj)


def test_jax_int32_dot_matches_on_a_vocabulary_sized_product():
    """One lm_head-shaped product (K = 3200, N = 2000) end to end: the
    port's quantized linear against the JAX package's, bf16 out."""
    a32, a = _as(_t(4, 3200), "bfloat16")
    w32, w = _as(_t(2000, 3200, seed=1, scale=0.02), "bfloat16")
    want = np.asarray(jq._quant_linear_impl(jnp.asarray(a32, jnp.bfloat16), jnp.asarray(w32, jnp.bfloat16)))
    got = tq.quant_linear(a, w).float().numpy()
    assert (np.abs(got - want.astype(np.float32)) <= np.spacing(np.abs(want.astype(np.float32))) * 2 ** 16).all()
    assert jax.default_backend() == "cpu"


# =============================================================================
# The quantization wrappers (csrc/quantize.cu on the card): their CPU route,
# bit for bit against the JAX package's _quantize_per_tensor /
# _quantize_per_channel, which quantize the operand's values in f32
# =============================================================================


def _qmax(margin: int) -> float:
    return tq.QuantRecipe(margin=margin).qmax


_Q_DTYPES = ["float32", "bfloat16", "float16"]


@pytest.mark.parametrize("dtype", _Q_DTYPES)
@pytest.mark.parametrize("margin", [0, 2])
@pytest.mark.parametrize("shape", [(7, 100), (3, 5, 64), (96, 3200)])
def test_quantize_tensor_cpu_route_is_the_jax_packages(dtype, margin, shape):
    x32, x = _as(_t(*shape, seed=11), dtype)
    n = tq.quantize_tensor.launches
    q, s = tq.quantize_tensor(x, _qmax(margin))
    assert tq.quantize_tensor.launches == n  # nothing launched on the CPU
    jqx, jsx = jq._quantize_per_tensor(jnp.asarray(x32), jq.QuantRecipe(margin=margin).qmax)
    assert q.dtype == torch.int8 and tuple(q.shape) == shape and s.dtype == torch.float32 and s.ndim == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqx))
    assert s.numpy().tobytes() == np.asarray(jsx).tobytes()


@pytest.mark.parametrize("dtype", _Q_DTYPES)
@pytest.mark.parametrize("margin", [0, 2])
@pytest.mark.parametrize("shape", [(5, 64), (33, 257), (48, 3200)])
def test_quantize_rows_cpu_route_is_the_jax_packages(dtype, margin, shape):
    w32, w = _as(_t(*shape, seed=12, scale=0.05), dtype)
    n = tq.quantize_rows.launches
    q, s = tq.quantize_rows(w, _qmax(margin))
    assert tq.quantize_rows.launches == n
    jqw, jsw = jq._quantize_per_channel(jnp.asarray(w32), jq.QuantRecipe(margin=margin).qmax)
    assert tuple(q.shape) == shape and tuple(s.shape) == (shape[0], 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqw))
    assert s.numpy().tobytes() == np.asarray(jsw).tobytes()


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("dtype", _Q_DTYPES)
def test_weight_quantization_both_ways_is_the_jax_packages(per_channel, dtype):
    """The weight as ``quant_linear`` quantizes it under either recipe: a
    scale a row, or one scale broadcast to every row."""
    w32, w = _as(_t(40, 128, seed=13, scale=0.05), dtype)
    if per_channel:
        q, s = tq.quantize_rows(w, 127.0)
    else:
        q, s = tq.quantize_tensor(w, 127.0)
        s = s.expand(w.shape[0], 1)
    jqw, jsw = jq._quantize_per_channel(jnp.asarray(w32), 127.0, per_channel)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqw))
    assert s.contiguous().numpy().tobytes() == np.ascontiguousarray(np.asarray(jsw)).tobytes()


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("margin", [0, 2])
def test_quant_linear_under_each_recipe_matches_the_jax_packages(per_channel, margin):
    a32, a = _as(_t(6, 128, seed=14), "bfloat16")
    w32, w = _as(_t(24, 128, seed=15, scale=0.05), "bfloat16")
    try:
        tq.set_recipe(tq.QuantRecipe(margin=margin, per_channel_weights=per_channel))
        jq.set_recipe(jq.QuantRecipe(margin=margin, per_channel_weights=per_channel))
        got = tq.quant_linear(a, w).float().numpy()
        want = np.asarray(jq._quant_linear_impl(jnp.asarray(a32, jnp.bfloat16), jnp.asarray(w32, jnp.bfloat16)))
    finally:
        tq.set_recipe(tq.QuantRecipe())
        jq.set_recipe(jq.QuantRecipe())
    want = want.astype(np.float32)
    assert (np.abs(got - want) <= np.spacing(np.abs(want)) * 2 ** 16).all()


@pytest.mark.parametrize("dtype", _Q_DTYPES)
def test_an_all_zero_row_takes_the_1e6_floor(dtype):
    w32, w = _as(_t(4, 64, seed=16), dtype)
    w32[2] = 0.0
    w[2] = 0
    q, s = tq.quantize_rows(w, 127.0)
    jqw, jsw = jq._quantize_per_channel(jnp.asarray(w32), 127.0)
    assert s.numpy().tobytes() == np.asarray(jsw).tobytes()
    assert s[2, 0].item() == np.float32(np.float32(1e-6) / np.float32(127.0))
    assert (q[2] == 0).all()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqw))
    qz, sz = tq.quantize_tensor(torch.zeros(3, 64, dtype=w.dtype), 127.0)
    jqz, jsz = jq._quantize_per_tensor(jnp.zeros((3, 64), jnp.float32), 127.0)
    assert sz.numpy().tobytes() == np.asarray(jsz).tobytes() and (qz == 0).all()


@pytest.mark.parametrize("dtype", _Q_DTYPES)
def test_ties_round_half_to_even(dtype):
    """amax 127 gives the scale 1.0 exactly, so each x / s is x: the halves
    round to the even neighbour (0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -2.5 -> -2)."""
    vals = [127.0, 0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, -3.5, 4.5, 100.5, -126.5]
    x32 = np.array([vals] * 2, dtype=np.float32)
    x = torch.from_numpy(x32).to(getattr(torch, dtype))
    assert torch.equal(x.float(), torch.from_numpy(x32))  # every value exact in the type
    want = np.array([127, 0, 2, 2, 4, 0, -2, -2, -4, 4, 100, -126], dtype=np.int8)
    for q, s, (jqx, jsx) in (
        (*tq.quantize_tensor(x, 127.0), jq._quantize_per_tensor(jnp.asarray(x32), 127.0)),
        (*tq.quantize_rows(x, 127.0), jq._quantize_per_channel(jnp.asarray(x32), 127.0)),
    ):
        assert (s.numpy() == 1.0).all()
        np.testing.assert_array_equal(q.numpy()[0], want)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqx))


def test_quant_linear_runs_the_cpu_routes_without_launching():
    a, w = torch.randn(3, 4, 96), torch.randn(16, 96) * 0.05
    before = (tq.quantize_tensor.launches, tq.quantize_rows.launches, tq.int8_gemm.launches,
              tq.int8_gemm_sync.launches)
    out = tq.quant_linear(a, w)
    assert tuple(out.shape) == (3, 4, 16)
    assert (tq.quantize_tensor.launches, tq.quantize_rows.launches, tq.int8_gemm.launches,
            tq.int8_gemm_sync.launches) == before


@pytest.mark.parametrize("K,offset,ok", [(3200, 0, True), (8640, 0, True), (100, 0, False), (64, 1, False)])
def test_the_gemm_route_is_chosen_by_shape_and_alignment(K, offset, ok):
    """TMA describes contiguous operands with 16-byte-aligned bases and rows
    (K % 16 == 0); anything else goes to the mma.sync route."""
    buf = torch.zeros(8 * K + 16, dtype=torch.int8)
    base = (-buf.data_ptr()) % 16 + offset
    qa = buf[base:base + 8 * K].view(8, K)
    assert tq.tma_describes(qa, torch.zeros(4, K, dtype=torch.int8)) is ok
