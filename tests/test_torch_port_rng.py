"""Keyed random draws in the port against ``jax.random`` and the JAX package.

The port computes threefry-2x32 as jax 0.9 does (``executors/rngex.py``), so
uniform draws are bit-equal to ``jax.random.uniform(fold_in(key, salt))`` in
f32, bf16 and f16. Normal draws go through erfinv, libm's here and XLA's
polynomial there: f32 within 1e-5 relative (the two differ most near the
tails, ~50 ulps at |x| = 3.8), f16 within one ulp (2^-10 relative), bf16
bit-equal. After ``seed(n)`` both packages draw from PRNGKey(n + k) on the
k-th call, so the same program gives the same bits call for call.

The JAX package's dropout repeats its mask: ``ltorch.dropout`` records its
``uniform`` inside the composite, its RNG pass looks at top-level symbols
only, and the unkeyed draw takes one key while ``jax.jit`` traces
(``thunder_tpu/transforms/rng.py:25``, ``executors/jaxex.py:104-118``). The
port keys a draw at any depth; these tests hold the port to the documented
contract (a fresh draw per call) and do not assert the reference's repeat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import thunder_tpu
import thunder_tpu.clang as jclang
from thunder_tpu.core import devices as jdevices
from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.core import prims as jprims

import thunder_tpu_torch as tt
import thunder_tpu_torch.clang as tclang
from thunder_tpu_torch.core import devices as tdevices
from thunder_tpu_torch.core import dtypes as tdtypes
from thunder_tpu_torch.core import prims as tprims
from thunder_tpu_torch.executors import rngex

_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
           "f16": (jnp.float16, torch.float16)}
_SHAPES = [(1,), (7,), (3, 5), (2, 3, 33), (4097,), (2, 1, 129)]


def _key(seed: int) -> torch.Tensor:
    return torch.tensor(rngex.prng_key_words(seed), dtype=torch.int64)


def _bits(x) -> np.ndarray:
    """The values' bit patterns, as signed integers of their width."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int32 if x.element_size() == 4 else torch.int16).numpy()
    a = np.asarray(x)
    return a.view(np.int32 if a.dtype.itemsize == 4 else np.int16)


@pytest.mark.parametrize("seed", [0, 1, 42, 123456789, 2 ** 31 - 1, -5])
def test_prng_key_words_match_jax(seed):
    # 64-bit seeds, as the JAX package's runtime sets (thunder_tpu/api.py:1458),
    # whatever another test in this process set.
    with jax.enable_x64(True):
        want = tuple(int(w) for w in np.asarray(jax.random.PRNGKey(seed)))
    assert want == rngex.prng_key_words(seed)


@pytest.mark.parametrize("seed,salt", [(0, 0), (3, 5), (99, 2 ** 31 + 7), (2 ** 31 - 1, 2 ** 32 - 1)])
def test_fold_in_matches_jax(seed, salt):
    want = [int(w) for w in np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), salt))]
    assert rngex.fold_in(_key(seed), salt).tolist() == want


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 3.7), (0.1, 0.3)])
def test_uniform_is_bit_equal_to_jax(dtype, shape, lo, hi):
    jd, td = _DTYPES[dtype]
    want = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(11), 3), shape, dtype=jd, minval=lo, maxval=hi)
    got = rngex.draw(_key(11), 3, shape, td, lo, hi)
    assert got.shape == shape and got.dtype == td
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype,rtol,atol", [("f32", 1e-5, 1e-6), ("bf16", 0.0, 0.0), ("f16", 2.0 ** -10, 2.0 ** -14)])
@pytest.mark.parametrize("shape", [(1,), (3, 5), (4097,)])
def test_normal_matches_jax(dtype, rtol, atol, shape):
    jd, td = _DTYPES[dtype]
    want = np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(5), 9), shape, dtype=jd))
    got = rngex.draw(_key(5), 9, shape, td, normal=True)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=rtol, atol=atol)


def test_unkeyed_draw_uses_the_key_itself():
    """``salt=None`` draws from the key unfolded, as the eager ``uniform``
    of the JAX package draws from its host counter's PRNGKey."""
    want = jax.random.uniform(jax.random.PRNGKey(7), (5, 6), dtype=jnp.float32)
    np.testing.assert_array_equal(_bits(rngex.draw(_key(7), None, (5, 6), torch.float32)), _bits(want))


def _noise_program(clang, devices):
    # tests/test_jit.py:122-139 of the JAX package.
    def foo(a):
        noise = clang.uniform((3, 3), 0.0, 1.0, device=devices.Device(), dtype=None)
        return clang.add(a, noise)

    return foo


def test_seeded_program_is_bit_equal_to_the_jax_package_call_for_call():
    jf = thunder_tpu.jit(_noise_program(jclang, jdevices))
    tf = tt.jit(_noise_program(tclang, tdevices), device="cpu")
    a = np.zeros((3, 3), dtype=np.float32)
    thunder_tpu.seed(42)
    tt.seed(42)
    outs = []
    for _ in range(3):
        want = np.asarray(jf(a))
        got = tf(torch.from_numpy(a))
        np.testing.assert_array_equal(got.numpy(), want)
        outs.append(got)
    assert not torch.equal(outs[0], outs[1])  # a fresh key per call
    assert ((outs[0] >= 0) & (outs[0] < 1)).all()
    assert "rng_key" in thunder_tpu.last_traces(jf)[-1].python()
    assert "rng_key" in tt.last_traces(tf)[-1].python()


def test_dropout_draws_a_fresh_keyed_mask_each_call():
    x = torch.from_numpy(np.random.RandomState(0).randn(64, 32).astype(np.float32))
    f = tt.jit(lambda x: F.dropout(x, 0.5), device="cpu")
    masks = [f(x) == 0 for _ in range(3)]
    assert not torch.equal(masks[0], masks[1]) and not torch.equal(masks[1], masks[2])
    src = tt.last_traces(f)[-1].python()
    assert "rng_key" in src and "uniform_keyed" in src and "uniform(" not in src.replace("uniform_keyed(", "")
    # The kept values are scaled by 1 / (1 - p); a seed repeats the draws.
    tt.seed(3)
    y = f(x)
    torch.testing.assert_close(y[y != 0], (x * 2)[y != 0], rtol=0, atol=0)
    tt.seed(3)
    assert torch.equal(f(x), y)


def test_two_dropouts_are_not_merged_by_cse():
    x = torch.ones(16, 16)
    f = tt.jit(lambda x: (F.dropout(x, 0.5), F.dropout(x, 0.5)), device="cpu")
    a, b = f(x)
    assert not torch.equal(a, b)
    assert tt.last_traces(f)[-1].python().count("uniform_keyed") == 2


def test_dropout_grad_is_the_forward_mask_scaled():
    p = 0.3
    x = torch.from_numpy(np.random.RandomState(1).randn(8, 16).astype(np.float32))
    g = torch.from_numpy(np.random.RandomState(2).randn(8, 16).astype(np.float32))
    vg = tt.value_and_grad(lambda x, g: (F.dropout(x, p) * g).sum(), device="cpu")
    tt.seed(9)
    value, (gx, _) = vg(x, g)
    # The forward's mask, from the same key: the first call after seed(9)
    # draws from PRNGKey(10), salt 0.
    keep = rngex.draw(_key(10), 0, (8, 16), torch.float32) < 1 - p
    torch.testing.assert_close(gx, torch.where(keep, g, torch.zeros_like(g)) / (1 - p), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(value, (torch.where(keep, x, torch.zeros_like(x)) / (1 - p) * g).sum(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_uniform_philox_is_bit_equal_to_the_jax_package(dtype):
    jd, td = {"f32": (jdtypes.float32, torch.float32), "bf16": (jdtypes.bfloat16, torch.bfloat16)}[dtype]
    tdt = {"f32": tdtypes.float32, "bf16": tdtypes.bfloat16}[dtype]

    def prog(prims, devices, dt):
        def f(a):
            return prims.uniform_philox((4, 9), -1.0, 2.0, seed=1234, offset=17, device=devices.Device(), dtype=dt)

        return f

    a = np.zeros((1,), np.float32)
    want = thunder_tpu.jit(prog(jprims, jdevices, jd))(a)
    got = tt.jit(prog(tprims, tdevices, tdt), device="cpu")(torch.from_numpy(a))
    assert got.dtype == td
    np.testing.assert_array_equal(_bits(got), _bits(jnp.asarray(want)))


def test_randn_keyed_in_a_program_matches_the_jax_package():
    def prog(clang, devices, dt):
        def f(a):
            return clang.add(a, clang.randn((6, 7), device=devices.Device(), dtype=dt))

        return f

    a = np.zeros((6, 7), np.float32)
    thunder_tpu.seed(100)
    tt.seed(100)
    want = np.asarray(thunder_tpu.jit(prog(jclang, jdevices, jdtypes.float32))(a))
    got = tt.jit(prog(tclang, tdevices, tdtypes.float32), device="cpu")(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_module_dropout_draws_afresh_and_its_backward_sees_the_forward_mask():
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Dropout(0.5))
    tm = tt.jit(m, device="cpu")
    x = torch.randn(16, 8)
    a = tm(x).detach()
    b = tm(x).detach()
    assert not torch.equal(a == 0, b == 0)
    assert "rng_key" in tt.last_traces(tm)[-1].python()
    out = tm(x)
    out.sum().backward()
    lin = m[0].weight.grad
    # d(sum(dropout(W x + b)))/dW = (mask / (1 - p))ᵀ x: rebuild it from the output.
    keep = (out.detach() != 0).float()
    torch.testing.assert_close(lin, (keep * 2.0).T @ x, rtol=1e-5, atol=1e-5)


def test_unkeyed_prims_take_their_own_host_counter():
    from thunder_tpu_torch.executors import torchex

    impl = torchex.ex.implmap[tprims.PrimIDs.UNIFORM].fn
    before = torchex._host_rng["seed"]
    a = impl((4,), 0.0, 1.0, device=tdevices.Device("cpu"), dtype=tdtypes.float32)
    want = jax.random.uniform(jax.random.PRNGKey(before + 1), (4,), dtype=jnp.float32)
    np.testing.assert_array_equal(_bits(a), _bits(want))
    assert torchex._host_rng["seed"] == before + 1
