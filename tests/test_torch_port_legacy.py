"""The port's legacy flash route (kernel row 10) against the JAX package's, on the CPU.

Under ``THUNDER_FLASH_IMPL=legacy`` the JAX package's flash executor runs
``_legacy_flash`` (the Pallas TPU ``flash_attention``) forward and, through
``jax.vjp``, backward; here it runs in Pallas interpret mode
(``force_tpu_interpret_mode``), and its claims are asked with
``THUNDER_FLASH_FORCE=1``, as the JAX package's own tests run them on the
CPU. The port's route (``flashex.legacy_flash_fwd`` / ``legacy_flash_bwd``)
runs its plain versions on CPU tensors. Inputs are made with numpy from a
seed and handed to both packages in bf16.

Tolerances are kernel rows 1 and 7's: each output row within 2^-6 (forward)
and 2^-5 (backward) of the row's largest |value|. Both routes round P to
bf16 before P·V (the TPU kernel against its running max, the plain version
against the row max) and round their outputs once. The backward also rounds
dS to bf16, at other points in the two: a gradient row that is a sum of
terms that cancel (dq of an early query under the causal mask, which sees a
few keys) moves by ulps of the terms, not of the sum, so each backward row
is also allowed one bf16 ulp (2^-7) of the tensor's largest |value|. The
2-layer model is held as ``test_torch_port_autodiff.py`` holds it: loss to
1e-2 relative, each grad to 2^-5 norm-relative.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import thunder_tpu
from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.core.pytree import tree_flatten as jtree_flatten
from thunder_tpu.executors import flashex as jflashex
from thunder_tpu.models import gpt as jgpt

import thunder_tpu_torch as tt
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.executors import flashex
from thunder_tpu_torch.models import gpt as tgpt

FWD_ROW_REL = 2.0 ** -6
BWD_ROW_REL = 2.0 ** -5
BWD_ULP = 2.0 ** -7


@pytest.fixture
def legacy(monkeypatch):
    monkeypatch.setenv("THUNDER_FLASH_IMPL", "legacy")
    monkeypatch.setenv("THUNDER_FLASH_FORCE", "1")


def _np(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _assert_rows_close(got, want, rel: float, ulps_of_max: float = 0.0) -> None:
    """Each row within ``rel`` of its largest |value|, plus ``ulps_of_max``
    of the tensor's largest |value|."""
    got, want = _f32(got), _f32(want)
    err = np.abs(got - want).max(-1)
    limit = rel * np.abs(want).max(-1) + ulps_of_max * np.abs(want).max()
    worst = np.unravel_index((err - limit).argmax(), err.shape)
    assert (err <= limit).all(), f"row {worst}: error {err[worst]} > {limit[worst]}"


# (B, H, G, S, D, causal)
CASES = [
    (1, 2, 2, 256, 64, True),
    (1, 2, 2, 256, 64, False),
    (1, 2, 2, 128, 100, True),  # open_llama_3b's head size
    (1, 4, 2, 128, 32, True),  # GQA: the JAX package expands k/v and sums dk/dv over each group
]


@pytest.mark.parametrize("B,H,G,S,D,causal", CASES)
def test_legacy_route_matches_jax_legacy_flash(legacy, B, H, G, S, D, causal):
    q, k, v, g = _np(B, H, S, D, seed=0), _np(B, G, S, D, seed=1), _np(B, G, S, D, seed=2), _np(B, H, S, D, seed=3)
    gqa = H != G
    jq, jk, jv, jg = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v, g))
    with pltpu.force_tpu_interpret_mode():
        want = jflashex._sdpa_impl(jq, jk, jv, None, 0.0, causal, None, gqa)
        want_grads = jflashex._sdpa_bwd_impl(jg, jq, jk, jv, None, causal, None, gqa)
    tq, tk, tv, tg = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, g))
    got = flashex._sdpa_impl(tq, tk, tv, None, 0.0, causal, None, gqa)
    got_grads = flashex._sdpa_bwd_impl(tg, tq, tk, tv, None, causal, None, gqa)
    scale = 1.0 / math.sqrt(D)
    # On CPU tensors the route's wrappers run the plain versions.
    assert torch.equal(got, flashex.flash_attention_plain(tq, tk, tv, causal=causal, scale=scale))
    plain = flashex.flash_attention_bwd_recompute_plain(tg, tq, tk, tv, causal=causal, scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(got_grads, plain))
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _assert_rows_close(got, want, FWD_ROW_REL)
    for name, a, b in zip(("dq", "dk", "dv"), got_grads, want_grads):
        assert a.shape == b.shape, name
        _assert_rows_close(a, b, BWD_ROW_REL, BWD_ULP)


def _proxies(S=256, L=256, dtype=torch.bfloat16, mask=False):
    q = torch.zeros((1, 2, S, 64), dtype=dtype)
    kv = torch.zeros((1, 2, L, 64), dtype=dtype)
    m = torch.ones((L,), dtype=torch.bool) if mask else None
    return q, kv, m


# (label, query length, key length, dtype, key-padding mask, dropout): each
# condition of the legacy checkers (flashex.py:171-193) once.
CLAIM_CASES = [
    ("claimed", 256, 256, torch.bfloat16, False, 0.0),
    ("mask", 256, 256, torch.bfloat16, True, 0.0),
    ("S != L", 128, 256, torch.bfloat16, False, 0.0),
    ("S % 128 != 0", 192, 192, torch.bfloat16, False, 0.0),
    ("f32", 256, 256, torch.float32, False, 0.0),
    ("dropout", 256, 256, torch.bfloat16, False, 0.1),
]


@pytest.mark.parametrize("label,S,L,dtype,mask,dropout", CLAIM_CASES, ids=[c[0] for c in CLAIM_CASES])
def test_legacy_claims_agree_with_jax(legacy, label, S, L, dtype, mask, dropout):
    q, kv, m = _proxies(S, L, dtype, mask)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    jq, jkv = jnp.zeros(q.shape, jdt), jnp.zeros(kv.shape, jdt)
    jm = None if m is None else jnp.ones(m.shape, jnp.bool_)
    fwd = flashex._sdpa_checker(q, kv, kv, m, dropout, False, None, False)
    jfwd = jflashex._sdpa_checker(jq, jkv, jkv, jm, dropout, False, None, False)
    bwd = flashex._bwd_checker(q, q, kv, kv, m, False, None, False)
    jbwd = jflashex._bwd_checker(jq, jq, jkv, jkv, jm, False, None, False)
    assert (fwd, bwd) == (bool(jfwd), bool(jbwd))
    assert fwd == (label == "claimed")
    # The legacy route has no residual pair, in either package.
    assert not flashex.residual_eligible(q, kv, kv) and not jflashex.residual_eligible(jq, jkv, jkv)


def test_legacy_route_in_the_claimed_trace(legacy):
    q, kv, _ = _proxies()

    def f(q, k, v):
        return tt.torch.scaled_dot_product_attention(q, k, v, is_causal=True)

    jf = tt.jit(f, device="cpu")
    got = jf(q, kv, kv)
    assert "flash_scaled_dot_product_attention" in tt.last_traces(jf)[-1].python()
    assert torch.equal(got, flashex.flash_attention_plain(q, kv, kv, causal=True, scale=1 / 8))


def test_two_layer_loss_and_grads_match_jax_under_legacy(legacy):
    tcfg = tgpt.name_to_config("llama-hs100-tiny")
    jcfg = jgpt.GPTConfig(**dataclasses.asdict(tcfg))
    jparams = jgpt.init_params(jcfg, dtype=jdtypes.bfloat16, seed=0)
    tparams = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.RandomState(0)
    idx = rng.randint(0, tcfg.vocab_size, (2, 128)).astype(np.int32)
    tgt = rng.randint(0, tcfg.vocab_size, (2, 128)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        jvg = thunder_tpu.value_and_grad(lambda p, i, t: jgpt.loss_fn(p, i, t, jcfg))
        jl, jg = jvg(jparams, idx, tgt)
    jsrc = thunder_tpu.last_traces(jvg)[-1].python()
    tf = tt.value_and_grad(lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg), device="cpu")
    tl, tg = tf(tparams, idx, tgt)
    src = tt.last_traces(tf)[-1].python()
    n = tcfg.n_layer
    # Both packages run the legacy route: the forward claim and the
    # recompute backward, no residual pair.
    for s in (src, jsrc):
        assert s.count("flash_scaled_dot_product_attention(") == n and s.count("flash_sdpa_bwd(") == n
        assert "sdpa_fwd_res" not in s and "sdpa_bwd_res" not in s
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-2)
    got, want = tree_flatten(list(tg))[0], jtree_flatten(jg)[0]
    assert len(got) == len(want) == 3 + 7 * n
    for a, b in zip(got, want):
        a, b = _f32(a), _f32(b)
        assert np.isfinite(a).all()
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 2.0 ** -5
