"""The port's GPT against the JAX package's, on the CPU, with shared weights.

The config has open_llama_3b's head size (100) at a test size: n_embd 200,
2 heads, 2 layers, V = 256, T = 128. The JAX package's params (numpy init
from a seed) are loaded into the port with ``params_from_jax``; both packages
run ``forward`` and ``loss_fn`` with their default executors (the JAX
package's splash attention in Pallas interpret mode).

Tolerances: float32 agrees to rtol 1e-4 (the two packages differ only in
summation order). bf16 is looser: the packages round to bf16 at different
places (the JAX package rounds q*scale to bf16 before its attention kernel
and its rope multiplies in bf16; the port's kernels keep scores and rope in
f32 and round once), and two layers compound those roundings.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import thunder_tpu
from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.models import gpt as jgpt

import thunder_tpu_torch as tt
from thunder_tpu_torch.models import gpt as tgpt

CFG = "llama-hs100-tiny"
B, T = 2, 128


@pytest.fixture
def _jax_flash_on_cpu(monkeypatch):
    monkeypatch.setenv("THUNDER_FLASH_FORCE", "1")


def _configs():
    tcfg = tgpt.name_to_config(CFG)
    jcfg = jgpt.GPTConfig(**dataclasses.asdict(tcfg))
    return jcfg, tcfg


def _inputs(dtype):
    jcfg, tcfg = _configs()
    jparams = jgpt.init_params(jcfg, dtype=dtype, seed=0)
    tparams = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.RandomState(0)
    idx = rng.randint(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    tgt = rng.randint(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, idx, tgt


def _run_both(dtype):
    jcfg, tcfg, jparams, tparams, idx, tgt = _inputs(dtype)
    jf = thunder_tpu.jit(lambda p, i: jgpt.forward(p, i, jcfg))
    jl = thunder_tpu.jit(lambda p, i, t: jgpt.loss_fn(p, i, t, jcfg))
    tf = tt.jit(lambda p, i: tgpt.forward(p, i, tcfg), device="cpu")
    tl = tt.jit(lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg), device="cpu")
    want = (np.asarray(jf(jparams, idx), np.float32), float(jl(jparams, idx, tgt)))
    got = (tf(tparams, idx).float().numpy(), float(tl(tparams, idx, tgt)))
    return got, want, tt.last_traces(tl)[-1].python()


def test_params_from_jax_keeps_structure_and_values():
    jcfg, tcfg, jparams, tparams, _, _ = _inputs(jdtypes.bfloat16)
    jleaves, jdef = jax.tree_util.tree_flatten(jparams)
    assert len(tparams["blocks"]) == tcfg.n_layer
    assert set(tparams["blocks"][0]["attn"]) == set(jparams["blocks"][0]["attn"])
    w = tparams["blocks"][1]["mlp"]["fc_1_w"]
    assert w.dtype == torch.bfloat16 and w.device.type == "cpu"
    np.testing.assert_array_equal(w.float().numpy(), np.asarray(jparams["blocks"][1]["mlp"]["fc_1_w"], np.float32))


def test_f32_forward_and_loss_match_jax():
    (logits, loss), (jlogits, jloss), _ = _run_both(jdtypes.float32)
    assert logits.shape == (B, T, 256)
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)


def test_bf16_forward_and_loss_match_jax(_jax_flash_on_cpu):
    (logits, loss), (jlogits, jloss), src = _run_both(jdtypes.bfloat16)
    assert src.count("flash_scaled_dot_product_attention(") == 2
    assert src.count("fused_apply_rope(") == 4
    assert np.isfinite(logits).all()
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=5e-2 * np.abs(jlogits).max())
    np.testing.assert_allclose(loss, jloss, rtol=1e-2)


def test_random_init_loss_is_near_log_vocab():
    tcfg = tgpt.name_to_config(CFG)
    params = tgpt.init_params(tcfg, device="cpu", seed=1)
    rng = np.random.RandomState(1)
    idx = torch.from_numpy(rng.randint(0, tcfg.vocab_size, (B, T)))
    loss = tt.jit(lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg), device="cpu")(params, idx, idx)
    # logits ~ N(0, s^2) with s = 0.02 * sqrt(n_embd): loss ~ ln V + s^2 / 2.
    s2 = 0.02 ** 2 * tcfg.n_embd
    assert abs(float(loss) - (np.log(tcfg.vocab_size) + s2 / 2)) < 0.1


def test_init_params_is_seeded_and_shaped():
    tcfg = tgpt.name_to_config(CFG)
    a = tgpt.init_params(tcfg, device="cpu", seed=3, dtype=torch.float32)
    b = tgpt.init_params(tcfg, device="cpu", seed=3, dtype=torch.float32)
    assert torch.equal(a["wte"], b["wte"]) and a["wte"].shape == (256, 200)
    assert a["blocks"][0]["attn"]["qkv_w"].shape == (tcfg.qkv_out, tcfg.n_embd)
    assert torch.equal(a["ln_f"]["weight"], torch.ones(200))
    assert abs(a["wte"].std().item() - 0.02) < 2e-3


# =============================================================================
# The pythia (GPT-NeoX) family: LayerNorm with bias, biased linears, exact
# GELU, the parallel residual and partial rotary (16 of 64 features)
# =============================================================================

PYTHIA_SMALL = dict(name="pythia-410m-test", n_layer=2, n_embd=256, n_head=4, vocab_size=512,
                    padded_vocab_size=512, intermediate_size=1024, block_size=128)


def _pythia_inputs(dtype):
    """pythia-410m cut to 2 layers of width 256 (head size 64, so 16
    rotated features), on both sides; the JAX package's params with every
    bias and norm weight drawn away from its init (zeros and ones), so that
    each of those terms shows in the comparison."""
    jcfg = dataclasses.replace(jgpt.name_to_config("pythia-410m"), **PYTHIA_SMALL)
    tcfg = dataclasses.replace(tgpt.name_to_config("pythia-410m"), **PYTHIA_SMALL)
    assert tcfg.parallel_residual and tcfg.bias and tcfg.norm_class == "LayerNorm" and tcfg.rope_n_elem == 16
    rng = np.random.RandomState(2)

    def draw(path, x):
        key = jax.tree_util.keystr(path)
        a = np.asarray(x, np.float32)
        if key.endswith("['bias']") or key.endswith("_b']"):
            a = 0.02 * rng.randn(*a.shape)
        elif key.endswith("['weight']"):
            a = 1 + 0.1 * rng.randn(*a.shape)
        return jax.numpy.asarray(a, dtype=x.dtype)

    jparams = jax.tree_util.tree_map_with_path(draw, jgpt.init_params(jcfg, dtype=dtype, seed=0))
    tparams = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.RandomState(0)
    idx = rng.randint(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    tgt = rng.randint(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, idx, tgt


def _pythia_run_both(dtype):
    jcfg, tcfg, jparams, tparams, idx, tgt = _pythia_inputs(dtype)
    jf = thunder_tpu.jit(lambda p, i: jgpt.forward(p, i, jcfg))
    jl = thunder_tpu.jit(lambda p, i, t: jgpt.loss_fn(p, i, t, jcfg))
    tf = tt.jit(lambda p, i: tgpt.forward(p, i, tcfg), device="cpu")
    tl = tt.jit(lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg), device="cpu")
    want = (np.asarray(jf(jparams, idx), np.float32), float(jl(jparams, idx, tgt)))
    got = (tf(tparams, idx).float().numpy(), float(tl(tparams, idx, tgt)))
    jsyms = [b.sym.name for b in thunder_tpu.last_traces(jf)[0].bound_symbols]
    tsyms = [b.sym.name for b in tt.last_traces(tf)[0].bound_symbols]
    return got, want, jsyms, tsyms, tt.last_traces(tl)[-1].python()


def test_pythia_f32_forward_and_loss_match_jax():
    (logits, loss), (jlogits, jloss), jsyms, tsyms, _ = _pythia_run_both(jdtypes.float32)
    assert tsyms == jsyms  # the same program, symbol by symbol
    assert tsyms.count("layer_norm") == 2 * 2 + 1 and tsyms.count("gelu") == 2
    assert logits.shape == (B, T, 512)
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)


def test_pythia_bf16_forward_and_loss_match_jax(_jax_flash_on_cpu):
    (logits, loss), (jlogits, jloss), _, _, src = _pythia_run_both(jdtypes.bfloat16)
    assert src.count("flash_scaled_dot_product_attention(") == 2
    assert "fused_apply_rope(" not in src  # partial rotary: the rope kernel refuses it, as in the JAX package
    assert np.isfinite(logits).all()
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=5e-2 * np.abs(jlogits).max())
    np.testing.assert_allclose(loss, jloss, rtol=1e-2)


def test_init_params_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgpt.init_params(tgpt.name_to_config(CFG))
