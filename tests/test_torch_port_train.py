"""The port's training step against the JAX package, on the CPU.

``benchmarks.train.build_train`` (the counterpart of ``bench.py``'s
``build_train``: split fw/bw traces, attention residuals, rematerialization,
claiming, a backward that takes its saved tensors as a list it clears, and
an in-place bf16-true SGD update) runs on ``llama-hs100-tiny`` (open_llama_3b's
head size at a test width) with weights shared with the JAX package.

Tolerances: in float32 the split path's gradients are those of the joint
path (``tt.value_and_grad``) to rounding, and the JAX package's to rtol 1e-4
(summation order); one SGD step moves each param by lr·(g + wd·p), a few
ulps of the param at most, so the stepped params are held to two f32 ulps of
the largest |param| against the same update computed in numpy from the JAX
package's gradients.
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
from thunder_tpu_torch.benchmarks import train
from thunder_tpu_torch.models import gpt as tgpt

CFG = "llama-hs100-tiny"
B, T = 2, 128


def _shared(dtype, seed=0):
    tcfg = tgpt.name_to_config(CFG)
    jcfg = jgpt.GPTConfig(**dataclasses.asdict(tcfg))
    jparams = jgpt.init_params(jcfg, dtype=dtype, seed=seed)
    tparams = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    idx = np.random.RandomState(seed).randint(0, tcfg.vocab_size, (B, T))
    return jcfg, tcfg, jparams, tparams, idx


def _jax_grads(jcfg, jparams, idx):
    """{param path: grad} of the JAX package's loss on (idx, idx shifted)."""
    tgt = np.roll(idx, -1, axis=1).astype(np.int32)
    jl, jg = thunder_tpu.value_and_grad(lambda p, i, t: jgpt.loss_fn(p, i, t, jcfg))(
        jparams, idx.astype(np.int32), tgt)
    paths = jax.tree_util.tree_flatten_with_path(jparams)[0]
    return float(jl), {jax.tree_util.keystr(k): np.asarray(g, np.float32) for (k, _), g in zip(paths, jg)}


def _paths(tparams):
    """Each port param's path, in the order of its flat params."""
    import torch.utils._pytree as pt

    return [pt.keystr(k) for k, _ in pt.tree_flatten_with_path(tparams)[0]]


def test_split_step_grads_match_the_joint_path_and_jax():
    jcfg, tcfg, jparams, tparams, idx = _shared(jdtypes.float32)
    step = train.build_train(tcfg, B, T, device="cpu", params=tparams, idx=idx)
    loss, grads = step.forward_backward()
    jl, jg = _jax_grads(jcfg, jparams, idx)
    _, joint = tt.value_and_grad(lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg), device="cpu")(
        tparams, step.idx, step.tgt)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-4)
    assert len(grads) == len(joint) == len(step.flat_params) == len(jg)
    for path, g, w, p in zip(_paths(tparams), grads, joint, step.flat_params):
        assert g.shape == p.shape and g.dtype == p.dtype
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(g.numpy(), jg[path], rtol=1e-4, atol=1e-4 * np.abs(jg[path]).max(), err_msg=path)


def test_one_sgd_step_matches_the_update_from_jax_grads():
    jcfg, tcfg, jparams, tparams, idx = _shared(jdtypes.float32, seed=1)
    step = train.build_train(tcfg, B, T, device="cpu", params=tparams, idx=idx)
    before = [p.clone() for p in step.flat_params]
    ptrs = [p.data_ptr() for p in step.flat_params]
    step.step()
    assert [p.data_ptr() for p in step.flat_params] == ptrs  # updated in place
    _, jg = _jax_grads(jcfg, jparams, idx)
    cases = [(p0, p1, jg[path]) for path, p0, p1 in zip(_paths(tparams), before, step.flat_params)]
    assert len(cases) == len(jg)
    for p0, p1, g in cases:
        p0 = p0.numpy()
        want = p0 - np.float32(train.LR) * (g + np.float32(train.WD) * p0)
        np.testing.assert_allclose(p1.numpy(), want, rtol=0, atol=2 * np.spacing(np.abs(p0).max()))
        assert (p1.numpy() != p0).mean() > 0.5  # the step moved the params


def test_backward_takes_saved_tensors_as_a_list_it_clears():
    _, tcfg, _, tparams, idx = _shared(jdtypes.bfloat16)
    step = train.build_train(tcfg, B, T, device="cpu", params=tparams, idx=idx)
    src = step.bw_trace.python()
    assert "def backward(saved_for_backward, " in src and "saved_for_backward.clear()" in src
    loss, saved = step.fw_fn(*step.flat_params, step.idx, step.tgt)
    saved = list(saved)
    n = len(saved)
    assert n == len(step.fw_trace.tags["saved_for_backward"]) > 0
    step.bw_fn(saved, torch.ones(()))
    assert saved == []  # nothing of the forward outlives its last use in the backward


def test_claims_and_timings_of_the_built_step():
    _, tcfg, _, tparams, idx = _shared(jdtypes.bfloat16)
    step = train.build_train(tcfg, B, T, device="cpu", params=tparams, idx=idx)
    fw, bw = step.fw_trace.python(), step.bw_trace.python()
    n = tcfg.n_layer
    assert fw.count("flash_sdpa_fwd_res(") == n and bw.count("flash_sdpa_bwd_res(") == n
    assert fw.count("fused_apply_rope(") == 2 * n and bw.count("fused_apply_rope(") == 2 * n
    assert fw.count("fused_cross_entropy(") == 1 and bw.count("fused_cross_entropy_bwd(") == 1
    assert set(step.seconds) == {"trace", "autodiff", "residuals", "remat", "claim"}
    losses = [float(step.step()) for _ in range(2)]
    assert all(np.isfinite(losses))


def test_build_train_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.build_train(tgpt.name_to_config(CFG), B, T)
