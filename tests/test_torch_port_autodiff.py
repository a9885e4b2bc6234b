"""The port's autodiff against the JAX package's, on the CPU, with shared weights.

``tt.value_and_grad`` of the GPT loss (the joint fw+bw trace, rewritten by the
attention-residual pass, claimed by the kernel executors) is held against
``thunder_tpu.value_and_grad`` on the same weights (``params_from_jax``) and
the same token ids, at open_llama_3b's head size with a test width:
``llama-hs100-tiny`` (n_embd 200, 2 heads of 100, 2 layers, V = 256, T = 128).
The JAX package runs its splash attention in Pallas interpret mode.

Tolerances: float32 agrees to rtol 1e-4 (summation order only). In bf16 each
gradient is held by its norm-relative error, ||g - g_jax|| / ||g_jax||: the
two packages round to bf16 at different places (the JAX package rounds
q*scale to bf16 before its attention kernels, multiplies rope in bf16, and
its splash backward rounds P and dS at other points), each a relative change
of up to 2^-8 per element that two layers of backward compound. The limit is
2^-5, four bf16 ulps (the largest reading on this config is 9.3e-3, on a
norm weight).

Also here: the passes of the training path (attention residuals, mincut,
rematerialization) and the claims the joint trace gets.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import thunder_tpu
from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.core.pytree import tree_flatten as jtree_flatten
from thunder_tpu.models import gpt as jgpt

import thunder_tpu_torch as tt
import thunder_tpu_torch.torch as ttorch
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.models import gpt as tgpt
from thunder_tpu_torch.transforms import mincut

CFG = "llama-hs100-tiny"
B, T = 2, 128


@pytest.fixture
def _jax_flash_on_cpu(monkeypatch):
    monkeypatch.setenv("THUNDER_FLASH_FORCE", "1")


def _inputs(dtype):
    tcfg = tgpt.name_to_config(CFG)
    jcfg = jgpt.GPTConfig(**dataclasses.asdict(tcfg))
    jparams = jgpt.init_params(jcfg, dtype=dtype, seed=0)
    tparams = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.RandomState(0)
    idx = rng.randint(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    tgt = rng.randint(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, idx, tgt


def _names(params, flatten):
    """Each param leaf's path, in the order ``flatten`` gives the leaves."""

    def paths(x, pre):
        if isinstance(x, dict):
            return {k: paths(v, f"{pre}.{k}") for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [paths(v, f"{pre}[{i}]") for i, v in enumerate(x)]
        return pre

    return flatten(paths(params, "p"))[0]


def _value_and_grads(dtype):
    """{param path: (port grad, JAX grad)} as float32 numpy, and both losses."""
    jcfg, tcfg, jparams, tparams, idx, tgt = _inputs(dtype)
    jl, jg = thunder_tpu.value_and_grad(lambda p, i, t: jgpt.loss_fn(p, i, t, jcfg))(jparams, idx, tgt)
    tf = tt.value_and_grad(lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg), device="cpu")
    tl, tg = tf(tparams, idx, tgt)
    want = dict(zip(_names(jparams, jtree_flatten), (np.asarray(g, np.float32) for g in jg)))
    got = dict(zip(_names(tparams, tree_flatten), (g.float().numpy() for g in tg)))
    assert set(got) == set(want) and len(got) == 3 + 7 * tcfg.n_layer
    return {k: (got[k], want[k]) for k in got}, float(tl), float(jl), tt.last_traces(tf)[-1].python()


def test_value_and_grad_matches_jax_in_f32():
    grads, loss, jloss, _ = _value_and_grads(jdtypes.float32)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    for name, (g, w) in grads.items():
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_value_and_grad_matches_jax_in_bf16(_jax_flash_on_cpu):
    grads, loss, jloss, src = _value_and_grads(jdtypes.bfloat16)
    np.testing.assert_allclose(loss, jloss, rtol=1e-2)
    for name, (g, w) in grads.items():
        assert np.isfinite(g).all(), name
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 2.0 ** -5, f"{name}: norm-relative error {rel}"
    # The joint trace runs the training path's kernels: attention from the
    # saved (out, lse), the cross-entropy backward, rope forward and backward.
    n = tgpt.name_to_config(CFG).n_layer
    assert src.count("flash_sdpa_fwd_res(") == n and src.count("flash_sdpa_bwd_res(") == n
    assert "flash_scaled_dot_product_attention(" not in src and "sdpa_bwd(" not in src
    assert src.count("fused_cross_entropy(") == 1 and src.count("fused_cross_entropy_bwd(") == 1
    assert src.count("fused_apply_rope(") == 4 * n  # q and k, forward and backward


def test_grad_returns_the_grads_of_value_and_grad():
    _, tcfg, _, tparams, idx, tgt = _inputs(jdtypes.float32)
    f = lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg)  # noqa: E731
    grads = tt.grad(f, device="cpu")(tparams, idx, tgt)
    _, want = tt.value_and_grad(f, device="cpu")(tparams, idx, tgt)
    assert isinstance(grads, tuple) and len(grads) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def test_torch_executor_alone_keeps_the_decomposed_backward():
    _, tcfg, _, tparams, idx, tgt = _inputs(jdtypes.bfloat16)
    f = lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg)  # noqa: E731
    ref = tt.value_and_grad(f, device="cpu", executors=["torch"])
    fast = tt.value_and_grad(f, device="cpu")
    (rl, rg), (fl, fg) = ref(tparams, idx, tgt), fast(tparams, idx, tgt)
    src = tt.last_traces(ref)[-1].python()
    assert "flash_" not in src and "fused_" not in src  # no residual rewrite without the flash executor
    np.testing.assert_allclose(float(fl), float(rl), rtol=1e-2)
    for a, b in zip(fg, rg):
        assert (a.float() - b.float()).norm() <= 5e-2 * b.float().norm()


def test_grad_of_a_small_function_matches_torch_autograd():
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 8).astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(2).randn(8, 3).astype(np.float32))

    def f(x, w):
        return ttorch.sum(ttorch.tanh(ttorch.matmul(x, w)) ** 2)

    gx, gw = tt.grad(f, device="cpu")(x, w)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    (torch.tanh(xa @ wa) ** 2).sum().backward()
    torch.testing.assert_close(gx, xa.grad)
    torch.testing.assert_close(gw, wa.grad)


def test_a_prim_without_a_lowering_raises(monkeypatch):
    """The torch executor has no lowering for this prim here: claiming
    raises instead of running something else."""
    from thunder_tpu_torch.core.prims import PrimIDs
    from thunder_tpu_torch.executors import torchex

    monkeypatch.delitem(torchex.ex.implmap, PrimIDs.TANH)
    f = tt.grad(lambda x: ttorch.sum(ttorch.tanh(x)), device="cpu")
    with pytest.raises(RuntimeError, match="No executor for primitive"):
        f(torch.ones(4))


# =============================================================================
# The training path's passes
# =============================================================================


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mincut_native_and_python_give_one_cut(seed):
    rng = np.random.RandomState(seed)
    n = 40
    edges = [(int(u), int(v), int(rng.randint(1, 50))) for u, v in rng.randint(0, n, (160, 2)) if u != v]
    edges += [(0, int(v), mincut.INF_CAP) for v in rng.randint(2, n, 4)]
    flow_py, side_py = mincut._min_cut_py(n, edges, 0, 1)
    flow, side = mincut.min_cut(n, edges, 0, 1)
    assert mincut.using_native()  # g++ builds it into thunder_tpu_torch/_build/
    assert (flow, side) == (flow_py, side_py)


def test_split_residuals_and_remat_shrink_saved_for_backward():
    from thunder_tpu_torch import api
    from thunder_tpu_torch.transforms.attention_residuals import save_sdpa_residuals
    from thunder_tpu_torch.transforms.autodiff import forward_and_backward_from_trace
    from thunder_tpu_torch.transforms.common import cse, dce
    from thunder_tpu_torch.transforms.rematerialization import rematerialize_forward_and_backward

    _, tcfg, _, tparams, idx, tgt = _inputs(jdtypes.bfloat16)
    _, comp = api.trace_program(lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg),
                                (tparams, torch.from_numpy(idx), torch.from_numpy(tgt)), {})
    fw, bw = forward_and_backward_from_trace(cse(dce(comp)))
    n0 = len(fw.tags["saved_for_backward"])
    fw, bw = save_sdpa_residuals(fw, bw, api.DEFAULT_EXECUTORS)
    names = lambda trc: [b.sym.name for b in trc.bound_symbols]  # noqa: E731
    assert names(fw).count("sdpa_fwd_res") == tcfg.n_layer and names(bw).count("sdpa_bwd_res") == tcfg.n_layer
    assert "sdpa_bwd" not in names(bw)
    n1 = len(fw.tags["saved_for_backward"])
    assert n1 == n0 + 2 * tcfg.n_layer  # each layer's out and lse join the saved set
    args = {a.name for a in fw.args}

    def saved_bytes(trc):
        return sum(p.size_bytes for p in trc.output[1] if p.name not in args)

    before = saved_bytes(fw)
    fw2, bw2 = rematerialize_forward_and_backward(fw, bw)
    assert saved_bytes(fw2) < before
    assert len(bw2.args) == len(fw2.output[1]) + 1  # saved..., then the loss cotangent


def test_remat_places_each_recomputed_op_just_before_its_first_consumer():
    """Run eagerly, recomputed tensors must not all be made at the top of the
    backward (they would be live beside the saved ones for the whole
    backward): each run of recomputed ops ends at the op that consumes it."""
    from thunder_tpu_torch import api
    from thunder_tpu_torch.transforms.attention_residuals import save_sdpa_residuals
    from thunder_tpu_torch.transforms.autodiff import forward_and_backward_from_trace
    from thunder_tpu_torch.transforms.common import cse, dce
    from thunder_tpu_torch.transforms.rematerialization import rematerialize_forward_and_backward

    _, tcfg, _, tparams, idx, tgt = _inputs(jdtypes.bfloat16)
    _, comp = api.trace_program(lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg),
                                (tparams, torch.from_numpy(idx), torch.from_numpy(tgt)), {})
    fw, bw = forward_and_backward_from_trace(cse(dce(comp)))
    fw, bw = rematerialize_forward_and_backward(*save_sdpa_residuals(fw, bw, api.DEFAULT_EXECUTORS))
    recomputed = {id(b) for b in fw.bound_symbols}
    bsyms = bw.bound_symbols
    is_re = [id(b) in recomputed for b in bsyms]
    assert 0 < sum(is_re) < len(bsyms)
    for i, b in enumerate(bsyms):
        if not is_re[i]:
            continue
        outs = {o.name for o in b.flat_proxy_outs}
        j = next(j for j in range(i + 1, len(bsyms)) if outs & {a.name for a in bsyms[j].flat_proxy_args})
        assert all(is_re[i:j]), f"{b.sym.name} is recomputed {j - i} ops before its first consumer"
