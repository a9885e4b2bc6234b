"""The port's LitGPT training path against the JAX package's, on the CPU.

``thunder_tpu_torch.parallel.build_train_step`` (one joint fw+bw program,
then AdamW or SGD) runs a 2-layer pythia-like config (``dataclasses.replace``
of pythia-410m on both sides: n_embd 256, 4 heads of 64, V 512, so
LayerNorm with bias, biased linears, exact GELU, the parallel residual and
partial rotary) against ``thunder_tpu.parallel.train.build_train_step`` with
the norm executor on both sides, weights shared through
``params_from_jax``. Then ``benchmarks.litgpt`` runs in-process with
``--device cpu``.

Tolerances, in float32 (the two packages differ in summation order only):
- the loss of each step, rtol 1e-5;
- SGD moves each param by lr·(g + wd·p), with grads that agree to about
  1e-4 of their largest value (summation order, as in
  ``test_torch_port_train.py``): the params after two steps within 4 f32
  ulps of the param's largest |value| plus 1e-4 of its largest move;
- AdamW divides each element's step by that element's own running grad
  size, so an element whose grad is summation noise takes a step of up to
  lr in either package, unrelated to the other's: the k bias, for one, has
  an exact grad of zero (a constant added to every key of a query's row
  leaves its softmax as it was). Such elements are few, so each param is
  held by the norm of its difference over the norm of its move in the two
  steps: 1e-2, with no element further apart than the 4·lr that two steps
  can move it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.models import gpt as jgpt
from thunder_tpu.parallel import train as jtrain

from thunder_tpu_torch.benchmarks import litgpt
from thunder_tpu_torch.models import gpt as tgpt
from thunder_tpu_torch.parallel import train as ttrain

SMALL = dict(name="pythia-410m-test", n_layer=2, n_embd=256, n_head=4, vocab_size=512, padded_vocab_size=512,
             intermediate_size=1024, block_size=128)
B, T = 2, 64
LR = 3e-4


def _configs():
    jcfg = dataclasses.replace(jgpt.name_to_config("pythia-410m"), **SMALL)
    tcfg = dataclasses.replace(tgpt.name_to_config("pythia-410m"), **SMALL)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _shared(seed=0):
    jcfg, tcfg = _configs()
    jparams = jgpt.init_params(jcfg, dtype=jdtypes.float32, seed=seed)
    tparams = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    idx = np.random.RandomState(seed).randint(0, tcfg.vocab_size, (B, T))
    tgt = np.roll(idx, -1, axis=1)
    return jcfg, tcfg, jparams, tparams, idx, tgt


def _run_both(optimizer, steps=2):
    jcfg, tcfg, jparams, tparams, idx, tgt = _shared()
    jidx, jtgt = idx.astype(np.int32), tgt.astype(np.int32)
    jstep, jopt = jtrain.build_train_step(jcfg, jparams, jidx, jtgt, lr=LR, donate=False, optimizer=optimizer,
                                          executors=["norm", "pallas", "flash", "jax"])
    tidx, ttgt = torch.from_numpy(idx), torch.from_numpy(tgt)
    tstep, topt, extrace = ttrain.build_train_step(tcfg, tparams, tidx, ttgt, lr=LR, donate=False,
                                                   optimizer=optimizer, executors=["norm", "flash", "fused", "torch"],
                                                   return_extrace=True)
    src = extrace.python()
    n_norms = 2 * tcfg.n_layer + 1
    assert src.count("norm_layer_norm(") == n_norms and src.count("norm_layer_norm_bwd(") == n_norms
    assert src.count("fused_cross_entropy(") == 1 and src.count("fused_cross_entropy_bwd(") == 1
    assert "fused_apply_rope(" not in src  # partial rotary stays decomposed
    jl, tl = [], []
    for _ in range(steps):
        jparams, jopt, loss = jstep(jparams, jopt, jidx, jtgt)
        jl.append(float(loss))
        tparams, topt, loss = tstep(tparams, topt, tidx, ttgt)
        tl.append(float(loss))
    before = jax.tree_util.tree_leaves(_shared()[2])
    return tl, jl, tparams, jparams, topt, before


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def test_sgd_steps_match_jax():
    tl, jl, tparams, jparams, _, before = _run_both("sgd")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    got = [p.numpy() for p in torch.utils._pytree.tree_leaves(tparams)]
    want = _leaves(jparams)
    assert len(got) == len(want) == len(before)
    moved = 0
    for g, w, p0 in zip(got, want, before):
        move = np.abs(w - np.asarray(p0)).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=4 * np.spacing(np.abs(w).max()) + 1e-4 * move)
        moved += move > 0
    assert moved == len(want)


def test_adamw_steps_match_jax():
    tl, jl, tparams, jparams, topt, before = _run_both("adamw")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[1] < tl[0]
    assert int(topt["step"]) == 2 and topt["m"]["wte"].dtype == torch.float32
    got = [p.numpy() for p in torch.utils._pytree.tree_leaves(tparams)]
    want = _leaves(jparams)
    for g, w, p0 in zip(got, want, before):
        move = w - np.asarray(p0)
        assert np.abs(move).max() > LR  # the steps moved the param
        assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(move)
        assert np.abs(g - w).max() <= 4 * LR


def test_adamw_update_matches_jax_in_bf16():
    """The optimizer alone, on one set of bf16 params, moments and grads:
    moments in the params' type, f32 corrections, the update rounded to the
    param's type before the lr multiply, every Python scalar taken in the
    array's type (JAX's weak typing). Run op by op (not under ``jit``, where
    XLA may keep excess precision across a fused chain), both round each op
    to bf16: params and moments are the same bits."""
    rng = np.random.RandomState(3)
    shapes = [(64, 32), (32,)]
    p = [rng.randn(*s).astype(np.float32) for s in shapes]
    m = [rng.randn(*s).astype(np.float32) * 1e-3 for s in shapes]
    v = [np.abs(rng.randn(*s)).astype(np.float32) * 1e-6 for s in shapes]
    g = [rng.randn(*s).astype(np.float32) * 1e-3 for s in shapes]

    def jx(a):
        return [jax.numpy.asarray(x, dtype=jax.numpy.bfloat16) for x in a]

    def tx(a):
        return [torch.from_numpy(x).to(torch.bfloat16) for x in a]

    state_j = {"step": jax.numpy.asarray(4, dtype=jax.numpy.int32), "m": jx(m), "v": jx(v)}
    # Op by op, not under jit: each op rounds to bf16, as the port's do.
    jp, js = jtrain.adamw_update(jx(p), [x.astype(jax.numpy.float32) for x in jx(g)], state_j, lr=1e-2,
                                 weight_decay=0.1)
    for in_place in (False, True):
        p0 = tx(p)
        state = {"step": torch.tensor(4, dtype=torch.int32), "m": tx(m), "v": tx(v)}
        tp, ts = ttrain.adamw_update(p0, [x.float() for x in tx(g)], state, lr=1e-2, weight_decay=0.1,
                                     in_place=in_place)
        assert int(ts["step"]) == 5 and (tp is p0) == in_place
        for got, want in zip(ts["m"] + ts["v"], list(js["m"]) + list(js["v"])):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        for got, want, before in zip(tp, jp, p):
            assert got.dtype == torch.bfloat16
            assert (got.float().numpy() != np.asarray(jx([before])[0], np.float32)).any()  # the step moved it
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_sgd_update_matches_jax_in_bf16():
    """bf16-true SGD as ``thunder_tpu/parallel/train.py:174-177`` and
    ``bench.py:141`` write it, op by op in JAX: ``lr`` and ``wd`` are taken
    in bf16 (weak typing), each op rounds to bf16. The port's update gives
    the same bits; multiplying by the f32 scalars instead would not."""
    rng = np.random.RandomState(4)
    p = rng.randn(64, 32).astype(np.float32)
    g = rng.randn(64, 32).astype(np.float32)
    lr, wd = 0.3, 0.1  # a step large enough that the scalars' rounding shows in the params
    jp, jg = jax.numpy.asarray(p, jax.numpy.bfloat16), jax.numpy.asarray(g, jax.numpy.float32)
    want = np.asarray((jp - lr * (jg.astype(jp.dtype) + wd * jp)).astype(jp.dtype), np.float32)
    tp = torch.from_numpy(p).to(torch.bfloat16)
    grads = [torch.from_numpy(g)]
    (got,) = ttrain.sgd_update([tp], grads, lr, wd, in_place=False)
    assert grads == [None]  # each grad is dropped once used
    np.testing.assert_array_equal(got.float().numpy(), want)
    f32_scalars = tp - (torch.from_numpy(g).to(torch.bfloat16) + tp * wd) * lr
    assert not torch.equal(f32_scalars, got)


@pytest.fixture
def small_model(monkeypatch):
    _, tcfg = _configs()
    monkeypatch.setitem(tgpt.configs, tcfg.name, tcfg)
    return tcfg.name


def _argv(model, *extra):
    return ["--model", model, "--micro-batch", str(B), "--seq", str(T), "--iters", "2", "--warmup", "1",
            "--device", "cpu", *extra]


def test_litgpt_run_one_trains_and_reports(small_model):
    args = litgpt.parse_args(_argv(small_model))
    s = litgpt.run_one(args, "norm,flash,fused,torch")
    assert s["device"] == "cpu" and s["iters"] == 2 and s["executors"] == "norm,flash,fused,torch"
    assert s["tokens_per_sec"] > 0 and "mfu" not in s and "memory_used_GB" not in s  # no device metric on the CPU
    assert np.isfinite(s["loss_first"]) and s["loss_last"] < s["loss_first"]
    assert abs(s["loss_first"] - np.log(512)) < 0.5
    fwd = litgpt.run_one(litgpt.parse_args(_argv(small_model, "--forward-only")))
    assert fwd["name"].endswith("-fwd") and "loss_first" not in fwd


def test_litgpt_matrix_markdown_has_every_stack(small_model, capsys):
    litgpt.main(_argv(small_model, "--matrix", "--markdown", "--optimizer", "sgd"))
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.startswith("| ") and not ln.startswith("| executors")]
    assert [r.split("|")[1].strip() for r in rows] == [label for label, _ in litgpt.MATRIX_STACKS]
    assert "(cpu)" in out.splitlines()[0]


@pytest.mark.parametrize("flag", ["--dp", "--fsdp", "--tp"])
def test_litgpt_mesh_flags_raise(small_model, flag):
    """A mesh of 2 in one process with no process group raises, as the JAX
    package's CLI does with one device; its parity on gloo ranks is
    ``tests/test_torch_port_parallel.py``'s."""
    with pytest.raises(ValueError, match="Mesh needs 2 devices, only 1 available"):
        litgpt.main(_argv(small_model, flag, "2"))


def test_build_train_step_refuses_a_mesh():
    """A pipeline mesh of one rank (ROADMAP item 11b, no process group)
    gives the one-device step's losses, bit for bit: no collective names
    its axes."""
    import copy

    from thunder_tpu_torch.parallel import make_mesh

    _, tcfg, _, tparams, idx, tgt = _shared()
    i, t = torch.from_numpy(idx), torch.from_numpy(tgt)
    losses = []
    for mesh in (None, make_mesh(pp=1)):
        params = copy.deepcopy(tparams)
        step, opt = ttrain.build_train_step(tcfg, params, i, t, mesh=mesh, optimizer="sgd", donate=False)
        run = []
        for _ in range(2):
            params, opt, loss = step(params, opt, i, t)
            run.append(loss)
        losses.append(run)
    assert all(torch.equal(a, b) for a, b in zip(*losses)), losses


def test_sgd_with_donate_updates_in_place():
    _, tcfg, _, tparams, idx, tgt = _shared()
    step, opt = ttrain.build_train_step(tcfg, tparams, torch.from_numpy(idx), torch.from_numpy(tgt),
                                        optimizer="sgd", donate=True, executors=["norm", "flash", "fused", "torch"])
    w = tparams["lm_head_w"]
    ptr, w0 = w.data_ptr(), w.clone()
    new_params, _, _ = step(tparams, opt, torch.from_numpy(idx), torch.from_numpy(tgt))
    assert new_params is tparams and w.data_ptr() == ptr and not torch.equal(w, w0)


def test_peak_flops_is_looked_up_by_card_name(monkeypatch):
    from thunder_tpu_torch.benchmarks import peak_flops

    assert peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert peak_flops("cuda") == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA A100-SXM4-80GB")
    assert peak_flops("cuda") is None  # an unknown card: MFU is left out


def test_benchmark_result_prunes_outliers_and_reports_mfu():
    from thunder_tpu_torch.benchmarks import BenchmarkResult

    r = BenchmarkResult(name="x", iters=5, times_s=[1.0, 1.1, 0.9, 1.0, 10.0], device="NVIDIA H100 80GB HBM3",
                        tokens_per_iter=4096, flops_per_iter=2e12, peak_flops=989e12, memory_gb=1.5)
    s = r.summary()
    assert s["outliers_pruned"] == 1 and s["median_iter_time_s"] == 1.0 and s["tokens_per_sec"] == 4096
    assert s["mfu"] == round(2e12 / 989e12, 4) and s["memory_used_GB"] == 1.5
    piped = BenchmarkResult(name="x", iters=3, times_s=[0.5] * 3, pipelined=True).summary()
    assert piped["pipelined"] and "median_iter_time_s" not in piped and "mfu" not in piped
