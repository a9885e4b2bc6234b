"""The int8 convergence run (``thunder_tpu_torch/scripts/quant_convergence.py``)
against the JAX package, on the CPU.

The counterpart of ``scripts/quant_convergence.py`` at a tiny size: a
pythia-shaped config (2 layers, width 64, quarter rotary, parallel
residual, LayerNorm, GptNeoxMLP, padded vocabulary 128) registered in both
packages under one name, B=2, T=64, 9 iterations (batch 0 is seen again at
the last one).

- Each variant's ``run`` (bf16, int8 everywhere, int8 with the lm_head
  skipped) gives the losses of the JAX package's ``build_train_step`` run the
  way the JAX script's ``run`` runs it: the same stack (``["quant", "pallas",
  "flash", "jax"]`` there, ``["quant", "fused", "flash", "torch"]`` here), the
  same recipe, the same weights (the JAX package's init, given through
  ``models.gpt.params_from_jax``) and the same batches.
- With the script's bf16 weights every loss is within ``BF16_LOSS_TOL``
  (2e-3 absolute) of the JAX package's; 4.6e-4 was the largest difference
  seen. Between the packages the bf16 activations differ by a rounding here
  and there, and each such difference can move an int8 rounding by a whole
  step: so at bf16 the int8 variants' own effect on the loss (at most
  6e-4 seen from bf16's over 32 iterations) is the size of that noise, and
  this comparison cannot tell int8 from bf16. It does tell trained weights
  from untouched ones: batch 0's loss falls by 0.246 between iterations 0
  and 8, over 100 times the limit.
- With f32 weights (the same init in f32) the activations agree to f32
  rounding and so do the int8 roundings: the first loss, the forward on the
  shared weights before any update, is within ``F32_FIRST_TOL`` (2e-6, four
  f32 ulps at 4.87; 4.8e-7 seen) of the JAX package's, and the int8
  variants' first losses lie at least 10 times that from the plain
  variant's and from each other's (3.4e-4 int8 against plain, 2.1e-5 the
  lm_head's share seen). So that comparison tells an int8 forward from a
  plain one, and a quantization with another scale. Later losses, after
  updates whose roundings flip int8 values, are within ``F32_LOSS_TOL``
  (5e-4; 1.2e-4 seen).
- The int8 variants really quantize: their int8 products are counted per
  step (9 linears, 8 with the lm_head skipped); the skip variant's claimed
  trace holds one quantized linear fewer.
- The CLI's last line holds the three variants; its flags and defaults are
  the JAX script's (read from its source: importing it reads ``sys.argv``).
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.executors.quantex import QuantRecipe as JQuantRecipe
from thunder_tpu.executors.quantex import set_recipe as jset_recipe
from thunder_tpu.models import gpt as jgpt
from thunder_tpu.parallel import build_train_step as jbuild_train_step

from thunder_tpu_torch.executors import quantex as tq
from thunder_tpu_torch.models import gpt as tgpt
from thunder_tpu_torch.parallel import build_train_step
from thunder_tpu_torch.scripts import quant_convergence as qc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "quant_convergence.py")
TINY = "pythia-quant-tiny"
BATCH, SEQ, ITERS = 2, 64, 9
BF16_LOSS_TOL = 2e-3  # absolute, per loss, with the script's bf16 weights
F32_FIRST_TOL = 2e-6  # absolute, the first loss with f32 weights
F32_LOSS_TOL = 5e-4  # absolute, every loss with f32 weights
PADDED_VOCAB = 128
JAX_INT8_STACK = ["quant", "pallas", "flash", "jax"]
LINEARS = 9  # 2 layers x (qkv, attention proj, fc, mlp proj) + the lm_head
VARIANTS = {
    "bf16": (None, None, ()),
    "int8_all": (JAX_INT8_STACK, qc.INT8_STACK, ()),
    "int8_skip_lm_head": (JAX_INT8_STACK, qc.INT8_STACK, (PADDED_VOCAB,)),
}


def _tiny(gpt_module):
    return dataclasses.replace(gpt_module.name_to_config("pythia-160m"), name=TINY, n_layer=2, n_head=2, n_embd=64,
                               intermediate_size=256, vocab_size=100, padded_vocab_size=PADDED_VOCAB, block_size=64)


@pytest.fixture(scope="module", autouse=True)
def tiny_config():
    jgpt.configs[TINY] = _tiny(jgpt)
    tgpt.configs[TINY] = _tiny(tgpt)
    yield
    del jgpt.configs[TINY], tgpt.configs[TINY]


def _jax_run(executors, skip_out=(), dtype=jdtypes.bfloat16):
    """The body of ``scripts/quant_convergence.py``'s ``run`` at the tiny
    size, its weights in ``dtype``: (losses, the initial weights as numpy)."""
    jset_recipe(JQuantRecipe(skip_out_features=tuple(skip_out)))
    try:
        cfg = jgpt.name_to_config(TINY)
        params = jgpt.init_params(cfg, dtype=dtype, device_init=True, seed=0)
        weights = jax.tree_util.tree_map(np.asarray, params)  # the step donates params
        rng = np.random.RandomState(0)
        batches = [rng.randint(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32) for _ in range(8)]
        idx = batches[0]
        tgt = np.roll(idx, -1, axis=1).astype(np.int32)
        step, opt = jbuild_train_step(cfg, params, idx, tgt, lr=qc.LR, weight_decay=qc.WD, optimizer="adamw",
                                      executors=executors)
        params, opt, loss = step(params, opt, idx, tgt)
        losses = [float(np.asarray(loss))]
        prev = None
        for i in range(ITERS - 1):
            idx = batches[(i + 1) % len(batches)]
            tgt = np.roll(idx, -1, axis=1).astype(np.int32)
            params, opt, loss = step(params, opt, idx, tgt)
            if prev is not None:
                losses.append(float(np.asarray(prev)))
            prev = loss
        losses.append(float(np.asarray(prev)))
    finally:
        jset_recipe(JQuantRecipe())
    return losses, weights


def _both(dtype):
    """Every variant through both packages with weights in ``dtype``:
    {tag: (JAX losses, the port's result, the port's int8 products)} (on the
    CPU ``quant_linear`` looks ``int8_gemm`` up at each call)."""
    out = {}
    real = tq.int8_gemm
    calls = [0]

    def counting(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    tq.int8_gemm = counting
    try:
        for tag, (jex, tex, skip) in VARIANTS.items():
            want, weights = _jax_run(jex, skip, dtype)
            calls[0] = 0
            got = qc.run(tag, tex, skip, model=TINY, batch=BATCH, seq=SEQ, iters=ITERS,
                         params=tgpt.params_from_jax(weights, device="cpu"), device="cpu")
            out[tag] = (want, got, calls[0])
    finally:
        tq.int8_gemm = real
    return out


@pytest.fixture(scope="module")
def runs():
    return _both(jdtypes.bfloat16)


@pytest.fixture(scope="module")
def runs_f32():
    return _both(jdtypes.float32)


@pytest.mark.parametrize("tag", list(VARIANTS))
def test_losses_match_the_jax_package(runs, tag):
    want, got, _ = runs[tag]
    assert got["iters"] == ITERS and len(got["losses"]) == ITERS == len(want)
    assert got["avg_iter_s"] > 0
    assert np.isfinite(got["losses"]).all()
    assert np.abs(np.asarray(got["losses"]) - want).max() <= BF16_LOSS_TOL, (got["losses"], want)
    # Batch 0 again at the last iteration: the weights moved, in both
    # packages, far past the limit.
    assert want[0] - want[-1] > 100 * BF16_LOSS_TOL and got["losses"][0] - got["losses"][-1] > 100 * BF16_LOSS_TOL


@pytest.mark.parametrize("tag", list(VARIANTS))
def test_f32_losses_match_the_jax_package(runs_f32, tag):
    want, got, _ = runs_f32[tag]
    got = np.asarray(got["losses"])
    assert abs(got[0] - want[0]) <= F32_FIRST_TOL, (got[0], want[0])
    assert np.abs(got - want).max() <= F32_LOSS_TOL, (got.tolist(), want)


@pytest.mark.parametrize("a,b", [("int8_all", "bf16"), ("int8_skip_lm_head", "bf16"),
                                 ("int8_all", "int8_skip_lm_head")])
def test_f32_first_losses_tell_the_variants_apart(runs_f32, a, b):
    """The first-loss comparison can tell an int8 forward from a plain one,
    and the int8 lm_head from a bf16 one: the variants' first losses lie
    more than 10 limits apart, in both packages."""
    assert abs(runs_f32[a][0][0] - runs_f32[b][0][0]) > 10 * F32_FIRST_TOL
    assert abs(runs_f32[a][1]["losses"][0] - runs_f32[b][1]["losses"][0]) > 10 * F32_FIRST_TOL


def test_int8_variants_quantize_and_the_skip_drops_the_lm_head(runs):
    assert runs["bf16"][2] == 0
    assert runs["int8_all"][2] == ITERS * LINEARS
    assert runs["int8_skip_lm_head"][2] == ITERS * (LINEARS - 1)
    bf16 = runs["bf16"][1]["losses"]
    assert runs["int8_all"][1]["losses"] != bf16
    assert runs["int8_skip_lm_head"][1]["losses"] != bf16


def test_the_recipe_is_restored_after_a_run_and_after_an_error():
    qc.run("skip", qc.INT8_STACK, (PADDED_VOCAB,), model=TINY, batch=BATCH, seq=SEQ, iters=1, device="cpu")
    assert tq.get_recipe() == tq.QuantRecipe()
    with pytest.raises(RuntimeError, match="Unknown executor"):
        qc.run("bad", ["no-such-executor"], (PADDED_VOCAB,), model=TINY, batch=BATCH, seq=SEQ, iters=1,
               device="cpu")
    assert tq.get_recipe() == tq.QuantRecipe()


def _quant_linears(skip_out) -> int:
    cfg = tgpt.name_to_config(TINY)
    idx = torch.from_numpy(qc.make_batches(cfg.vocab_size, BATCH, SEQ)[0])
    tq.set_recipe(tq.QuantRecipe(skip_out_features=skip_out))
    try:
        params = tgpt.init_params(cfg, dtype=torch.bfloat16, seed=0, device="cpu")
        _, _, extrace = build_train_step(cfg, params, idx, torch.roll(idx, -1, dims=1), executors=qc.INT8_STACK,
                                         return_extrace=True)
    finally:
        tq.set_recipe(tq.QuantRecipe())
    return sum(1 for bsym in extrace.bound_symbols
               if bsym.sym.name == "linear" and getattr(bsym.sym.executor, "name", None) == "quant")


def test_skip_variants_claimed_trace_holds_one_quantized_linear_fewer():
    assert _quant_linears(()) == LINEARS
    assert _quant_linears((PADDED_VOCAB,)) == LINEARS - 1


def test_cli_last_line_holds_the_three_variants(tmp_path):
    """``main()`` reads its arguments from ``sys.argv``; the size is the
    module's (``MODEL``, ``B``, ``T``), set small in the child process."""
    out = tmp_path / "qc.json"
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    code = ("from thunder_tpu_torch.scripts import quant_convergence as qc; "
            "qc.MODEL, qc.B, qc.T = 'gpt-tiny', 2, 32; raise SystemExit(qc.main())")
    r = subprocess.run([sys.executable, "-c", code, "3", str(out), "--device", "cpu"],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert (last["model"], last["batch"], last["seq"]) == ("gpt-tiny", 2, 32)
    for k in ("bf16", "int8_all", "int8_skip_lm_head"):
        assert {"final_loss", "avg_iter_s", "gap"} <= set(last[k])
    assert last["int8_all"]["gap"] == json.load(open(out))["int8_all"]["loss_gap_vs_bf16"]
    assert set(last["int8_all"]["gap"]) == {"3"}  # the horizons within the run


def test_entry_defaults_to_the_card_and_raises_without_one():
    assert qc.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            qc.run("bf16", None, model=TINY, batch=BATCH, seq=SEQ, iters=1)


def _jax_constants() -> dict:
    tree = ast.parse(open(JAX_SCRIPT).read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            names += [e.id for t in node.targets if isinstance(t, ast.Tuple) for e in t.elts]
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                continue
            if isinstance(node.targets[0], ast.Tuple):
                out.update(zip(names, value))
            else:
                out.update({n: value for n in names})
    return out


def test_flags_and_defaults_match_the_jax_script():
    c = _jax_constants()
    assert (qc.MODEL, qc.B, qc.T, qc.LR, qc.WD) == (c["MODEL"], c["B"], c["T"], c["LR"], c["WD"])
    src = open(JAX_SCRIPT).read()
    assert "int(sys.argv[1]) if len(sys.argv) > 1 else 200" in src and qc.ITERS == 200
    assert '"/tmp/quant_convergence.json"' in src
    args = qc.parse_args(["7", "x.json"])
    assert vars(args) == {"iters": 7, "out": "x.json", "device": "cuda"}  # the JAX script's two, and --device
    assert os.path.basename(qc.parse_args([]).out) == "quant_convergence.json"
    assert '["quant", "pallas", "flash", "jax"]' in src and qc.INT8_STACK == ["quant", "fused", "flash", "torch"]
    assert "for h in (10, 50, 100, ITERS)" in src and qc.HORIZONS == (10, 50, 100)
    assert qc.loss_gaps({"losses": [1.0] * 12}, {"losses": [0.5] * 12}, 12) == {"10": 0.5, "12": 0.5}
