"""The port's compiler path against the JAX package's, on the CPU.

``thunder_tpu_torch`` keeps the JAX package's IR, languages and passes, so
tracing the same program must give the same sequence of symbols. The guarded
cache, the claiming of the kernel executors and ``del_last_used`` are checked
on the port alone. The port must import neither JAX nor ``thunder_tpu``.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import thunder_tpu
from thunder_tpu.models import gpt as jgpt

import thunder_tpu_torch as tt
import thunder_tpu_torch.torch as ttorch
from thunder_tpu_torch.models import gpt as tgpt

REPO = Path(__file__).resolve().parent.parent


def _llama_tiny(T=16, B=2):
    jcfg, tcfg = jgpt.name_to_config("llama-tiny"), tgpt.name_to_config("llama-tiny")
    jparams = jgpt.init_params(jcfg)
    tparams = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    idx = np.random.RandomState(0).randint(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, idx


def test_forward_trace_has_the_jax_packages_symbols():
    jcfg, tcfg, jparams, tparams, idx = _llama_tiny()
    jf = thunder_tpu.jit(lambda p, i: jgpt.forward(p, i, jcfg))
    tf = tt.jit(lambda p, i: tgpt.forward(p, i, tcfg), device="cpu")
    jf(jparams, idx)
    tf(tparams, idx)
    want = [b.sym.name for b in thunder_tpu.last_traces(jf)[0].bound_symbols]
    got = [b.sym.name for b in tt.last_traces(tf)[0].bound_symbols]
    assert got == want
    assert got.count("scaled_dot_product_attention") == tcfg.n_layer
    assert got.count("apply_rope") == 2 * tcfg.n_layer


def test_cache_hit_then_miss_on_new_shape():
    _, tcfg, _, tparams, idx = _llama_tiny()
    tf = tt.jit(lambda p, i: tgpt.forward(p, i, tcfg), device="cpu")
    a = tf(tparams, idx)
    b = tf(tparams, idx)
    assert (tt.cache_misses(tf), tt.cache_hits(tf)) == (1, 1)
    assert torch.equal(a, b)
    c = tf(tparams, idx[:, :8])
    assert (tt.cache_misses(tf), tt.cache_hits(tf)) == (2, 1)
    assert c.shape == (2, 8, tcfg.padded_vocab_size)
    tf(tparams, idx)  # the first entry still serves the first shape
    assert (tt.cache_misses(tf), tt.cache_hits(tf)) == (2, 2)


def test_number_inputs_are_guarded():
    jf = tt.jit(lambda x, n: x * n, device="cpu")
    x = torch.ones(3)
    assert torch.equal(jf(x, 2.0), torch.full((3,), 2.0))
    assert torch.equal(jf(x, 3.0), torch.full((3,), 3.0))
    assert tt.cache_misses(jf) == 2


def test_numpy_and_torch_inputs_give_one_result():
    x = np.random.RandomState(1).randn(4, 8).astype(np.float32)
    jf = tt.jit(lambda a: ttorch.softmax(a, -1), device="cpu")
    got_np, got_t = jf(x), jf(torch.from_numpy(x))
    assert isinstance(got_np, torch.Tensor)
    assert tt.cache_misses(jf) == 2  # numpy and torch inputs are guarded apart
    torch.testing.assert_close(got_np, got_t)
    torch.testing.assert_close(got_t, torch.softmax(torch.from_numpy(x), -1))


def test_default_executors_claim_the_kernels_and_dels_free_intermediates():
    _, tcfg, _, tparams, idx = _llama_tiny(T=64)
    tf = tt.jit(lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg), device="cpu")
    tf(tparams, idx, idx)
    src = tt.last_traces(tf)[-1].python()
    assert src.count("flash_scaled_dot_product_attention(") == tcfg.n_layer
    assert src.count("fused_apply_rope(") == 2 * tcfg.n_layer
    assert src.count("fused_cross_entropy(") == 1
    assert "del " in src
    ref = tt.jit(lambda p, i, t: tgpt.loss_fn(p, i, t, tcfg), device="cpu", executors=["torch"])
    ref(tparams, idx, idx)
    assert "flash_" not in tt.last_traces(ref)[-1].python()


def test_del_last_used_deletes_each_intermediate_after_its_last_use():
    jf = tt.jit(lambda a: ttorch.exp(ttorch.sin(a) + 1.0) * 2.0, device="cpu")
    jf(torch.ones(4))
    lines = tt.last_traces(jf)[-1].python().splitlines()
    produced = [m.group(1) for ln in lines if (m := re.match(r"\s+(t\d+) = ", ln))]
    deleted = {n for ln in lines if ln.strip().startswith("del ") for n in re.findall(r"t\d+", ln)}
    # Every intermediate but the returned one is deleted.
    assert set(produced[:-1]) <= deleted


def test_unknown_executor_raises():
    with pytest.raises(RuntimeError, match="Unknown executor"):
        tt.jit(lambda a: a, executors=["nope"], device="cpu")


def test_jit_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.jit(lambda a: a)


def test_port_imports_neither_jax_nor_the_jax_package():
    # Every module of the port, the training path's included.
    code = (
        "import importlib, pkgutil, sys, thunder_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(thunder_tpu_torch.__path__, 'thunder_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'thunder_tpu'))\n"
        "print(len(mods), ','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
    n, bad = out.stdout.split(" ", 1)
    assert int(n) > 30 and bad.strip() == ""


def test_port_sources_have_no_jax_imports():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|thunder_tpu)(\s|\.|$)", re.M)
    files = sorted((REPO / "thunder_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert len(files) > 10 and offenders == []
