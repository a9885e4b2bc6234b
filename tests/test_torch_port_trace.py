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
    # Every module of the port, the training path's and the tools' included;
    # nor the JAX side's root scripts (bench.py, scripts/*.py) by their names.
    jax_side = ("jax", "jaxlib", "thunder_tpu", "bench", "scripts",
                *sorted(p.stem for p in (REPO / "scripts").glob("*.py")))
    code = (
        "import importlib, pkgutil, sys, thunder_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(thunder_tpu_torch.__path__, 'thunder_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {jax_side!r})\n"
        "print(len(mods), ','.join(bad))\n"
        "print(','.join(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
    first, mods = out.stdout.splitlines()
    n, bad = first.split(" ", 1)
    assert int(n) > 30 and bad.strip() == ""
    # The nn.Module frontend, the RNG and autocast transforms, the draw
    # kernel's wrapper, the distribution layer, the fleet layer and the
    # compiled-program auditor are among them.
    assert {"thunder_tpu_torch.frontend.module", "thunder_tpu_torch.frontend.dispatch",
            "thunder_tpu_torch.frontend.sharp", "thunder_tpu_torch.transforms.rng",
            "thunder_tpu_torch.transforms.autocast", "thunder_tpu_torch.executors.rngex",
            "thunder_tpu_torch.distributed", "thunder_tpu_torch.distributed.prims",
            "thunder_tpu_torch.distributed.runtime", "thunder_tpu_torch.distributed.checkpoint",
            "thunder_tpu_torch.frontend.batchdim", "thunder_tpu_torch.analysis.collectives",
            "thunder_tpu_torch.analysis.schedule", "thunder_tpu_torch.observability.timeline",
            "thunder_tpu_torch.parallel.mesh", "thunder_tpu_torch.parallel.sharding",
            "thunder_tpu_torch.transforms.comm_schedule", "thunder_tpu_torch.benchmarks.distributed",
            "thunder_tpu_torch.resilience.autopilot", "thunder_tpu_torch.resilience.federation",
            "thunder_tpu_torch.observability.opsplane", "thunder_tpu_torch.analysis.hlo_audit",
            "thunder_tpu_torch.scripts.bench", "thunder_tpu_torch.scripts.bench_attn",
            "thunder_tpu_torch.scripts.bench_multichip", "thunder_tpu_torch.scripts.perf_report"} <= set(mods.split(","))


def test_port_sources_have_no_jax_imports():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|thunder_tpu|bench|scripts|perf_report|lint_traces)(\s|\.|$)",
                         re.M)
    files = sorted((REPO / "thunder_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert len(files) > 10 and offenders == []


def test_introspection_has_the_jax_packages_keys_and_counts():
    """``cache_info``, ``compile_data``, ``compile_stats``,
    ``last_prologue_traces`` and ``last_compile_options`` on the same
    function and calls (``thunder_tpu/api.py:1404``, ``:2310-2338``), the
    hits split alike between the O(1) key lookup and the prologues."""
    import thunder_tpu.torch as jtorch

    jf = thunder_tpu.jit(lambda a: jtorch.sin(a) * 2)
    tf = tt.jit(lambda a: ttorch.sin(a) * 2, device="cpu")
    a, b = np.ones((3, 3), np.float32), np.ones((2, 2), np.float32)
    for x in (a, a, a, b, a):
        jf(x)
        tf(x)
    ji, ti = thunder_tpu.cache_info(jf), tt.cache_info(tf)
    assert set(ti) == set(ji)
    for k in ("cache_option", "calls", "hits", "misses", "compiles", "recompiles", "degradation_level"):
        assert ti[k] == ji[k], k
    assert ti["slow_hits"] + ti["fast_hits"] == ji["slow_hits"] + ji["fast_hits"] == ti["hits"]
    assert (ti["fast_hits"], ti["slow_hits"]) == (ji["fast_hits"], ji["slow_hits"])
    assert len(ti["entries"]) == len(ji["entries"]) == 2
    for te, je in zip(ti["entries"], ji["entries"]):
        assert set(te) == set(je)
        assert (te["index"], te["symbolic"], te["buckets"], te["hits"]) == (je["index"], je["symbolic"],
                                                                           je["buckets"], je["hits"])
    assert ti["trace_seconds"] > 0 and ti["first_run_seconds"] > 0
    assert type(tt.compile_data(tf)).__name__ == type(thunder_tpu.compile_data(jf)).__name__ == "CompileData"
    assert type(tt.compile_stats(tf)).__name__ == type(thunder_tpu.compile_stats(jf)).__name__ == "CompileStats"
    jp, tp = thunder_tpu.last_prologue_traces(jf), tt.last_prologue_traces(tf)
    assert len(tp) == len(jp) == 2 and "(2, 2)" in tp[0].python() and "(2, 2)" in jp[0].python()
    assert tt.last_compile_options(tf) == thunder_tpu.last_compile_options(jf) == {}
