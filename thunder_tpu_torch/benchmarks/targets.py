"""Microbenchmark targets: op units × executor matrix, pytest-runnable.

The counterpart of ``thunder_tpu/benchmarks/targets.py`` (reference parity:
thunder/benchmarks/targets.py and the executor-matrix benchmarks of
benchmarks/__init__.py:699-976). Each target compiles its unit through the
full jit pipeline under a named executor list, staged on the card, and
reports the harness's metrics (``benchmarks.run_benchmark``).

The executor lists are the port's seats of the JAX package's ``jax`` and
``pallas`` lists: ``torch`` (the operator executor alone), ``kernels`` (the
default stack: flash, fused, torch), ``norm`` (the opt-in norm executor in
front) and ``quant`` (the int8 linear).

Run as pytest (opt-in: benchmarks are not correctness tests):

    THUNDER_BENCH=1 pytest thunder_tpu_torch/benchmarks/targets.py -q -s

or as a CLI on the card:

    python -m thunder_tpu_torch.benchmarks.targets [--filter sdpa] [--iters 20]
"""

from __future__ import annotations

import json
import os
from functools import partial

import numpy as np

try:  # the CLI path works without test dependencies
    import pytest
except ImportError:  # pragma: no cover
    class _PytestStub:
        class mark:
            @staticmethod
            def parametrize(*a, **k):
                return lambda fn: fn

        @staticmethod
        def skip(msg):
            raise RuntimeError(msg)

    pytest = _PytestStub()


def _enabled() -> bool:
    return bool(os.environ.get("THUNDER_BENCH"))


EXECUTOR_CONFIGS = {
    "torch": ["torch"],
    "kernels": ["flash", "fused", "torch"],
    "norm": ["norm", "flash", "fused", "torch"],
    "quant": ["quant", "torch"],
}


def _rand(*shape, dtype=np.float32, seed=0):
    return (np.random.RandomState(seed + sum(shape)).randn(*shape) * 0.5).astype(dtype)


def _t(x, device, dtype=None):
    import torch

    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return t.to(dtype) if dtype is not None else t


# -- unit definitions: name -> (fn over the port's torch language, example args, FLOP) --


def _unit_gelu(device):
    import thunder_tpu_torch.torch as ltorch

    return lambda a: ltorch.gelu(a), (_t(_rand(4096, 4096), device),), 0


def _unit_softmax(device):
    import thunder_tpu_torch.torch as ltorch

    return lambda a: ltorch.softmax(a, -1), (_t(_rand(256, 8192), device),), 0


def _unit_layer_norm(device):
    import thunder_tpu_torch.torch as ltorch

    x, w, b = (_t(a, device) for a in (_rand(4096, 4096), _rand(4096, seed=1), _rand(4096, seed=2)))
    return lambda a, w, b: ltorch.layer_norm(a, (4096,), w, b), (x, w, b), 0


def _unit_rms_norm(device):
    import thunder_tpu_torch.torch as ltorch

    x, w = _t(_rand(8192, 4096), device), _t(_rand(4096, seed=1), device)
    return lambda a, w: ltorch.rms_norm(a, (4096,), w), (x, w), 0


def _unit_cross_entropy(device):
    import thunder_tpu_torch.torch as ltorch

    logits = _t(_rand(4096, 32000), device)
    tgt = _t(np.random.RandomState(3).randint(0, 32000, (4096,)).astype(np.int64), device)
    return lambda a, t: ltorch.cross_entropy(a, t), (logits, tgt), 0


def _unit_sdpa(device):
    import torch

    import thunder_tpu_torch.torch as ltorch

    B, H, S, D = 4, 16, 2048, 128
    # bf16: the flash executor claims half precision only.
    q, k, v = (_t(_rand(B, H, S, D, seed=i), device, torch.bfloat16) for i in range(3))
    flops = 4.0 * B * H * S * S * D  # 2 matmuls fwd (the JAX package's count)
    return (lambda q, k, v: ltorch.scaled_dot_product_attention(q, k, v, is_causal=True), (q, k, v), flops)


def _unit_linear(device):
    import torch

    import thunder_tpu_torch.torch as ltorch

    x, w = _t(_rand(4096, 4096), device, torch.bfloat16), _t(_rand(4096, 4096, seed=1), device, torch.bfloat16)
    return lambda a, w: ltorch.linear(a, w), (x, w), 2.0 * 4096**3


def _leaves(tree):
    import torch

    from thunder_tpu_torch.core.pytree import tree_flatten

    return [p for p in tree_flatten(tree)[0] if isinstance(p, torch.Tensor)]


def _unit_gpt_block_fwd(device):
    import torch

    from thunder_tpu_torch.models import gpt as m

    cfg = m.name_to_config("pythia-160m")
    params = m.init_params(cfg, dtype=torch.float32, seed=0, device=device)
    idx = _t(np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 512)).astype(np.int64), device)
    n = sum(p.numel() for p in _leaves(params))
    return lambda p, i: m.forward(p, i, cfg), (params, idx), 2.0 * n * 4 * 512


def _block_unit(cfg_name: str, device, *, train: bool, B: int = 1, T: int = 512):
    """One transformer block of a model family with the model's real
    geometry (reference: benchmarks/__init__.py:699-976), forward or
    forward and backward (through ``value_and_grad``)."""
    import torch

    import thunder_tpu_torch.clang as clang
    import thunder_tpu_torch.torch as ltorch
    from thunder_tpu_torch.core import dtypes
    from thunder_tpu_torch.models import gpt as m

    cfg = m.name_to_config(cfg_name)
    full = m.init_params(cfg, dtype=torch.bfloat16, seed=0, device=device)
    p = full["blocks"][0]
    x = _t(_rand(B, T, cfg.n_embd), device)

    def block_fwd(x, p):
        xb = clang.maybe_convert_to_dtype(x, dtypes.bfloat16)
        cos, sin = m._rope_cache(T, cfg, device=xb.device, dtype=xb.dtype)
        out = m._block(xb, p, cos, sin, cfg)
        return ltorch.sum(clang.maybe_convert_to_dtype(out, dtypes.float32) ** 2)

    n = sum(q.numel() for q in _leaves(p))
    fwd_flops = 2.0 * n * B * T + 4.0 * B * cfg.n_head * T * T * cfg.head_size
    if not train:
        return block_fwd, (x, p), fwd_flops

    def block_train(x, p):
        return block_fwd(x, p)

    block_train._needs_grad = True  # run_target compiles it with value_and_grad
    return block_train, (x, p), 3.0 * fwd_flops


def _unit_llama_block_fwd(device):
    return _block_unit("llama-2-7b", device, train=False)


def _unit_llama_block_train(device):
    return _block_unit("llama-2-7b", device, train=True)


def _unit_nanogpt_block_fwd(device):
    # pythia-160m's block is the nanoGPT geometry class: parallel-residual
    # GPT block with LayerNorm and a GELU MLP.
    return _block_unit("pythia-160m", device, train=False)


def _unit_nanogpt_block_train(device):
    return _block_unit("pythia-160m", device, train=True)


UNITS = {
    "gelu": _unit_gelu,
    "softmax": _unit_softmax,
    "layer_norm": _unit_layer_norm,
    "rms_norm": _unit_rms_norm,
    "cross_entropy": _unit_cross_entropy,
    "sdpa": _unit_sdpa,
    "linear": _unit_linear,
    "gpt_block_fwd": _unit_gpt_block_fwd,
    "nanogpt_block_fwd": _unit_nanogpt_block_fwd,
    "nanogpt_block_train": _unit_nanogpt_block_train,
    "llama_block_fwd": _unit_llama_block_fwd,
    "llama_block_train": _unit_llama_block_train,
}


def run_target(unit: str, executor: str, *, iters: int = 10, warmup: int = 2, device: str = "cuda") -> dict:
    """Compile ``unit`` under ``EXECUTOR_CONFIGS[executor]`` on ``device``
    (staged on the card: the warm-up calls run it eagerly and capture it),
    time ``iters`` pipelined calls and return the harness summary."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.benchmarks import run_benchmark

    fn, args, flops = UNITS[unit](device)
    compile_ = tt.value_and_grad if getattr(fn, "_needs_grad", False) else tt.jit
    jfn = compile_(fn, executors=EXECUTOR_CONFIGS[executor], device=device)
    result = run_benchmark(
        f"{unit}[{executor}]",
        partial(jfn, *args),
        device=device,
        warmup=warmup,
        iters=iters,
        flops_per_iter=flops or None,
        pipelined=True,
    )
    return result.summary()


# -- pytest targets (gated: benchmarks are not correctness tests) -------------


@pytest.mark.parametrize("executor", list(EXECUTOR_CONFIGS))
@pytest.mark.parametrize("unit", list(UNITS))
def test_bench(unit, executor):
    if not _enabled():
        pytest.skip("set THUNDER_BENCH=1 to run benchmark targets")
    summary = run_target(unit, executor)
    print(json.dumps(summary))


def main() -> None:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--filter", default="")
    p.add_argument("--executors", default=",".join(EXECUTOR_CONFIGS))
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--format", choices=("jsonl", "table"), default="table",
                   help="table: per-unit × per-executor comparison matrix")
    args = p.parse_args()

    executors = [e for e in args.executors.split(",") if e]
    rows = []
    for unit in UNITS:
        if args.filter and args.filter not in unit:
            continue
        row = {"unit": unit}
        for executor in executors:
            try:
                summary = run_target(unit, executor, iters=args.iters)
            except Exception as e:  # noqa: BLE001 - report and continue the matrix
                summary = {"name": f"{unit}[{executor}]", "error": f"{type(e).__name__}: {e}"}
            if args.format == "jsonl":
                print(json.dumps(summary), flush=True)
            row[executor] = summary
        rows.append(row)

    if args.format != "table":
        return
    # comparison table: time per executor + speedup against the torch column
    headers = ["unit"] + [f"{e} (s)" for e in executors] + [
        f"{e} vs torch" for e in executors if e != "torch"
    ]
    print("  ".join(f"{h:>20s}" for h in headers))
    for row in rows:
        def med(e):
            s = row.get(e, {})
            return s.get("median_iter_time_s", s.get("average_iter_time_s"))

        cells = [f"{row['unit']:>20s}"]
        base = med("torch")
        for e in executors:
            m = med(e)
            cells.append(f"{m:20.5f}" if m is not None else f"{'ERR':>20s}")
        for e in executors:
            if e == "torch":
                continue
            m = med(e)
            cells.append(f"{base / m:19.2f}x" if (m and base) else f"{'-':>20s}")
        print("  ".join(cells), flush=True)


if __name__ == "__main__":
    main()
