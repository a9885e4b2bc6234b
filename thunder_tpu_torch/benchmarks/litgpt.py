"""LitGPT-style end-to-end training benchmark CLI.

The counterpart of ``thunder_tpu/benchmarks/litgpt.py``: a model name ×
batch × sequence training benchmark (``parallel.build_train_step``: one
joint fw+bw program, then AdamW or SGD, staged whole as a CUDA graph on the
card, as the JAX package stages it under ``jax.jit``) reporting iteration
time, tokens per second, model TFLOP/s and MFU against the card's peak, and
peak device memory; plus the executor-matrix comparison, whose columns are executor
stacks (torch only → +flash → +fused → +norm).

    python -m thunder_tpu_torch.benchmarks.litgpt --model pythia-410m \\
        --micro-batch 2 --seq 2048 --iters 5 [--forward-only] [--optimizer sgd]

    # the executor matrix as a markdown table:
    python -m thunder_tpu_torch.benchmarks.litgpt --model pythia-410m --matrix \\
        --micro-batch 2 --seq 2048 --iters 5 --markdown

``--device cpu`` runs on the CPU (the kernels' plain versions; no device
metric). The mesh flags (``--dp``/``--fsdp``/``--tp`` above 1) build
``make_mesh``, ``gpt_param_specs`` and this rank's blocks
(``shard_pytree``), then the sharded step, as
``thunder_tpu/benchmarks/litgpt.py`` does. Each rank runs the CLI as a
process of its own, joined by ``distributed.init()`` from the usual
``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` environment (gloo
with ``--device cpu``, NCCL on the card); every rank gets the same batch,
and rank 0 prints the JSON line (``benchmarks/distributed.py`` spawns the
ranks). With ``WORLD_SIZE`` set the CLI takes this path at a mesh of one
too, and the line's ``process_group`` names the group's backend and size.
A stack that fails fails the run.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

# Executor stacks for --matrix, from the torch executor alone to the full
# stack. "flash,fused,torch" is api.DEFAULT_EXECUTORS; norm and quant are opt-in.
MATRIX_STACKS: tuple[tuple[str, str], ...] = (
    ("torch", "torch"),
    ("+flash", "flash,torch"),
    ("+fused (default)", "flash,fused,torch"),
    ("+norm", "norm,flash,fused,torch"),
    ("+quant int8", "quant,flash,fused,torch"),
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="pythia-160m")
    p.add_argument("--micro-batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--forward-only", action="store_true")
    p.add_argument("--pipelined", action="store_true",
                   help="dispatch every timed iteration, then wait once")
    p.add_argument("--optimizer", default="adamw", choices=("adamw", "sgd"))
    p.add_argument("--executors", default="", help="comma list in priority order, e.g. norm,flash,fused,torch")
    p.add_argument("--matrix", action="store_true", help="run the executor-stack comparison matrix")
    p.add_argument("--markdown", action="store_true", help="emit a markdown table (with --matrix)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


@dataclass
class Prepared:
    """One configuration, built and ready to time: ``fn`` runs one
    iteration. For training, ``params``/``opt`` hold the state that each
    iteration replaces (or updates in place) and ``losses`` the loss of
    each iteration; ``step`` is ``build_train_step``'s step function and
    ``mesh`` its mesh (None for the one-device step)."""

    name: str
    fn: Callable[[], Any]
    device: Any
    extrace: Any
    tokens: int
    flops: float
    n_params: int
    idx: Any
    tgt: Any
    params: dict
    step: Optional[Callable] = None
    opt: Optional[dict] = None
    losses: list = field(default_factory=list)
    mesh: Any = None


def prepare(args, executors: Optional[str] = None) -> Prepared:
    """Build one configuration: random weights from seed 0, token ids from
    seed 0 and their shift by one as targets, then the claimed forward
    (``--forward-only``) or training step."""
    import torch

    from thunder_tpu_torch.benchmarks import count_params, forward_flops_per_token, training_flops_per_token
    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.models import gpt as m

    cfg = m.name_to_config(args.model)
    seq = min(args.seq, cfg.block_size)
    mesh = specs = None
    if args.dp * args.fsdp * args.tp > 1 or "WORLD_SIZE" in os.environ:
        import thunder_tpu_torch.distributed as td
        from thunder_tpu_torch.parallel import gpt_param_specs, make_mesh

        if not td.is_initialized() and "WORLD_SIZE" in os.environ:
            td.init(device=args.device)
        mesh = make_mesh(dp=args.dp, fsdp=args.fsdp, tp=args.tp)
        specs = gpt_param_specs(cfg, mesh)
    dev = devices.resolve_device(args.device)
    params = m.init_params(cfg, dtype=getattr(torch, args.dtype), seed=0, device=dev)
    n_params = count_params(params)
    if mesh is not None:
        from thunder_tpu_torch.parallel import shard_pytree

        params = shard_pytree(params, mesh, specs)
    idx_np = np.random.RandomState(0).randint(0, cfg.vocab_size, (args.micro_batch, seq))
    idx = torch.from_numpy(idx_np).to(dev)
    tgt = torch.from_numpy(np.roll(idx_np, -1, axis=1)).to(dev)
    tokens = args.micro_batch * seq
    ex_list = [e for e in (executors or "").split(",") if e] or None

    if args.forward_only:
        if mesh is not None:
            raise NotImplementedError("--forward-only runs on one device: the mesh flags train")
        from thunder_tpu_torch import api
        from thunder_tpu_torch.core.pytree import tree_flatten
        from thunder_tpu_torch.executors import staging
        from thunder_tpu_torch.executors.passes import del_last_used, transform_for_execution
        from thunder_tpu_torch.extend import resolve_executors
        from thunder_tpu_torch.transforms.common import dce

        with devices.default_device(dev):
            _, comp = api.trace_program(lambda p, i: m.forward(p, i, cfg), (params, idx), {})
            ex = resolve_executors(ex_list) if ex_list else api.DEFAULT_EXECUTORS
            extrace = del_last_used(transform_for_execution(dce(comp), ex))
        fwd, _ = staging.stage(extrace.python_callable(), [extrace], dev, name="forward")
        flat = tree_flatten(params)[0] + [idx]
        return Prepared(name=f"{args.model}-fwd", fn=torch.no_grad()(lambda: fwd(*flat)), device=dev,
                        extrace=extrace, tokens=tokens, flops=forward_flops_per_token(n_params) * tokens,
                        n_params=n_params, idx=idx, tgt=tgt, params=params)

    from thunder_tpu_torch.parallel import build_train_step

    step, opt, extrace = build_train_step(
        cfg, params, idx, tgt, mesh=mesh, param_specs=specs, lr=args.lr, donate=(args.optimizer == "sgd"),
        grads_in_f32=(args.optimizer != "sgd"), executors=ex_list, optimizer=args.optimizer, return_extrace=True,
    )
    run = Prepared(name=f"{args.model}-train", fn=lambda: None, device=dev, extrace=extrace, tokens=tokens,
                   flops=training_flops_per_token(n_params) * tokens, n_params=n_params, idx=idx, tgt=tgt,
                   params=params, step=step, opt=opt, mesh=mesh)

    def one_step():
        run.params, run.opt, loss = step(run.params, run.opt, idx, tgt)
        run.losses.append(loss)
        return loss

    run.fn = one_step
    return run


def run_one(args, executors: Optional[str] = None, prepared: Optional[Prepared] = None) -> dict:
    """One benchmark configuration → summary dict. ``prepared`` is what
    :func:`prepare` built for these ``args`` and ``executors`` (built here
    when not given)."""
    from thunder_tpu_torch.benchmarks import run_benchmark

    run = prepared if prepared is not None else prepare(args, executors)
    result = run_benchmark(run.name, run.fn, device=run.device, warmup=args.warmup, iters=args.iters,
                           tokens_per_iter=run.tokens, flops_per_iter=run.flops, pipelined=args.pipelined)
    summary = result.summary()
    if run.losses:
        summary["loss_first"] = round(float(run.losses[0]), 4)
        summary["loss_last"] = round(float(run.losses[-1]), 4)
    if executors:
        summary["executors"] = executors
    summary["n_params"] = run.n_params
    summary["mesh"] = {"dp": args.dp, "fsdp": args.fsdp, "tp": args.tp}
    if run.mesh is not None:
        import torch.distributed as dist

        summary["process_group"] = ({"backend": dist.get_backend(), "world": dist.get_world_size()}
                                    if dist.is_initialized() else None)
    return summary


def _matrix_markdown(args, rows) -> str:
    from thunder_tpu_torch.benchmarks import device_name

    mode = "fwd" if args.forward_only else "train"
    lines = [
        f"### {args.model} {mode} — B={args.micro_batch} T={args.seq} dtype={args.dtype} iters={args.iters} "
        f"optimizer={args.optimizer} ({device_name(args.device)})",
        "",
        "| executors | avg iter (s) | median (s) | tokens/s | TFLOP/s | MFU | mem (GB) | loss (first→last) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for label, s in rows:
        loss = f"{s['loss_first']}→{s['loss_last']}" if "loss_first" in s else "—"
        lines.append(
            f"| {label} | {s.get('average_iter_time_s', '—')} | {s.get('median_iter_time_s', '—')} "
            f"| {s.get('tokens_per_sec', '—')} | {s.get('model_tflop_per_sec', '—')} "
            f"| {s.get('mfu', '—')} | {s.get('memory_used_GB', '—')} | {loss} |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    args = parse_args(argv)
    if not args.matrix:
        import torch.distributed as dist

        started = not dist.is_initialized()
        summary = run_one(args, args.executors or None)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(json.dumps(summary))
        if started and dist.is_initialized():
            import thunder_tpu_torch.distributed as td

            td.shutdown()
        return

    rows = []
    for label, stack in MATRIX_STACKS:
        summary = run_one(args, stack)
        gc.collect()  # each iteration closes over its Prepared: free its tensors before the next stack
        rows.append((label, summary))
        print(f"# {label}: {json.dumps(summary)}", file=sys.stderr)
    print(_matrix_markdown(args, rows) if args.markdown else json.dumps(dict(rows)))


if __name__ == "__main__":
    main()
