"""Sharded pretraining example (reference: examples/lit-gpt/train_fsdp.py).

The counterpart of ``examples/train_fsdp.py``: a device mesh and
PartitionSpecs (``parallel.make_mesh``, ``gpt_param_specs``): params are
dim-0 sharded over the ``fsdp`` axis (and Megatron-split over ``tp``), the
batch is split over ``dp`` x ``fsdp``, and the step's collectives are spelled
in its trace. AdamW's moments take the params' specs (ZeRO-sharded).

One process a rank, joined through ``distributed.init`` from the torchrun
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK``): NCCL on the card, gloo with ``--device cpu``. The mesh's
size is the world's. Rank 0 prints.

Run on the cards (one rank a card):
    torchrun --nproc-per-node 8 -m thunder_tpu_torch.examples.train_fsdp --mesh fsdp=8
    python -m thunder_tpu_torch.examples.train_fsdp --mesh fsdp=1     # one card, no group

Run on the CPU (4 gloo ranks):
    for r in 0 1 2 3; do RANK=$r WORLD_SIZE=4 MASTER_ADDR=localhost MASTER_PORT=29512 \\
        python -m thunder_tpu_torch.examples.train_fsdp --device cpu --mesh fsdp=2,tp=2 \\
        --model llama-tiny --iters 3 --seq-len 64 & done; wait
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def parse_mesh(spec: str) -> dict:
    axes = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        axes[name.strip()] = int(size)
    return axes


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="pythia-160m")
    p.add_argument("--mesh", default="fsdp=8", help='e.g. "fsdp=8" or "dp=2,fsdp=2,tp=2"')
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--global-batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--optimizer", choices=("sgd", "adamw"), default="adamw")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight-decay", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def run(args, params=None) -> list[float]:
    """Train on the mesh as ``args`` say and return the timed iterations'
    losses (the global batch's, the same on every rank). ``params`` are the
    whole params on the device (default: the seeded init); each rank keeps
    its blocks. Joins the process group from the environment when
    ``WORLD_SIZE`` is set and none is live."""
    import torch

    import thunder_tpu_torch.distributed as td
    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.examples.train import synthetic_batch, to_device, wait
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.parallel import build_train_step, gpt_param_specs, make_mesh, shard_pytree

    if "WORLD_SIZE" in os.environ and not td.is_initialized():
        td.init(device=args.device)
    dev = devices.resolve_device(args.device)
    rank0 = not td.is_initialized() or torch.distributed.get_rank() == 0
    config = gpt.name_to_config(args.model)
    seq = args.seq_len or config.block_size
    mesh = make_mesh(**parse_mesh(args.mesh))
    if rank0:
        print(f"mesh={dict(zip(mesh.axis_names, mesh.devices.shape))} model={args.model} "
              f"B={args.global_batch_size} T={seq} device={dev}", file=sys.stderr)

    if params is None:
        params = gpt.init_params(config, dtype=torch.bfloat16, seed=args.seed, device=dev)
    specs = gpt_param_specs(config, mesh)
    params = shard_pytree(params, mesh, specs)

    rng = np.random.RandomState(args.seed)

    def batch():
        return to_device(synthetic_batch(rng, config.vocab_size, args.global_batch_size, seq), dev)

    idx, tgt = batch()
    t0 = time.perf_counter()
    step, opt_state = build_train_step(config, params, idx, tgt, mesh=mesh, param_specs=specs, lr=args.lr,
                                       weight_decay=args.weight_decay, optimizer=args.optimizer)
    params, opt_state, loss = step(params, opt_state, idx, tgt)
    if rank0:
        print(f"trace+compile+first-step: {time.perf_counter() - t0:.1f}s loss={float(loss):.4f}",
              file=sys.stderr)

    losses = []
    t0 = time.perf_counter()
    prev = None
    for i in range(args.iters):
        idx, tgt = batch()
        params, opt_state, loss = step(params, opt_state, idx, tgt)
        if prev is not None:
            losses.append(float(prev))
            if rank0:
                print(f"iter {i - 1}: loss {losses[-1]:.4f}", file=sys.stderr)
        prev = loss
    if prev is not None:
        losses.append(float(prev))
        if rank0:
            print(f"iter {args.iters - 1}: loss {losses[-1]:.4f}", file=sys.stderr)
    wait(dev)
    total = time.perf_counter() - t0
    tokens = args.global_batch_size * seq
    if rank0:
        print(f"{args.iters} iters: {total:.2f}s  avg {total / max(args.iters, 1):.4f}s/iter  "
              f"{tokens * args.iters / total:,.0f} tok/s")
    return losses


def main(argv=None) -> None:
    import thunder_tpu_torch.distributed as td

    started = not td.is_initialized()
    try:
        losses = run(parse_args(argv))
    finally:
        if started and td.is_initialized():
            td.shutdown()
    assert not losses or np.isfinite(losses[-1]), "loss diverged"


if __name__ == "__main__":
    main()
