"""Single-device pretraining example (reference: examples/lit-gpt/train.py).

The counterpart of ``examples/train.py``: a litgpt-style model in bf16-true,
SGD (lr 6e-4, wd 0.1), synthetic batches, static shapes. The whole step
(forward, backward and the optimizer) is traced and claimed as one program
by ``parallel.build_train_step`` with the default executors (flash, fused,
torch), and on the card staged as one CUDA graph: its first call runs
eagerly, the second captures, later calls replay.

Run (on the card, or on the CPU with ``--device cpu``):
    python -m thunder_tpu_torch.examples.train                        # pythia-160m, 20 iters
    python -m thunder_tpu_torch.examples.train --model open_llama_3b
    python -m thunder_tpu_torch.examples.train --optimizer adamw --lr 3e-4
    python -m thunder_tpu_torch.examples.train --device cpu --model gpt-tiny --seq-len 64

Per-iteration losses go to stderr; the last line of stdout gives the timed
iterations' seconds, ``avg`` seconds an iteration and tokens a second.
Without a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="pythia-160m", help="config name (models/gpt.py registry)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--micro-batch-size", type=int, default=2)
    p.add_argument("--seq-len", type=int, default=None, help="default: the model's block_size")
    p.add_argument("--optimizer", choices=("sgd", "adamw"), default="sgd")
    p.add_argument("--lr", type=float, default=6e-4)
    p.add_argument("--weight-decay", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def synthetic_batch(rng: np.random.RandomState, vocab: int, batch: int, seq: int):
    """Random token ids and their next-token targets (the inputs shifted by
    one), drawn as ``examples/train.py`` draws them."""
    idx = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    tgt = np.roll(idx, -1, axis=1).astype(np.int32)
    return idx, tgt


def to_device(batch, dev):
    import torch

    return tuple(torch.from_numpy(a).to(dev) for a in batch)


def wait(dev) -> None:
    """Block until the card has run everything enqueued on ``dev``."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, params=None, out=None) -> list[float]:
    """Train as ``args`` say and return the timed iterations' losses.
    ``params`` (this package's, on the device) replaces the seeded init,
    e.g. the JAX package's weights through ``models.gpt.params_from_jax``.
    ``out`` collects the step and its timing (``step``, ``extrace``,
    ``seconds``, ``tokens``) for a caller that reads more than the
    losses."""
    import torch

    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.parallel import build_train_step

    dev = devices.resolve_device(args.device)
    config = gpt.name_to_config(args.model)
    seq = args.seq_len or config.block_size
    print(f"model={args.model} layers={config.n_layer} d={config.n_embd} "
          f"B={args.micro_batch_size} T={seq} opt={args.optimizer} device={dev}", file=sys.stderr)

    t0 = time.perf_counter()
    if params is None:
        params = gpt.init_params(config, dtype=torch.bfloat16, seed=args.seed, device=dev)
    print(f"init: {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    rng = np.random.RandomState(args.seed)
    idx, tgt = to_device(synthetic_batch(rng, config.vocab_size, args.micro_batch_size, seq), dev)

    t0 = time.perf_counter()
    step, opt_state, extrace = build_train_step(config, params, idx, tgt, lr=args.lr,
                                                weight_decay=args.weight_decay, optimizer=args.optimizer,
                                                return_extrace=True)
    params, opt_state, loss = step(params, opt_state, idx, tgt)
    print(f"trace+compile+first-step: {time.perf_counter() - t0:.1f}s loss={float(loss):.4f}", file=sys.stderr)

    for _ in range(args.warmup):
        idx, tgt = to_device(synthetic_batch(rng, config.vocab_size, args.micro_batch_size, seq), dev)
        params, opt_state, loss = step(params, opt_state, idx, tgt)
    wait(dev)

    tokens = args.micro_batch_size * seq
    losses = []
    t0 = time.perf_counter()
    prev = None
    for i in range(args.iters):
        idx, tgt = to_device(synthetic_batch(rng, config.vocab_size, args.micro_batch_size, seq), dev)
        params, opt_state, loss = step(params, opt_state, idx, tgt)
        # Log every loss one step late: the host read overlaps the card's work.
        if prev is not None:
            losses.append(float(prev))
            print(f"iter {i - 1}: loss {losses[-1]:.4f}", file=sys.stderr)
        prev = loss
    if prev is not None:
        losses.append(float(prev))
        print(f"iter {args.iters - 1}: loss {losses[-1]:.4f}", file=sys.stderr)
    total = time.perf_counter() - t0
    if out is not None:
        out.update(step=step, extrace=extrace, seconds=total, tokens=tokens * args.iters, params=params)
    print(f"{args.iters} iters: {total:.2f}s  avg {total / max(args.iters, 1):.4f}s/iter  "
          f"{tokens * args.iters / total:,.0f} tok/s")
    return losses


def main(argv=None) -> None:
    losses = run(parse_args(argv))
    assert not losses or np.isfinite(losses[-1]), "loss diverged"


if __name__ == "__main__":
    main()
