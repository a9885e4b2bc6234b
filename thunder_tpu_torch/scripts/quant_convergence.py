"""Long-horizon quantized-training evidence: the int8 stack against bf16.

The counterpart of ``scripts/quant_convergence.py``. Trains pythia-160m for
N iterations three ways, on the same fixed data:

- ``bf16``: the default executors (flash, fused, torch);
- ``int8_all``: every forward linear through the int8 linear
  (``["quant", "fused", "flash", "torch"]``, the seats of the JAX
  package's ``["quant", "pallas", "flash", "jax"]``);
- ``int8_skip_lm_head``: the same stack under
  ``QuantRecipe(skip_out_features=(padded_vocab_size,))``, which keeps the
  lm_head in bf16 (the TE skip_modules recipe).

Each variant starts from bf16 weights ``init_params(seed=0)`` and trains
with AdamW (lr 3e-4, weight decay 0.1) on 8 fixed batches drawn from
``np.random.RandomState(0)``, cycled, targets the inputs rolled by one. A
small fixed dataset is learned (memorized), so the curves separate when the
quantized numerics hurt optimization. Losses are read one step late, so
the host read overlaps the card's work. The loss curves and s/iter go to a
JSON file; the last stdout line summarizes them.

Run (on the card, or on the CPU with ``--device cpu``):
    python -m thunder_tpu_torch.scripts.quant_convergence [iters] [out.json] [--device cuda|cpu]

Without a card and without ``--device cpu`` it raises. A smaller run is
``run()`` called with ``model``, ``batch`` and ``seq``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

MODEL = "pythia-160m"
B, T = 4, 1024
ITERS = 200
LR, WD = 3e-4, 0.1
N_BATCHES = 8
INT8_STACK = ["quant", "fused", "flash", "torch"]
HORIZONS = (10, 50, 100)


def make_batches(vocab_size: int, batch: int, seq: int) -> list:
    """The fixed dataset: ``N_BATCHES`` (batch, seq) int32 id arrays from
    ``RandomState(0)``, the same for every variant."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab_size, (batch, seq)).astype(np.int32) for _ in range(N_BATCHES)]


def run(tag: str, executors, skip_out=(), *, model: str = MODEL, batch: int = B, seq: int = T,
        iters: int = ITERS, params=None, device=None) -> dict:
    """Train one variant and return ``{"losses", "iters", "avg_iter_s"}``.
    ``executors`` None is the default stack; ``skip_out`` the output widths
    the int8 linear leaves alone. ``params`` (this package's, on the device;
    copied, never updated) replaces ``init_params(seed=0)``, e.g. the JAX
    package's weights through ``models.gpt.params_from_jax``. The recipe is
    installed for this variant's trace and the default restored after,
    also on an error."""
    import torch

    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.core.pytree import tree_map
    from thunder_tpu_torch.executors.quantex import QuantRecipe, set_recipe
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.parallel import build_train_step

    dev = devices.resolve_device(device)
    cfg = gpt.name_to_config(model)
    if params is None:
        params = gpt.init_params(cfg, dtype=torch.bfloat16, seed=0, device=dev)
    else:
        params = tree_map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x, params)
    batches = [torch.from_numpy(b).to(dev) for b in make_batches(cfg.vocab_size, batch, seq)]
    targets = [torch.roll(b, -1, dims=1) for b in batches]

    set_recipe(QuantRecipe(skip_out_features=tuple(skip_out)))
    try:
        step, opt = build_train_step(cfg, params, batches[0], targets[0], lr=LR, weight_decay=WD,
                                     optimizer="adamw", executors=executors)
        params, opt, loss = step(params, opt, batches[0], targets[0])
        losses = [float(loss)]

        t0 = time.perf_counter()
        prev = None
        for i in range(iters - 1):
            k = (i + 1) % N_BATCHES
            params, opt, loss = step(params, opt, batches[k], targets[k])
            if prev is not None:
                losses.append(float(prev))
            prev = loss
        if prev is not None:
            losses.append(float(prev))
        dt = time.perf_counter() - t0
    finally:
        set_recipe(QuantRecipe())
    avg = dt / max(iters - 1, 1)
    print(f"# {tag}: {iters} iters {dt:.1f}s avg {avg:.4f}s/iter loss {losses[0]:.3f}->{losses[-1]:.3f}",
          file=sys.stderr)
    return {"losses": losses, "iters": iters, "avg_iter_s": round(avg, 4)}


def loss_gaps(variant: dict, bf16: dict, iters: int) -> dict:
    """The variant's loss minus bf16's at 10, 50, 100 and ``iters``
    iterations (those within the run)."""
    return {str(h): round(variant["losses"][h - 1] - bf16["losses"][h - 1], 4)
            for h in (*HORIZONS, iters) if h <= iters}


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="quant_convergence", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("iters", nargs="?", type=int, default=ITERS)
    p.add_argument("out", nargs="?", default=os.path.join(tempfile.gettempdir(), "quant_convergence.json"))
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from thunder_tpu_torch.models import gpt

    args = parse_args(argv)
    size = dict(model=MODEL, batch=B, seq=T, iters=args.iters, device=args.device)
    vocab_padded = gpt.name_to_config(MODEL).padded_vocab_size
    results = {
        "model": MODEL, "batch": B, "seq": T,
        "bf16": run("bf16", None, **size),
        "int8_all": run("int8_all", INT8_STACK, **size),
        "int8_skip_lm_head": run("int8_skip_lm_head", INT8_STACK, skip_out=(vocab_padded,), **size),
    }
    for k in ("int8_all", "int8_skip_lm_head"):
        results[k]["loss_gap_vs_bf16"] = loss_gaps(results[k], results["bf16"], args.iters)
    with open(args.out, "w") as f:
        json.dump(results, f)
    print(json.dumps({k: v for k, v in results.items() if not isinstance(v, dict)}
                     | {k: {"final_loss": v["losses"][-1], "avg_iter_s": v["avg_iter_s"],
                            "gap": v.get("loss_gap_vs_bf16")}
                        for k, v in results.items() if isinstance(v, dict)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
