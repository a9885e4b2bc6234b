"""Profile the benchmark's training step and write a Chrome-trace directory.

The counterpart of ``scripts/profile_train.py``: ``benchmarks/train.py``'s
open_llama_3b step (B=2, T=2048, bf16-true SGD, the default executors),
staged as one CUDA graph on the card, is profiled for 3 warm steps through
``observability.profile`` (``torch.profiler``), with the program generated
under ``THUNDER_ANNOTATE_TRACES=1`` so each line runs in its
``L<idx>.<sym>#<pass>`` range. A graph replay's kernels carry no range of
their own, so on the card the launch-order map of one eager step
(``attribution.scope_map_of``) is written beside the trace as
``launch_map.json``; ``meta.json`` records the configuration. Read the
directory with ``python -m thunder_tpu_torch.scripts.perf_report --trace-dir
DIR``.

Usage:
    python -m thunder_tpu_torch.scripts.profile_train [outdir] [--layers N] [--model M] [--seq T]
    python -m thunder_tpu_torch.scripts.profile_train --device cpu --model gpt-tiny --layers 1 --seq 64

``--layers`` cuts the model's depth (its widths stay). Without a card and
without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

LAUNCH_MAP = "launch_map.json"
META = "meta.json"
BATCH = 2
STEPS = 3
WARMUP = 2


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("outdir", nargs="?", default=None, help="trace directory (default: a new temporary one)")
    p.add_argument("--model", default="open_llama_3b")
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--layers", type=int, default=None, help="cut the model to N layers (default: all)")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def config_of(model: str, layers=None):
    """The model's config, cut to ``layers`` when given."""
    import dataclasses

    from thunder_tpu_torch.models import gpt

    cfg = gpt.name_to_config(model)
    return dataclasses.replace(cfg, n_layer=layers) if layers else cfg


def run(args) -> dict:
    """Build, warm and profile the step; returns ``profile``'s dict with
    ``meta`` (the configuration and timings) and ``train`` (the built step)."""
    # Before the program is generated: each line in its named range.
    os.environ["THUNDER_ANNOTATE_TRACES"] = "1"
    import tempfile

    from thunder_tpu_torch.benchmarks.train import build_train
    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.observability.attribution import scope_map_of
    from thunder_tpu_torch.observability.profile import profile

    dev = devices.resolve_device(args.device)
    outdir = args.outdir or tempfile.mkdtemp(prefix="prof_train_")
    cfg = config_of(args.model, args.layers)
    t0 = time.perf_counter()
    tr = build_train(cfg, BATCH, args.seq, device=dev)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    float(tr.step())
    print(f"build: {build_s:.1f}s, first step: {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    launch_map = scope_map_of(tr.step_eager) if dev.type == "cuda" else None
    res = profile(tr.step, trace_dir=outdir, steps=STEPS, warmup=WARMUP, launch_map=launch_map)
    meta = {"model": args.model, "batch": BATCH, "seq": args.seq, "layers": cfg.n_layer,
            "steps": STEPS, "device": str(dev), "avg_s": res["avg_s"],
            "launch_map": LAUNCH_MAP if launch_map is not None else None}
    if launch_map is not None:
        with open(os.path.join(outdir, LAUNCH_MAP), "w") as f:
            json.dump(launch_map, f)
    with open(os.path.join(outdir, META), "w") as f:
        json.dump(meta, f)
    print(f"profile written to {res['trace_dir']} (avg step {res['avg_s']:.4f}s, {STEPS} steps, "
          f"{cfg.n_layer} layers)", file=sys.stderr)
    return dict(res, meta=meta, train=tr)


def main(argv=None) -> None:
    res = run(parse_args(argv))
    print(res["trace_dir"])


if __name__ == "__main__":
    main()
