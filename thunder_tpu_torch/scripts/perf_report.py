#!/usr/bin/env python
"""The per-line attribution report of a profile directory.

The counterpart of ``scripts/perf_report.py``'s attribution mode
(``run_attribution``): the measured device time of a ``torch.profiler``
trace directory (``thunder_tpu_torch.profile()`` of a program generated with
``THUNDER_ANNOTATE_TRACES=1``, e.g. ``scripts/profile_train.py``'s) is
charged to trace lines, ``L<idx>.<sym>#<pass>`` rows, and the share of device
time attributed is printed. A CUDA graph's kernels are placed on their lines
by the launch-order map the profile wrote beside its trace
(``launch_map.json``). With ``--model`` the lines join the static cost model
(``analysis/cost.py``): the training step of ``benchmarks/train.py``, traced
on the CPU, each line beside its roofline bound. The step is the one
profiled, as ``meta.json`` records it (model, batch, seq, layers); a
``--model``, ``--batch`` or ``--seq`` that differs from it is refused (exit
2). A profile without ``meta.json`` joins at the flags (batch 2, seq 16,
the model's whole depth).

Usage:
    python -m thunder_tpu_torch.scripts.perf_report --trace-dir DIR [--steps N] [--top K]
    python -m thunder_tpu_torch.scripts.perf_report --trace-dir DIR --model open_llama_3b [--device h100]

``--steps`` defaults to the profile's own count (``meta.json``), else 1.
``--history`` and ``--gate`` (the committed benchmark series' regression
gate) wait for the port's benchmark PR (ROADMAP): they exit 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from thunder_tpu_torch.scripts.profile_train import LAUNCH_MAP, META, config_of


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def model_costs(model: str, batch: int, seq: int, layers: Optional[int] = None, device: Optional[str] = None):
    """``{pass tag: TraceCost}`` of the training step of
    ``benchmarks/train.py`` for ``model`` at (batch, seq), cut to ``layers``:
    its forward and backward, traced and claimed on the CPU (the claims are
    those of the card) and priced on the ``device`` spec (default h100)."""
    os.environ["THUNDER_ANNOTATE_TRACES"] = "1"
    from thunder_tpu_torch.benchmarks.train import build_train
    from thunder_tpu_torch.observability.attribution import trace_costs

    tr = build_train(config_of(model, layers), batch, seq, device="cpu")
    return trace_costs([tr.fw_trace, tr.bw_trace], device or "h100")


def join_shape(meta: dict, model: str, batch: Optional[int] = None, seq: Optional[int] = None) -> tuple:
    """``(model, batch, seq, layers)`` of the cost join: the profiled step's,
    from its ``meta.json``, where a flag given beside it must agree; without
    one, the flags (batch 2, seq 16, every layer). Raises ``ValueError`` on
    a flag that differs from the profile."""
    if not meta:
        return model, batch or 2, seq or 16, None
    given = {"model": model, "batch": batch, "seq": seq}
    differ = {k: (v, meta[k]) for k, v in given.items() if v is not None and v != meta[k]}
    if differ:
        raise ValueError("the cost join must price the step profiled; meta.json has "
                         + ", ".join(f"{k}={m!r} where the flags give {v!r}" for k, (v, m) in differ.items()))
    return meta["model"], meta["batch"], meta["seq"], meta["layers"]


def attribution_of(trace_dir: str, *, steps: Optional[int] = None, model: Optional[str] = None,
                   batch: Optional[int] = None, seq: Optional[int] = None, device: Optional[str] = None):
    """The ``PerfJoin`` of the profile at ``trace_dir``: attributed per
    line, a graph's kernels placed by the directory's launch-order map,
    joined with the cost of the profiled step when ``model`` is given
    (:func:`join_shape`)."""
    from thunder_tpu_torch.observability.attribution import attribute, join_cost_attribution

    meta_path, map_path = os.path.join(trace_dir, META), os.path.join(trace_dir, LAUNCH_MAP)
    meta = _read_json(meta_path) if os.path.isfile(meta_path) else {}
    shape = join_shape(meta, model, batch, seq) if model else None
    lmap = [tuple(x) for x in _read_json(map_path)] if os.path.isfile(map_path) else None
    attr = attribute(trace_dir, launch_map=lmap)
    cost = model_costs(*shape, device) if shape else None
    return join_cost_attribution(attr, cost, steps=steps or meta.get("steps") or 1)


def run_attribution(trace_dir: str, *, steps: Optional[int] = None, top_k: int = 10, model: Optional[str] = None,
                    batch: Optional[int] = None, seq: Optional[int] = None, device: Optional[str] = None,
                    out=sys.stdout) -> int:
    try:
        join = attribution_of(trace_dir, steps=steps, model=model, batch=batch, seq=seq, device=device)
    except (FileNotFoundError, ValueError) as e:
        print(f"perf_report: {e}", file=sys.stderr)
        return 2
    attr = join.attribution
    print(join.format(top_k), file=out)
    print(f"\nperf_report: {attr.coverage * 100:.1f}% of device time attributed to {len(attr.by_line)} trace lines"
          + (f"; graph kernels {attr.graph_placed} of {attr.graph_ops} placed" if attr.graph_ops else ""),
          file=out)
    if attr.coverage < 0.9 and attr.device_busy_us:
        print("perf_report: profile a program generated with THUNDER_ANNOTATE_TRACES=1, and a staged step with "
              "its launch-order map", file=out)
    return 0


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(prog="perf_report", description="Profile attribution reports")
    p.add_argument("--history", nargs="+", metavar="BENCH.json",
                   help="committed benchmark rounds (waits for the port's benchmark PR)")
    p.add_argument("--gate", action="store_true", help="the regression gate (waits for the port's benchmark PR)")
    p.add_argument("--trace-dir", default=None, help="profile dir (or one Chrome-trace JSON) to attribute")
    p.add_argument("--steps", type=int, default=None, help="steps the profile bracketed (default: meta.json's, else 1)")
    p.add_argument("--top", type=int, default=10, help="rows in the top-k table")
    p.add_argument("--device", default=None, help="device spec of the cost model (default h100)")
    p.add_argument("--model", default=None, help="GPT config name to build the cost model from (e.g. gpt-tiny)")
    p.add_argument("--batch", type=int, default=None, help="default: meta.json's, else 2")
    p.add_argument("--seq", type=int, default=None, help="default: meta.json's, else 16")
    args = p.parse_args(argv)

    if args.history or args.gate:
        print("perf_report --history/--gate: waits for the port's benchmark PR (ROADMAP)")
        return 2
    if args.trace_dir:
        return run_attribution(args.trace_dir, steps=args.steps, top_k=args.top, model=args.model,
                               batch=args.batch, seq=args.seq, device=args.device)
    p.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
