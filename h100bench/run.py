"""Run one cell of the port's benchmark once and print its result line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the ``thunder_tpu_torch`` package, on a machine with the cards the cell
asks for. It exits with a code other than 0, printing no result, when there
is no such card, when the package is missing, or when the process has loaded
JAX or the JAX package by the time the window has closed. The last line of
standard output is the result; the numbers compared and their limits are
also the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "thunder_tpu")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole: ``thunder_tpu_torch`` is not ``thunder_tpu``."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(HERE / ".triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / ".torch_extensions")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    # The script's own folder holds modules named like the standard
    # library's; the checkout's root takes its place on the path.
    sys.path[0] = str(CHECKOUT)

    import torch

    import thunder_tpu_torch  # noqa: F401  (a checkout without the program has no benchmark)
    from h100bench import cells, harness

    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cell = cells.load_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    loaded = forbidden_modules(sys.modules)
    if loaded:
        print(f"the run loaded {loaded}: the benchmark runs the port alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
