"""The readings a cell's limits are set from, at the cell's own size, and the
faults a cell's check has to catch.

    python3 h100bench/control.py --workload <cell> --seeds 11,12,13 \\
        --what sound,control,half_batch [--seconds 4]

For each ``what`` and seed it runs the cell's set-up and its check against
the reference, and prints one JSON line with each number compared:

- ``sound``: the program as the benchmark runs it;
- ``control``: the program's own int8 path (the ``quant`` executor ahead of
  the default stack), the precision below the configuration's bfloat16;
- a fault planted in the program's place (:data:`FAULTS`).

A training cell needs no window: its checked steps are its set-up. A score
cell's calls come from a window of ``--seconds`` at its own load. The
benchmark's own runs never run this; it needs the card.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":  # the checkout's root, not this folder, heads the path
    sys.path[0] = str(CHECKOUT)

import torch  # noqa: E402

from h100bench.runners import score, train  # noqa: E402

QUANT_STACK = ["quant", "flash", "fused", "torch"]


class TrainHalfBatch(train.Runner):
    """A step whose loss and update are over the first half of the rows."""

    def _build(self) -> None:
        self.build_on(self.idx[: self.B // 2], self.tgt[: self.B // 2])

    def one_step(self):
        self.feed(self.k)
        self.k += 1
        h = self.B // 2
        self.params, self.opt, loss = self.step(self.params, self.opt, self.idx[:h], self.tgt[:h])
        return loss


class TrainUnchanged(train.Runner):
    """A step that returns its loss and leaves its state as it was."""

    def one_step(self):
        from thunder_tpu_torch.core.pytree import tree_flatten

        self.feed(self.k)
        self.k += 1
        return self.step.loss_and_grads(*tree_flatten(self.params)[0], self.idx, self.tgt)[0]


class ScoreHalfBatch(score.Runner):
    """A call that scores the first half of its rows and answers the rest
    with their mean."""

    def call(self, idx, tgt):
        return self.entry(self.params, idx[: self.B // 2], tgt[: self.B // 2])

    def answer(self, losses, T):
        half = losses[:, :T].float().cpu()
        return torch.cat([half, half.mean(0, keepdim=True).expand(self.B - half.shape[0], -1)])


class ScoreStaleAnswer(score.Runner):
    """A call that answers with the call before it's answers."""

    previous = None

    def answer(self, losses, T):
        values = losses[:, :T].float().cpu()
        out, self.previous = (self.previous if self.previous is not None else values), values
        return out


class ScoreRowsReversed(score.Runner):
    """A call whose answers come back in the wrong rows: the mean of the
    call is right, each row's answers are another row's."""

    def answer(self, losses, T):
        return losses[:, :T].float().cpu().flip(0)


FAULTS = {
    "train": {"half_batch": TrainHalfBatch, "unchanged": TrainUnchanged},
    "score": {"half_batch": ScoreHalfBatch, "stale_answer": ScoreStaleAnswer, "rows_reversed": ScoreRowsReversed},
}


def runner_for(kind: str, what: str):
    """What makes the runner of ``what`` for a mix of ``kind``."""
    from h100bench import harness

    if what == "sound":
        return harness.runner_class(kind)
    if what == "control":
        return functools.partial(harness.runner_class(kind), executors=QUANT_STACK)
    return FAULTS[kind][what]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="sound,control")
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)

    from h100bench import cells

    if not torch.cuda.is_available():
        print("control.py reads the program on the card", file=sys.stderr)
        return 2
    cell = cells.load_cell(json.loads((CHECKOUT / "BENCHMARK.json").read_text()), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    kind = cell.traffic["kind"]
    for what in args.what.split(","):
        drv = None  # a score cell's entry is made once per ``what`` and reused over the seeds
        for seed in seeds:
            t0 = time.perf_counter()
            if kind == "score":
                if drv is None:
                    drv = runner_for(kind, what)(cell, "cuda:0")
                    drv.load(seed)
                    drv.setup()
                else:
                    drv.load(seed)
                checks = drv.reference({}, drv.window(args.seconds))
            else:
                drv = runner_for(kind, what)(cell, "cuda:0")
                drv.load(seed)
                readings = drv.setup()
                drv.release()
                checks = drv.reference(readings, {})
            detail = checks.pop("_detail")
            print(json.dumps({"workload": cell.name, "what": what, "seed": seed, "checks": checks,
                              "detail": detail, "seconds": time.perf_counter() - t0}), flush=True)
        if drv is not None:
            drv.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
