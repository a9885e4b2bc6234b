"""The forward FLOPs of the window's true tokens (``counts.forward_flops``
at each call's exact length) over the window's time, as a share of the
card's dense bf16 peak."""

from h100bench import counts

LAYER = "model step"
UNIT = "%"
MOVES = "score_tokens_per_s"


def read(run):
    recs = run.window.get("records")
    if run.peak is None or not recs:
        return None
    flops = sum(counts.forward_flops(run.dims, run.runner.B, r[0]) for r in recs)
    return 100.0 * flops / run.window["elapsed_s"] / run.peak["bf16_flops"]
