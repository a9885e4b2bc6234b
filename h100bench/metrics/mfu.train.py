"""The training step's model FLOPs (``counts.train_flops``) over the
window's time, as a share of the card's dense bf16 peak."""

LAYER = "train step"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(run):
    w = run.window
    if run.peak is None or not w.get("steps"):
        return None
    return 100.0 * run.runner.flops_per_step() * w["steps"] / w["elapsed_s"] / run.peak["bf16_flops"]
