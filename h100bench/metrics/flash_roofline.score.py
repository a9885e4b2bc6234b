"""The traced calls' attention bound at their exact lengths
(``counts.attention_bound_s``, forward, every layer) over the device time of
the flash group's kernels in the traced window."""

from h100bench import counts

LAYER = "kernels"
UNIT = "%"
MOVES = "score_tokens_per_s"


def read(run):
    if run.trace is None or run.peak is None:
        return None
    flash = run.trace.group_seconds(run.groups).get("flash", 0.0)
    if flash <= 0:
        return None
    bound = sum(counts.attention_bound_s(run.dims, run.runner.B, T, run.peak, backward=False) for T in run.traced)
    return 100.0 * bound / flash
