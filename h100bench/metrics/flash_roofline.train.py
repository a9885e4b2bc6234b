"""The traced steps' attention bound (``counts.attention_bound_s``, forward
and backward, every layer) over the device time of the flash group's
kernels in the traced window."""

from h100bench import counts

LAYER = "kernels"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(run):
    if run.trace is None or run.peak is None:
        return None
    flash = run.trace.group_seconds(run.groups).get("flash", 0.0)
    if flash <= 0:
        return None
    bound = run.traced * counts.attention_bound_s(run.dims, run.runner.B, run.runner.T, run.peak, backward=True)
    return 100.0 * bound / flash
