"""The share of the traced window's kernel time in kernels that no group of
``kernels/`` claims: the decomposed elementwise work, copies, the optimizer."""

LAYER = "executors"
UNIT = "%"
MOVES = "score_tokens_per_s"


def read(run):
    if run.trace is None:
        return None
    by_group = run.trace.group_seconds(run.groups)
    total = sum(by_group.values())
    return 100.0 * by_group["other"] / total if total > 0 else None
