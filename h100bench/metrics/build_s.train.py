"""Seconds ``parallel.build_train_step`` took to trace, differentiate and
claim the training step, by the host clock around the call. The step is
built outside ``jit``, so the program's compile counter does not see it."""

LAYER = "transforms and passes"
UNIT = "s"
MOVES = "setup_s"


def read(run):
    return run.spans.get("build_s")
