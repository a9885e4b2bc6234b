"""Seconds of the CUDA-graph captures of the cell's staged entries, the
compiled-program audit at each capture included: the sum of each entry's
``StagingStats.capture_s``."""

LAYER = "staging"
UNIT = "s"
MOVES = "setup_s"


def read(run):
    s = run.spans.get("capture_s")
    return s if s else None
