"""The median over the window's calls of the host's time from the call to
its return, before the loss is read: guards, bucket selection, the padding
copy into the entry's buffers and the graph's replay enqueued."""

import statistics

LAYER = "entry and dispatch"
UNIT = "us"
MOVES = "score_p95_ms"


def read(run):
    recs = run.window.get("records")
    return statistics.median(r[2] for r in recs) * 1e6 if recs else None
