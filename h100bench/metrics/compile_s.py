"""Seconds the program spent compiling the cell's entries: the sum of its
``thunder_tpu_compile_ms`` over every entry the run compiled (trace,
transforms, claiming and staging set-up; a capture is ``capture_s``'s)."""

LAYER = "transforms and passes"
UNIT = "s"
MOVES = "setup_s"


def read(run):
    s = run.counters.get("setup", {}).get("thunder_tpu_compile_ms")
    return s["sum"] / 1e3 if s else None
