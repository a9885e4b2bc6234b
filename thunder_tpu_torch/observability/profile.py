"""Profiler bracketing: ``thunder_tpu_torch.profile(fn, *args)``.

The counterpart of ``thunder_tpu/observability/profile.py``: runs a
(compiled or plain) callable for ``steps`` calls under
``torch.profiler.profile``, CPU and CUDA activities, one
``record_function`` range a step (``<step_name>#<i>``), and writes a Chrome
trace (``export_chrome_trace``) into ``trace_dir``. With annotated codegen
(``THUNDER_ANNOTATE_TRACES=1`` when the program is generated; see
``core/trace.py``) every generated line runs in a range named after it, so
``observability/attribution.py`` charges the trace's kernels back to trace
lines.

No degraded mode on the card: the JAX package falls back to wall-clock
timing when its backend has no profiler plugin; here a profiled call that
ran on CUDA and left no kernel event in the trace raises (and counts
``thunder_tpu_profile_captures_total{ok="false"}``). On the CPU the trace
holds host ops, which attribution charges by self time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Optional

from thunder_tpu_torch.observability.events import emit_event


def _on_cuda(tree: Any) -> bool:
    import torch

    from thunder_tpu_torch.core.pytree import tree_flatten

    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in tree_flatten(tree)[0])


def _sync() -> None:
    """Wait for the device work of the calls, so the profiled region holds it."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# The range of the work a session does before the block, which attribution
# leaves out (observability/attribution.py).
LEAD_IN = "thunder_profile_lead_in"


@contextlib.contextmanager
def traced(trace_path: str, *, record_shapes: bool = False):
    """One ``torch.profiler`` session around the block, CPU and (with a card)
    CUDA activities, written to ``trace_path`` as a Chrome trace (with each
    op's input shapes and types when ``record_shapes``). The
    session opens with a lead-in, in a range (``LEAD_IN``) that attribution
    leaves out: on the card a 20 ms sleep kernel and 1024 small kernels,
    then a synchronize. On an NVIDIA H100 80GB HBM3 (700 W), after many
    earlier sessions in one process, a session's first 16-100 kernel
    records went missing (the first step of a window kept fewer than its
    later ones; a discarded warm-up cycle of the profiler's ``schedule`` did
    not stop it; PERF.md), so the lead-in's kernels take that place and the
    block's are kept."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=activities, record_shapes=record_shapes) as prof:
        with record_function(LEAD_IN):
            if cuda:
                torch.cuda._sleep(int(20e-3 * 2e9))  # cycles; the H100 clocks below 2 GHz
                x = torch.zeros(1, device="cuda")
                for _ in range(1024):
                    x.add_(1)
            _sync()
        yield
        _sync()
    prof.export_chrome_trace(trace_path)


def profile(
    fn: Callable,
    *args,
    trace_dir: Optional[str] = None,
    steps: int = 3,
    warmup: int = 1,
    step_name: str = "thunder_step",
    launch_map: Optional[list] = None,
    **kwargs,
) -> dict:
    """Run ``warmup`` unprofiled calls of ``fn(*args, **kwargs)``, then
    ``steps`` calls under ``torch.profiler``, and write the Chrome trace into
    ``trace_dir`` (a new temporary directory when None).

    Returns ``{"trace_dir", "steps", "avg_s", "total_s", "profiler",
    "attribution"}``: the JAX package's dict. ``profiler`` is True (the port
    has no wall-clock-only mode). ``attribution`` is the
    :class:`~thunder_tpu_torch.observability.attribution.Attribution` of the
    trace when some time landed on a trace line, else None; a staged (CUDA
    graph) program's kernels need ``launch_map``
    (:func:`~thunder_tpu_torch.observability.attribution.scope_map_of` of
    its eager program). Join it with the cost model via
    ``thunder_tpu_torch.monitor.attribution_report``."""
    from torch.profiler import record_function

    from thunder_tpu_torch.observability import metrics as obsm
    from thunder_tpu_torch.observability.attribution import attribute

    if trace_dir is None:
        import tempfile

        trace_dir = tempfile.mkdtemp(prefix="thunder_tpu_torch_prof_")
    else:
        os.makedirs(trace_dir, exist_ok=True)

    for _ in range(max(0, warmup)):
        fn(*args, **kwargs)
    _sync()

    emit_event("profile_start", dir=trace_dir, steps=steps)
    out = None
    with traced(os.path.join(trace_dir, f"{step_name}.trace.json")):
        t0 = time.perf_counter()
        for i in range(steps):
            with record_function(f"{step_name}#{i}"):
                out = fn(*args, **kwargs)
        _sync()
        total = time.perf_counter() - t0
    attr = attribute(trace_dir, launch_map=launch_map)
    if attr.mode != "cuda" and _on_cuda((args, kwargs, out)):
        obsm.PROFILE_CAPTURES.inc_always(ok="false")
        raise RuntimeError(
            f"profile: {steps} profiled call(s) of {getattr(fn, '__name__', fn)!r} ran on CUDA but the trace in "
            f"{trace_dir!r} holds no kernel event (is CUPTI available to torch.profiler?)")
    obsm.PROFILE_CAPTURES.inc_always(ok="true")
    result = {
        "trace_dir": trace_dir,
        "steps": steps,
        "total_s": total,
        "avg_s": total / max(1, steps),
        "profiler": True,
    }
    emit_event("profile_stop", **result)
    result["attribution"] = attr if attr.by_line else None
    return result
