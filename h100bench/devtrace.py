"""The traced stretch: a profiler trace of a few steady calls, reduced to
device intervals, kernel groups, idle gaps and the host operation that spans
each gap.

``capture`` runs a function under ``torch.profiler`` (CPU and CUDA activities)
inside a span of the harness's own, ``h100bench.traced``, which ends with a
synchronize; that span is the traced window. The trace is exported as a
Chrome trace into a temporary directory, read back and deleted.

Device time is the union of the intervals of kernels, memcpys and memsets
(not their sum, which passes the wall where two overlap). A kernel belongs to
the first group, in the groups' order, one of whose patterns its name
contains; "other" is what none claims.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

WINDOW = "h100bench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
OTHER = "other"


@dataclass
class Trace:
    window: tuple  # (start, end) in µs
    kernels: list = field(default_factory=list)  # (name, start, end)
    device: list = field(default_factory=list)  # (start, end) of every device op
    host: list = field(default_factory=list)  # (name, start, end) on the window's thread

    @classmethod
    def from_events(cls, events: list) -> "Trace":
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in spans if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
        if not win:
            raise ValueError(f"the trace has no {WINDOW!r} span")
        w = win[0]
        t = cls(window=(float(w["ts"]), float(w["ts"]) + float(w["dur"])))
        for e in spans:
            start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                t.device.append((start, end))
                if cat == "kernel":
                    t.kernels.append((e["name"], start, end))
            elif cat in HOST_CATS and e.get("tid") == w.get("tid") and e.get("pid") == w.get("pid") and e is not w:
                t.host.append((e["name"], start, end))
        return t

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device intervals, clipped to the window."""
        lo, hi = self.window
        out = []
        for s, e in sorted(self.device):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def gaps(self) -> list:
        """``(start, end)`` of each stretch of the window with no device op."""
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def gap_owner(self, gap: tuple) -> str:
        """The innermost host operation that spans the middle of ``gap``."""
        mid = (gap[0] + gap[1]) / 2
        covering = [(e - s, name) for name, s, e in self.host if s <= mid <= e]
        return min(covering)[1] if covering else "no host op"

    def group_seconds(self, groups: list) -> dict:
        """Device seconds of the window's kernels by group (``groups`` as
        ``cells.kernel_groups`` gives them), "other" included."""
        out = {name: 0.0 for name, _ in groups}
        out[OTHER] = 0.0
        for name, s, e in self._in_window():
            out[group_of(name, groups)] += (e - s) / 1e6
        return out

    def _in_window(self):
        lo, hi = self.window
        return [(n, s, e) for n, s, e in self.kernels if s >= lo and e <= hi]

    def breakdown(self, groups: list, top: int = 10) -> dict:
        """The device operations that took most time (by kernel name, with
        their group), and the idle time by the host operation that spans it."""
        ops: dict = {}
        for name, s, e in self._in_window():
            key = f"{group_of(name, groups)}: {name[:120]}"
            ops[key] = ops.get(key, 0.0) + (e - s) / 1e6
        idle: dict = {}
        for g in self.gaps():
            key = self.gap_owner(g)
            idle[key] = idle.get(key, 0.0) + (g[1] - g[0]) / 1e6
        by_time = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": by_time(ops), "idle_gaps": by_time(idle)}


def group_of(kernel: str, groups: list) -> str:
    for name, patterns in groups:
        if any(p in kernel for p in patterns):
            return name
    return OTHER


def capture(fn) -> Trace:
    """Run ``fn`` under the profiler inside the traced window, which ends
    with a synchronize, and read the trace back."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with tempfile.TemporaryDirectory() as d:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                fn()
                torch.cuda.synchronize()
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Trace.from_events(events)
