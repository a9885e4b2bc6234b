"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the reference, and the result line.

The runner is ``runners/<kind>.py``'s ``Runner``, found by the mix's
``kind``. Every runner has the same parts: ``load(seed)``, ``setup()`` (its
readings for the check, with ``check_s``, the seconds they took),
``window(seconds)`` (a dict with ``elapsed_s``, ``attempted`` and
``failed``), ``traced()``, ``spans()``, ``release()``,
``reference(readings, window)`` (each number compared) and
``end_to_end(window)`` (``{metric: (unit, value)}``).

A per-layer metric's reader gets one object, ``run``, that holds the cell,
the runner, the window, the trace, the kernel groups, the card's peaks, the
runner's and the harness's spans (``run.spans``), and the program's metrics
registry as it stood after set-up and after the window (``run.counters``,
``{"setup": ..., "window": ...}``, each the registry's flat snapshot).

``run_cell`` takes the device as an argument, so that tests drive a whole run
on the CPU with a small cell; the command (``run.py``) refuses to run without
the cards a cell asks for.
"""

from __future__ import annotations

import importlib
import math
import time
from types import SimpleNamespace
from typing import Callable, Optional

import torch

from h100bench import cells, counts

GIB = 2**30


def runner_class(kind: str):
    """The ``Runner`` of ``runners/<kind>.py``."""
    return importlib.import_module(f"h100bench.runners.{kind}").Runner


def _registry() -> dict:
    from thunder_tpu_torch.observability import metrics as obsm

    return obsm.REGISTRY.report_compact()


def _kernel_build_s() -> float:
    """Seconds the program's kernel library took to build: 0 where the
    checkout already holds it."""
    from thunder_tpu_torch.executors import _build

    return _build.build().seconds


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             runner: Optional[Callable] = None) -> dict:
    """Run ``cell`` once and return the result line as a dict. ``t_start``
    is the host clock when the process began (set-up counts from it);
    ``runner`` makes the runner in the place of the mix's own (the control,
    or a planted fault)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if traced:
        import thunder_tpu_torch.monitor as monitor

        monitor.enable()
    phases = {"imports_s": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    phases["kernel_build_s"] = _kernel_build_s() if on_card else 0.0
    phases["kernel_load_s"] = time.perf_counter() - t0 - phases["kernel_build_s"]
    drv = (runner or runner_class(cell.traffic["kind"]))(cell, device)
    t0 = time.perf_counter()
    drv.load(seed)
    phases["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    readings = drv.setup()
    phases["warm_s"] = time.perf_counter() - t0 - readings["check_s"]
    setup_s = time.perf_counter() - t_start - readings["check_s"]

    snapshots = {"setup": _registry()} if traced else {}
    win = drv.window(seconds)
    if traced:
        snapshots["window"] = _registry()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else device.type,
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}

    metrics, breakdown = {}, None
    if traced:
        trace, traced_work = drv.traced() if on_card else (None, None)
        run = SimpleNamespace(
            cell=cell, dims=cell.dims, runner=drv, window=win, trace=trace, traced=traced_work,
            groups=cells.kernel_groups(), peak=counts.peak(device_info["kind"]),
            counters=snapshots, spans={**phases, **drv.spans()},
        )
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if trace is not None:
            device_info.update(busy_s=trace.busy_s, window_s=trace.window_s)
            breakdown = trace.breakdown(run.groups)
        del run, trace
    else:
        values = drv.end_to_end(win)
        values["train_peak_gib"] = ("GiB", memory_peak / GIB)
        values["setup_s"] = ("s", setup_s)
        for m in cell.end_to_end:
            unit, value = values[m["name"]]
            if unit != m["unit"]:
                raise ValueError(f"{m['name']}: the runner reports {unit}, BENCHMARK.json says {m['unit']}")
            metrics[m["name"]] = {"value": value, "unit": unit}

    drv.release()
    checks = drv.reference(readings, win)
    detail = checks.pop("_detail")
    compared = {name: {"value": value, "limit": cell.limits[name]} for name, value in checks.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    result = {"correct": bool(correct and win["failed"] == 0), "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup"] = phases
    result["detail"] = detail
    result["checks"] = compared
    return result
