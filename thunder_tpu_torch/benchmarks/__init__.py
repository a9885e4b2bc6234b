"""Benchmark harness: timing, throughput and MFU statistics, on one device.

The counterpart of ``thunder_tpu/benchmarks/__init__.py``: the LitGPT
end-to-end metrics (average and median iteration time, tokens per second,
model FLOP/s against the card's peak, peak memory), with the same outlier
pruning. Completion is forced with ``torch.cuda.synchronize()`` and a scalar
read, since PyTorch returns before the card finishes. Peak memory is
``torch.cuda.max_memory_allocated`` over the warm-up and the timed
iterations (reset before the warm-up, which captures a staged step's graph
and allocates its pool). The peak rate is looked up by the card's name; on
a card not in the table, or on the CPU, MFU is left out.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

# Dense bf16 tensor-core rates by card name (NVIDIA's data sheets).
PEAK_BF16_FLOPS = {"H100": 989e12}


def peak_flops(device: Any) -> Optional[float]:
    """The card's dense bf16 peak in FLOP/s, or None (CPU, unknown card)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    return next((v for k, v in PEAK_BF16_FLOPS.items() if k in name), None)


def device_name(device: Any) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def force_completion(out: Any) -> float:
    """Wait for the device and read one scalar of the last tensor in
    ``out``; returns it (0.0 when ``out`` holds no tensor)."""
    from thunder_tpu_torch.core.pytree import tree_flatten

    leaves = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
    if leaves and leaves[-1].is_cuda:
        torch.cuda.synchronize(leaves[-1].device)
    if not leaves or leaves[-1].numel() == 0:
        return 0.0
    return float(leaves[-1].reshape(-1)[0])


@dataclass
class BenchmarkResult:
    name: str
    iters: int
    times_s: list[float]
    device: str = "cpu"
    tokens_per_iter: Optional[int] = None
    flops_per_iter: Optional[float] = None
    peak_flops: Optional[float] = None
    memory_gb: Optional[float] = None
    # True when the run was dispatched without a sync per iteration and one
    # sync at the end: times_s then holds the average repeated, so the
    # per-iteration spread was not measured and summary() omits it.
    pipelined: bool = False

    @property
    def pruned_times_s(self) -> list[float]:
        """The samples without outliers beyond 1.5×IQR of the quartiles;
        with fewer than 4 samples nothing is pruned."""
        ts = sorted(self.times_s)
        if len(ts) < 4:
            return ts
        q1 = float(np.percentile(ts, 25))
        q3 = float(np.percentile(ts, 75))
        lo, hi = q1 - 1.5 * (q3 - q1), q3 + 1.5 * (q3 - q1)
        pruned = [t for t in ts if lo <= t <= hi]
        return pruned or ts

    @property
    def outliers(self) -> int:
        return len(self.times_s) - len(self.pruned_times_s)

    @property
    def median_s(self) -> float:
        return statistics.median(self.pruned_times_s)

    @property
    def mean_s(self) -> float:
        return statistics.fmean(self.pruned_times_s)

    @property
    def stdev_s(self) -> float:
        ts = self.pruned_times_s
        return statistics.stdev(ts) if len(ts) > 1 else 0.0

    def percentile_s(self, q: float) -> float:
        return float(np.percentile(self.pruned_times_s, q))

    @property
    def tokens_per_sec(self) -> Optional[float]:
        return self.tokens_per_iter / self.median_s if self.tokens_per_iter else None

    @property
    def tflops_per_sec(self) -> Optional[float]:
        return self.flops_per_iter / self.median_s / 1e12 if self.flops_per_iter else None

    @property
    def mfu(self) -> Optional[float]:
        t = self.tflops_per_sec
        return t * 1e12 / self.peak_flops if t and self.peak_flops else None

    def summary(self) -> dict:
        d = {"name": self.name, "device": self.device, "iters": self.iters,
             "average_iter_time_s": round(self.mean_s, 5)}
        if self.pipelined:
            d["pipelined"] = True  # one sync; per-iteration spread not measured
        else:
            d["median_iter_time_s"] = round(self.median_s, 5)
            d["stdev_s"] = round(self.stdev_s, 6)
            d["p25_s"] = round(self.percentile_s(25), 5)
            d["p75_s"] = round(self.percentile_s(75), 5)
            if self.iters >= 10:
                d["p90_s"] = round(self.percentile_s(90), 5)
            if self.outliers:
                d["outliers_pruned"] = self.outliers
        if self.tokens_per_sec:
            d["tokens_per_sec"] = round(self.tokens_per_sec)
        if self.tflops_per_sec:
            d["model_tflop_per_sec"] = round(self.tflops_per_sec, 2)
        if self.mfu is not None:
            d["mfu"] = round(self.mfu, 4)
        if self.memory_gb is not None:
            d["memory_used_GB"] = round(self.memory_gb, 2)
        return d


def run_benchmark(
    name: str,
    fn: Callable[[], Any],
    *,
    device: Any = "cuda",
    warmup: int = 2,
    iters: int = 5,
    tokens_per_iter: Optional[int] = None,
    flops_per_iter: Optional[float] = None,
    pipelined: bool = False,
) -> BenchmarkResult:
    """Run ``fn`` ``warmup`` times, then time ``iters`` calls, each ended by
    :func:`force_completion`. ``pipelined=True`` dispatches every timed call
    and waits once at the end; the per-call times then all equal the
    average. The peak memory is taken over the warm-up and the timed calls:
    a staged step allocates its graph's pool when its warm-up captures it,
    and its replays allocate nothing there."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(warmup):
        force_completion(fn())
    if pipelined:
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn()
        force_completion(out)
        times = [(time.perf_counter() - t0) / iters] * iters
    else:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            force_completion(fn())
            times.append(time.perf_counter() - t0)
    return BenchmarkResult(
        name=name,
        iters=iters,
        times_s=times,
        device=device_name(dev),
        tokens_per_iter=tokens_per_iter,
        flops_per_iter=flops_per_iter,
        peak_flops=peak_flops(dev),
        memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None,
        pipelined=pipelined,
    )


def training_flops_per_token(n_params: float) -> float:
    """fwd+bwd ≈ 6·N FLOPs per token (forward 2N, backward 4N)."""
    return 6.0 * n_params


def forward_flops_per_token(n_params: float) -> float:
    return 2.0 * n_params


def count_params(params: Any) -> int:
    from thunder_tpu_torch.core.pytree import tree_flatten

    return sum(p.numel() for p in tree_flatten(params)[0] if isinstance(p, torch.Tensor))
