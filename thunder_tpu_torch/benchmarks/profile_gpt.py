"""Where the device time of one GPT forward goes, on one CUDA card.

    python -m thunder_tpu_torch.benchmarks.profile_gpt [--batch 10]

Runs ``jit(forward)`` of open_llama_3b at T=2048 with random weights from a
seed, times three calls with the host clock around
``torch.cuda.synchronize()``, then profiles one call with
``torch.profiler`` and sums the device time of its kernels by group: the
port's own kernels (flash, rope, cross-entropy), matrix products, and every
other PyTorch kernel (the decomposed norms, activations and copies). Prints
one JSON line. The device busy share is the summed kernel time over the wall
time of an unprofiled call.
"""

from __future__ import annotations

import argparse
import json
import time

CONFIG = "open_llama_3b"
SEQ = 2048
CALLS = 3

def _group(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    if "rope_kernel" in name:
        return "rope"
    if "ce_fwd_kernel" in name:
        return "ce_fwd"
    if any(s in name for s in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul"
    return "other"


def main(argv=None) -> None:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.models import gpt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = gpt.name_to_config(CONFIG)
    params = gpt.init_params(cfg, seed=0, device="cuda")
    idx = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (args.batch, SEQ))).cuda()
    fwd = tt.jit(lambda p, i: gpt.forward(p, i, cfg))
    fwd(params, idx)
    torch.cuda.synchronize()
    walls, enqueues = [], []
    for _ in range(CALLS):
        t = time.perf_counter()
        fwd(params, idx)
        enqueues.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd(params, idx)
        torch.cuda.synchronize()
    by_group: dict[str, float] = {}
    top = []
    for evt in prof.key_averages():
        # Kernels only: the aten operators that launch them carry the same time.
        if evt.device_type != DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        us = float(evt.self_device_time_total)
        g = _group(evt.key)
        by_group[g] = by_group.get(g, 0.0) + us / 1e3
        top.append((us / 1e3, evt.count, evt.key[:90]))
    top.sort(reverse=True)
    device_ms = sum(by_group.values())
    wall_ms = min(walls) * 1e3
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "config": cfg.name, "batch": args.batch, "seq": SEQ,
        "wall_ms": [w * 1e3 for w in walls],
        "enqueue_ms": [e * 1e3 for e in enqueues],
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "device_ms_by_group": by_group,
        "top_kernels": [{"ms": ms, "count": n, "name": k} for ms, n, k in top[:12]],
    }), flush=True)


if __name__ == "__main__":
    main()
