"""Where the device time of a GPT forward and training step goes, on one card.

    python -m thunder_tpu_torch.benchmarks.profile_gpt [--batch 10]

Runs ``jit(forward)`` of open_llama_3b at ``--batch`` x T=2048, then one
training step (``benchmarks/train.py``: forward, backward, SGD) at B=2 x
T=2048, with random weights from a seed. Each is timed three times with the
host clock around ``torch.cuda.synchronize()``, then profiled once with
``torch.profiler``, and the device time of its kernels is summed by group:
the port's own kernels (flash forward, flash backward, rope, cross-entropy),
matrix products, and every other PyTorch kernel (the decomposed norms,
activations, copies, the qkv slice backward's pads and adds, the SGD
update). Prints one JSON line for each. The device busy share is the summed
kernel time over the wall time of an unprofiled call.
"""

from __future__ import annotations

import argparse
import json
import time

CONFIG = "open_llama_3b"
SEQ = 2048
CALLS = 3
TRAIN_BATCH = 2


def _group(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    if "flash_bwd" in name:
        return "flash_bwd"
    if "rope_kernel" in name:
        return "rope"
    if "ce_fwd_kernel" in name or "ce_bwd_kernel" in name:
        return "ce"
    if any(s in name for s in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul"
    return "other"


def _profile(label: str, fn, **info) -> None:
    """Time ``fn`` CALLS times, profile it once, print one JSON line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls, enqueues = [], []
    for _ in range(CALLS):
        t = time.perf_counter()
        fn()
        enqueues.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_group: dict[str, float] = {}
    top, ops = [], []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CPU and evt.key.startswith("aten::") and evt.device_time_total > 0:
            # The device time of the kernels an operator launched, nested
            # operators included: e.g. constant_pad_nd is the qkv slice
            # backward's pads.
            ops.append((evt.device_time_total / 1e3, evt.count, evt.key))
        # Kernels only: the aten operators that launch them carry the same time.
        if evt.device_type != DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        us = float(evt.self_device_time_total)
        g = _group(evt.key)
        by_group[g] = by_group.get(g, 0.0) + us / 1e3
        top.append((us / 1e3, evt.count, evt.key[:90]))
    top.sort(reverse=True)
    ops.sort(reverse=True)
    device_ms = sum(by_group.values())
    wall_ms = min(walls) * 1e3
    print(json.dumps({
        "what": label,
        "device": torch.cuda.get_device_name(0),
        **info,
        "wall_ms": [w * 1e3 for w in walls],
        "enqueue_ms": [e * 1e3 for e in enqueues],
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "device_ms_by_group": by_group,
        "top_kernels": [{"ms": ms, "count": n, "name": k} for ms, n, k in top[:12]],
        "top_ops": [{"ms": ms, "count": n, "name": k} for ms, n, k in ops[:16]],
    }), flush=True)


def main(argv=None) -> None:
    import numpy as np
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.benchmarks.train import build_train
    from thunder_tpu_torch.models import gpt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = gpt.name_to_config(CONFIG)
    params = gpt.init_params(cfg, seed=0, device="cuda")
    idx = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (args.batch, SEQ))).cuda()
    fwd = tt.jit(lambda p, i: gpt.forward(p, i, cfg))
    _profile("forward", lambda: fwd(params, idx), config=cfg.name, batch=args.batch, seq=SEQ)
    del fwd, idx
    tr = build_train(cfg, TRAIN_BATCH, SEQ, params=params)
    _profile("train_step", tr.step, config=cfg.name, batch=TRAIN_BATCH, seq=SEQ)


if __name__ == "__main__":
    main()
