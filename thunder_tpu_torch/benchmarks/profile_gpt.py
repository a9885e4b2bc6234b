"""Where the device time of a GPT forward and training step goes, on one card.

    python -m thunder_tpu_torch.benchmarks.profile_gpt [--batch 10]
    python -m thunder_tpu_torch.benchmarks.profile_gpt --model pythia-410m \
        --executors norm,flash,fused,torch --step litgpt

Runs ``jit(forward)`` of ``--model`` (default open_llama_3b) at ``--batch``
x T=2048 with ``--executors`` (default: the default stack), then one
training step at B=2 x T=2048, with random weights from a seed: with
``--step bench`` (the default) ``benchmarks/train.py``'s (split forward
and backward with remat, then SGD; default executors only), with ``--step
litgpt`` the LitGPT benchmark's (``benchmarks/litgpt.py``: one joint fw+bw
program with ``--executors``, then AdamW). Each is staged as a CUDA graph
(``executors/staging.py``): two untimed calls warm it up and capture it,
then it is timed three times with the host clock around
``torch.cuda.synchronize()`` (the enqueue time is the replay's), then
profiled once with ``torch.profiler``, and the device time of its kernels
is summed by group: the port's own kernels (flash forward, flash backward,
rope, cross-entropy, norm, and the int8 linear's quantization and int8
GEMM), matrix products, and every other PyTorch kernel
(the decomposed norms, activations, copies, the qkv slice backward's pads
and adds, the optimizer update). Prints one JSON line for each. The device busy share is
the summed kernel time over the wall time of an unprofiled call; the
enqueue time is the host's time to return from the call, before the sync.
``chip_smoke.py`` profiles the jitted Llama module on a padded batch with
``profile_call``.
"""

from __future__ import annotations

import argparse
import json
import time

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
    if "norm_fwd_kernel" in name or "norm_bwd_kernel" in name:
        return "norm"
    if "quantize_rows_kernel" in name or "quantize_tensor_kernel" in name or "amax_kernel" in name:
        return "quant"
    if "int8_gemm" in name:
        return "int8_gemm"
    if any(s in name for s in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul"
    return "other"


def profile_call(label: str, fn, **info) -> dict:
    """Call ``fn`` twice (a staged call's warm-up and capture), time it
    CALLS times, profile it once, print one JSON line and return it as a
    dict."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
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
    result = {
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
    }
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> None:
    import numpy as np
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.models import gpt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--model", default="open_llama_3b")
    ap.add_argument("--executors", default="", help="comma list in priority order (default: the default stack)")
    ap.add_argument("--step", choices=("bench", "litgpt"), default="bench")
    args = ap.parse_args(argv)
    executors = [e for e in args.executors.split(",") if e] or None
    if args.step == "bench" and executors is not None:
        ap.error("--step bench runs the default executors only")

    cfg = gpt.name_to_config(args.model)
    params = gpt.init_params(cfg, seed=0, device="cuda")
    idx = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (args.batch, SEQ))).cuda()
    fwd = tt.jit(lambda p, i: gpt.forward(p, i, cfg), executors=executors)
    info = dict(config=cfg.name, executors=args.executors or "default")
    profile_call("forward", lambda: fwd(params, idx), batch=args.batch, seq=SEQ, **info)
    del fwd, idx
    if args.step == "bench":
        from thunder_tpu_torch.benchmarks.train import build_train

        tr = build_train(cfg, TRAIN_BATCH, SEQ, params=params)
        profile_call("train_step", tr.step, batch=TRAIN_BATCH, seq=SEQ, optimizer="sgd", **info)
        return
    from thunder_tpu_torch.benchmarks import litgpt

    del params
    run = litgpt.prepare(litgpt.parse_args(["--model", args.model, "--micro-batch", str(TRAIN_BATCH),
                                            "--seq", str(SEQ)]), args.executors or None)
    profile_call("train_step", run.fn, batch=TRAIN_BATCH, seq=SEQ, optimizer="adamw", step="litgpt", **info)


if __name__ == "__main__":
    main()
