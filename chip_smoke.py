#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It drives ``thunder_tpu_torch`` only (no JAX, nothing of ``thunder_tpu``):

1. prints the card (``nvidia-smi`` name and power limit, torch's name);
2. builds the CUDA kernels from ``thunder_tpu_torch/csrc`` for sm_90a and
   prints the build seconds and ptxas' register/spill lines;
3. runs each kernel at the shapes open_llama_3b's loss (B=2) and forward
   (B=10) give it, holds it against its plain PyTorch version on the same
   inputs row by row, and times kernel, plain version and the nearest single
   PyTorch call (CUDA events);
4. checks the whole path at open_llama_3b's full width with 2 layers, forward
   at B=10 and loss at B=2: the default executors against the torch executor
   alone, then the same with a planted attention fault, which must fail;
5. runs the full 26-layer open_llama_3b: ``jit(loss_fn)`` at B=2, T=2048 and
   ``jit(forward)`` at B=10, T=2048, with random weights from a seed, and
   checks that each kernel was launched the expected number of times;
6. prints one JSON line describing every kernel, then the device line.

Any failed check raises, and the script exits non-zero without printing the
last line. Exits non-zero at once when there is no CUDA card.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from dataclasses import replace

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s

CFG_NAME = "open_llama_3b"
SEQ = 2048
LOSS_BATCH = 2
FWD_BATCH = 10
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {msg}")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# =============================================================================
# Phase 3: each kernel against its plain version at the path shapes
# =============================================================================


def row_rel_err(got, want) -> float:
    """The largest error in a row over that row's largest |value|, maximised
    over rows (a row is the last dim). A row that is wrong in part shows up
    in full, however small its values are next to other rows'."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    ref = want.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return (err / ref).max().item()


# Rope: f32 arithmetic rounded once to bf16 in both kernel and plain version;
# a fused multiply-add may move the rounding by one bf16 ulp of the element,
# which is at most 2^-7 of the row's largest |value|.
ROPE_ROW_REL = 2.0 ** -7
# Flash: both round O to bf16 once (up to one ulp, <= 2^-7 of the row max),
# and round P to bf16 against different maxima (the running max in the
# kernel, the row max in the plain version: relative 2^-9 per term of the
# weighted mean). Two ulps of the row max bound both together.
FLASH_ROW_REL = 2.0 ** -6


def _path_inputs(cfg, batch: int, gen):
    """q/k/v as the path gives them to rope (views of the fused qkv
    projection) and rope's bf16 cos/sin tables."""
    import torch

    dev = torch.device("cuda")
    T, H, G, D = SEQ, cfg.n_head, cfg.query_groups, cfg.head_size
    qkv = torch.randn((batch, T, (H + 2 * G) * D), generator=gen, device=dev).to(torch.bfloat16)

    def heads(lo, n):
        return qkv[..., lo * D:(lo + n) * D].reshape(batch, T, n, D).permute(0, 2, 1, 3)

    pos = torch.arange(T, device=dev, dtype=torch.float32)[:, None]
    theta = cfg.rope_base ** (torch.arange(D // 2, device=dev, dtype=torch.float32) * -2.0 / D)
    emb = torch.cat([pos * theta, pos * theta], dim=1)
    return heads(0, H), heads(H, G), heads(H + G, G), emb.cos().to(torch.bfloat16), emb.sin().to(torch.bfloat16)


def check_kernels(cfg) -> list[dict]:
    """Rope and flash at both path batches (loss B=2, forward B=10), CE at the
    loss path's (B*T, V). Each is held against its plain version on the same
    inputs and timed; the returned rows are the B=2 timings with the largest
    error over both batches."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.executors import flashex, fusedex

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows: dict[str, dict] = {}

    def record(name, batch, err, rel, limit, **timing):
        row = rows.setdefault(name, dict(name=name, route="cuda", max_abs_err=0.0, row_rel_err=0.0,
                                         row_rel_limit=limit))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["row_rel_err"] = max(row["row_rel_err"], rel)
        t = timing
        log(f"  {name:8s} B={batch:<2d} max_abs_err={err:.3e} row_rel_err={rel:.3e} (limit {limit:.3e}) "
            f"kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"library_ms={'none' if t['library_ms'] is None else format(t['library_ms'], '.4f')} "
            f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
        require(rel <= limit, f"{name} kernel disagrees with its plain version at B={batch} ({rel} > {limit})")
        if batch == LOSS_BATCH:
            row.update(timing)

    for B in (LOSS_BATCH, FWD_BATCH):
        q_view, k_view, v_view, cos, sin = _path_inputs(cfg, B, gen)

        # -- rope: x (B, H, T, D) bf16, a strided view of qkv ------------------
        got = fusedex.apply_rope(q_view, cos, sin)
        want = fusedex.rope_plain(q_view, cos, sin)
        err = (got.float() - want.float()).abs().max().item()
        nb = q_view.numel() * 2 * 2 + cos.numel() * 2 * 2
        b_ms, b_by = bound(nb, 3.0 * q_view.numel(), PEAK_F32_FLOPS)
        record("rope", B, err, row_rel_err(got, want), ROPE_ROW_REL,
               source="thunder_tpu_torch/csrc/rope.cu", replaces="thunder_tpu/executors/pallasex.py:220",
               ms=time_ms(lambda: fusedex.apply_rope(q_view, cos, sin), 50),
               plain_ms=time_ms(lambda: fusedex.rope_plain(q_view, cos, sin), 20),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del got, want

        # -- flash: q, k rope outputs (contiguous), v a strided view -------------
        q = fusedex.apply_rope(q_view, cos, sin)
        k = fusedex.apply_rope(k_view, cos, sin)
        v = v_view
        scale = 1.0 / math.sqrt(cfg.head_size)
        got = flashex.flash_attention_fwd(q, k, v, causal=True, scale=scale)
        want = flashex.flash_attention_plain(q, k, v, causal=True, scale=scale)
        require(bool(torch.isfinite(got).all()), f"flash kernel produced non-finite values at B={B}")
        err = (got.float() - want.float()).abs().max().item()
        rel = row_rel_err(got, want)
        del want
        pairs = SEQ * (SEQ + 1) // 2  # causal (query, key) pairs with Tq == Tkv
        flops = 4.0 * B * cfg.n_head * cfg.head_size * pairs
        nb = (q.numel() + k.numel() + v.numel() + got.numel()) * 2
        b_ms, b_by = bound(nb, flops, PEAK_BF16_FLOPS)
        record("flash_fwd", B, err, rel, FLASH_ROW_REL,
               source="thunder_tpu_torch/csrc/flash_attn.cu", replaces="thunder_tpu/executors/flashex.py:243",
               ms=time_ms(lambda: flashex.flash_attention_fwd(q, k, v, causal=True, scale=scale), 20),
               plain_ms=time_ms(lambda: flashex.flash_attention_plain(q, k, v, causal=True, scale=scale), 3, 1),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20))
        del got, q, k, v, q_view, k_view, v_view
        torch.cuda.empty_cache()

    # -- cross-entropy: logits (B*T, V) f32, int64 targets, some ignored -------
    N, V = LOSS_BATCH * SEQ, cfg.padded_vocab_size
    logits = torch.randn((N, V), generator=gen, device="cuda")
    targets = torch.randint(0, V, (N,), generator=gen, device="cuda")
    targets[::97] = -100
    got = fusedex.cross_entropy_rows(logits, targets, -100)
    want = fusedex.cross_entropy_rows_plain(logits, targets, -100)
    err = (got - want).abs().max().item()
    # Per-row losses near 10.9: an f32 logsumexp of 32000 terms summed in
    # another order differs by a few f32 ulps of the loss; 1e-5 relative.
    nb = logits.numel() * 4 + targets.numel() * 8 + N * 4
    b_ms, b_by = bound(nb, 4.0 * N * V, PEAK_F32_FLOPS)
    record("ce_fwd", LOSS_BATCH, err, row_rel_err(got[:, None], want[:, None]), 1e-5,
           source="thunder_tpu_torch/csrc/cross_entropy.cu", replaces="thunder_tpu/executors/pallasex.py:85",
           ms=time_ms(lambda: fusedex.cross_entropy_rows(logits, targets, -100), 20),
           plain_ms=time_ms(lambda: fusedex.cross_entropy_rows_plain(logits, targets, -100), 10),
           bound_ms=b_ms, bound_by=b_by,
           library_ms=time_ms(lambda: F.cross_entropy(logits, targets, ignore_index=-100, reduction="none"), 20))
    return list(rows.values())


# =============================================================================
# Phases 4 and 5: the whole path
# =============================================================================


def _launch_counts() -> dict:
    from thunder_tpu_torch.executors import flashex, fusedex

    return {"flash_fwd": flashex.flash_attention_fwd.launches, "rope": fusedex.apply_rope.launches,
            "ce_fwd": fusedex.cross_entropy_rows.launches}


def _zero_counts() -> None:
    from thunder_tpu_torch.executors import flashex, fusedex

    flashex.flash_attention_fwd.launches = 0
    fusedex.apply_rope.launches = 0
    fusedex.cross_entropy_rows.launches = 0


# The 2-layer model against the torch executor alone. The decomposition
# rounds q*scale and the scores to bf16 where the kernel keeps scores in f32,
# so logits differ by a few bf16 ulps; the limits are set from a sound run's
# readings (PERF.md) and a planted fault (attention without its causal mask)
# must exceed them, which shows that the comparison can see attention.
LOGITS_ROW_REL = 2.0 ** -4
LOSS_REL = 1e-4


def check_two_layers(cfg) -> None:
    import numpy as np
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.executors import flashex
    from thunder_tpu_torch.models import gpt

    cfg2 = replace(cfg, name=cfg.name + "-2layer", n_layer=2)
    params = gpt.init_params(cfg2, seed=SEED, device="cuda")
    rng = np.random.RandomState(SEED)
    idx_fwd = torch.from_numpy(rng.randint(0, cfg2.vocab_size, (FWD_BATCH, SEQ))).cuda()
    idx = torch.from_numpy(rng.randint(0, cfg2.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg2.vocab_size, (LOSS_BATCH, SEQ))).cuda()

    def run(executors):
        fwd = tt.jit(lambda p, i: gpt.forward(p, i, cfg2), executors=executors)
        loss = tt.jit(lambda p, i, t: gpt.loss_fn(p, i, t, cfg2), executors=executors)
        out = fwd(params, idx_fwd).float(), float(loss(params, idx, tgt))
        torch.cuda.synchronize()
        return out

    want_logits, want_loss = run(["torch"])

    def compare(label, logits, loss) -> bool:
        rel = row_rel_err(logits, want_logits)
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        ok = math.isfinite(loss) and rel <= LOGITS_ROW_REL and loss_rel <= LOSS_REL
        log(f"  2-layer {label}: logits B={FWD_BATCH} max_abs_err={(logits - want_logits).abs().max().item():.3e} "
            f"row_rel_err={rel:.3e} (limit {LOGITS_ROW_REL:.3e}); loss B={LOSS_BATCH} {loss:.6f} vs torch "
            f"{want_loss:.6f} rel_err={loss_rel:.3e} (limit {LOSS_REL:.0e}) -> {'pass' if ok else 'FAIL'}")
        return ok

    sound = compare("kernels", *run(None))
    real = flashex.flash_attention_fwd

    def planted(q, k, v, *, causal, scale):
        return real(q, k, v, causal=False, scale=scale)

    planted.launches = 0  # the kernel counts its launches on the module's name
    flashex.flash_attention_fwd = planted
    try:
        planted = compare("planted fault (flash without its causal mask)", *run(None))
    finally:
        flashex.flash_attention_fwd = real
    require(sound, "2-layer model with the kernels differs from the torch executor")
    require(not planted, "the 2-layer comparison did not see a planted attention fault")
    del params, want_logits


def run_full(cfg) -> dict:
    import numpy as np
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.models import gpt

    # The jitted functions of phase 4 hold their inputs in reference cycles;
    # collect them so the peaks below are the full model's alone.
    gc.collect()
    log(f"  allocated before the full model: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"  init_params: {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(SEED)
    launches = {k: 0 for k in _launch_counts()}

    def drive(label, fn, args, per_call, calls=3):
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        times = []
        for _ in range(calls):
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        counts = _launch_counts()
        log(f"  {label}: first call (trace + run) {times[0]:.3f} s, then "
            f"{', '.join(f'{x:.4f}' for x in times[1:])} s/call; "
            f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}")
        for k, n in per_call.items():
            require(counts[k] == n * calls, f"{label}: {k} launched {counts[k]} times, expected {n * calls}")
        for k in launches:
            launches[k] += counts[k]
        return out

    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    loss_fn = tt.jit(lambda p, i, t: gpt.loss_fn(p, i, t, cfg))
    n = cfg.n_layer
    loss = float(drive(f"loss B={LOSS_BATCH} T={SEQ}", loss_fn, (params, idx, tgt),
                       {"flash_fwd": n, "rope": 2 * n, "ce_fwd": 1}))
    # Random init: logits ~ N(0, s^2) with s = 0.02 * sqrt(n_embd) ~ 1.13, so
    # the loss is about ln V + s^2 / 2 ~ 11.0.
    log(f"  loss = {loss:.6f} (ln V = {math.log(cfg.vocab_size):.4f})")
    require(math.isfinite(loss) and abs(loss - math.log(cfg.vocab_size)) < 2.0, "loss is not near ln V")
    del loss_fn

    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (FWD_BATCH, SEQ))).cuda()
    fwd = tt.jit(lambda p, i: gpt.forward(p, i, cfg))
    logits = drive(f"forward B={FWD_BATCH} T={SEQ}", fwd, (params, idx),
                   {"flash_fwd": n, "rope": 2 * n, "ce_fwd": 0})
    require(tuple(logits.shape) == (FWD_BATCH, SEQ, cfg.padded_vocab_size), f"logits shape {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), "forward logits are not finite")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from thunder_tpu_torch.executors import _build
    from thunder_tpu_torch.models import gpt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt.name_to_config(CFG_NAME)

    log("[1] card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)  # name, power limit: every time below was taken at this limit
    log(f"  torch: {torch.__version__} cuda {torch.version.cuda}; device {torch.cuda.get_device_name(0)}")

    log("[2] build")
    info = _build.build()
    _build.lib()
    log(f"  built {info.path.name} in {info.seconds:.1f} s")
    for line in info.log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"  {line.strip()}")

    log(f"[3] kernels at {CFG_NAME} path shapes")
    rows = check_kernels(cfg)

    log(f"[4] {CFG_NAME} at full width, 2 layers: default executors vs torch executor")
    check_two_layers(cfg)

    log(f"[5] {CFG_NAME}, {cfg.n_layer} layers")
    launches = run_full(cfg)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "row_rel_err", "row_rel_limit",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: (launches[r["name"]] if k == "launches" else r[k]) for k in keys} for r in rows]
    print(json.dumps({"kernels": kernels, "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
