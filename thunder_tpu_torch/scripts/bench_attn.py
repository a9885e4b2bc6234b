#!/usr/bin/env python
"""Attention microbenchmark: the port's flash routes on the bench shape.

The counterpart of ``scripts/bench_attn.py``. Shape B=2 H=32 T=2048
(open_llama_3b), D=100 unless given, causal, bf16. Routes:

- ``splash``: the port's default route, the forward kernel
  (``csrc/flash_attn.cu``; kernel table rows 1 and 6, the latter writing
  the logsumexp) and the backward from the saved (out, lse)
  (``csrc/flash_bwd.cu``, ``flash_bwd_dq.cu``; row 7);
- ``legacy``: ``THUNDER_FLASH_IMPL=legacy``'s ``legacy_flash_fwd`` and
  ``legacy_flash_bwd`` (row 10: the backward recomputes the forward, so a
  forward and backward launches the forward kernel twice);
- ``materialized``: the kernels' plain versions, the scores materialized in
  f32 (``flash_attention_plain``, ``flash_attention_bwd_recompute_plain``);
- ``sdpa``: ``F.scaled_dot_product_attention`` and its autograd backward,
  timed beside them as a yardstick only (a library call, not a port of a
  kernel).

Each route's forward output and its (dq, dk, dv) are held against the
materialized route's: the largest absolute error and the row-relative one
(a row's largest error over its largest |value|). The port's kernels take no
block size, so there are no block-size variants.

Timing: iterations are chained (``chain_time`` threads a state through
them; here the stream already orders each iteration's launches after the
last's, so no arithmetic links them), synchronised with
``torch.cuda.synchronize``, and the per-iteration time is the slope between
a short and a long run, which cancels the fixed cost of the sync. TF/s counts the causal half of
the 4·B·H·T²·D products (3.5 times that for forward and backward) against
989 TFLOP/s, the H100's bf16 peak.

A route that fails to build or launch fails the script: nothing carries on
with a plain version.

Usage::

    python -m thunder_tpu_torch.scripts.bench_attn [D] [--batch B] [--heads H] [--seq T] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from thunder_tpu_torch.scripts.bench import _sync

B, H, T, D = 2, 32, 2048, 100
PEAK_TFLOPS = 989.0  # H100 dense bf16 (analysis/cost.py's DeviceSpec)
N_SHORT, N_LONG = 5, 45


def chain_time(step, state, dev, n_short: int = N_SHORT, n_long: int = N_LONG) -> float:
    """``step``: state -> state. The seconds an iteration: the slope
    between a run of ``n_short`` and one of ``n_long`` chained iterations,
    each ending in a synchronize."""
    step(state)
    _sync(dev)

    def run(n):
        s = state
        t0 = time.perf_counter()
        for _ in range(n):
            s = step(s)
        _sync(dev)
        return time.perf_counter() - t0

    run(2)
    t_s = run(n_short)
    t_l = run(n_long)
    return (t_l - t_s) / (n_long - n_short)


def flops_fwd(b: int, h: int, t: int, d: int) -> float:
    return 2 * 2 * b * h * t * t * d / 2


def row_rel_err(got, want, floor: float = 0.0) -> float:
    """The largest error in a row over that row's largest |value|,
    maximised over rows; ``floor`` (a fraction of the tensor's largest
    |value|) is the least reference a row gets."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    ref = want.abs().amax(-1).clamp_min(max(floor * want.abs().max().item(), torch.finfo(torch.float32).tiny))
    return (err / ref).max().item()


def routes(scale: float) -> dict:
    """``{name: (fwd(q, k, v), fwd_bwd(q, k, v, dout) -> (dq, dk, dv), yardstick)}``."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.executors import flashex

    def splash_fwd_bwd(q, k, v, dout):
        out, lse = flashex.flash_attention_fwd_lse(q, k, v, causal=True, scale=scale)
        return flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=True, scale=scale)

    def legacy_fwd_bwd(q, k, v, dout):
        # A training step's: the forward, then the backward, which runs the
        # forward again for its logsumexp (jax.vjp of the Pallas kernel).
        flashex.legacy_flash_fwd(q, k, v, causal=True, scale=scale)
        return flashex.legacy_flash_bwd(dout, q, k, v, causal=True, scale=scale)

    def sdpa_fwd_bwd(q, k, v, dout):
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True, scale=scale)
        return torch.autograd.grad(out, (qq, kk, vv), dout)

    return {
        "splash": (lambda q, k, v: flashex.flash_attention_fwd(q, k, v, causal=True, scale=scale), splash_fwd_bwd,
                   False),
        "legacy": (lambda q, k, v: flashex.legacy_flash_fwd(q, k, v, causal=True, scale=scale), legacy_fwd_bwd,
                   False),
        "materialized": (lambda q, k, v: flashex.flash_attention_plain(q, k, v, causal=True, scale=scale),
                         lambda q, k, v, dout: flashex.flash_attention_bwd_recompute_plain(dout, q, k, v, causal=True,
                                                                                           scale=scale), False),
        "sdpa": (lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale), sdpa_fwd_bwd,
                 True),
    }


LABELS = {"splash": "splash (rows 1, 6-7)", "legacy": "legacy (row 10)", "materialized": "materialized (plain)",
          "sdpa": "sdpa (yardstick)"}


def run(b: int = B, h: int = H, t: int = T, d: int = D, device="cuda", n_short: int = N_SHORT,
        n_long: int = N_LONG, out=sys.stdout) -> dict:
    """Every route at (b, h, t, d) on ``device``: prints a line each and
    returns ``{"shape", "ideal_fwd_ms", "routes": [...]}``, each route's
    times, TF/s and errors against the materialized route."""
    import torch

    from thunder_tpu_torch.core import devices

    dev = devices.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, dout = (torch.randn((b, h, t, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    fl = flops_fwd(b, h, t, d)
    ideal_ms = fl / (PEAK_TFLOPS * 1e12) * 1e3
    print(f"shape B={b} H={h} T={t} D={d}; ideal causal fwd @{PEAK_TFLOPS:.0f}TF/s = {ideal_ms:.3f}ms", file=out)
    table = routes(scale)
    ref_fwd = table["materialized"][0](q, k, v)
    ref_grads = table["materialized"][1](q, k, v, dout)
    eps = 2.0 ** -7
    results = []
    for name, (fwd, fwd_bwd, yardstick) in table.items():
        got = fwd(q, k, v)
        grads = fwd_bwd(q, k, v, dout)
        row = {
            "route": name,
            "yardstick": yardstick,
            "maxerr": (got.float() - ref_fwd.float()).abs().max().item(),
            "row_rel_err": row_rel_err(got, ref_fwd),
            "bwd_maxerr": max((g.float() - r.float()).abs().max().item() for g, r in zip(grads, ref_grads)),
            "bwd_row_rel_err": max(row_rel_err(g, r, floor=eps * eps) for g, r in zip(grads, ref_grads)),
        }
        del got, grads
        t_fwd = chain_time(lambda s: fwd(q, k, v), None, dev, n_short, n_long)
        t_bwd = chain_time(lambda s: fwd_bwd(q, k, v, dout), None, dev, n_short, n_long)
        row.update(fwd_ms=t_fwd * 1e3, fwd_bwd_ms=t_bwd * 1e3, fwd_tflops=fl / t_fwd / 1e12 if t_fwd > 0 else None,
                   fwd_bwd_tflops=3.5 * fl / t_bwd / 1e12 if t_bwd > 0 else None)
        results.append(row)
        tf = lambda x: f"{x:5.1f}" if x is not None else "  n/a"  # noqa: E731
        print(f"{LABELS[name]:28s} fwd {row['fwd_ms']:8.3f}ms ({tf(row['fwd_tflops'])} TF/s)   fwd+bwd "
              f"{row['fwd_bwd_ms']:8.3f}ms ({tf(row['fwd_bwd_tflops'])} TF/s)  maxerr={row['maxerr']:.3e} "
              f"row_rel={row['row_rel_err']:.3e} bwd_row_rel={row['bwd_row_rel_err']:.3e}", file=out)
    return {"shape": {"B": b, "H": h, "T": t, "D": d}, "device": str(dev), "ideal_fwd_ms": ideal_ms,
            "routes": results}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_attn", description=__doc__.splitlines()[0])
    p.add_argument("head_dim", nargs="?", type=int, default=D)
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--heads", type=int, default=H)
    p.add_argument("--seq", type=int, default=T)
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    res = run(args.batch, args.heads, args.seq, args.head_dim, args.device)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
