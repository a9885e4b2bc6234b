"""Distributed benchmark runner: sweep mesh configurations, one process a rank.

The counterpart of ``thunder_tpu/benchmarks/distributed.py`` (reference
parity: thunder/benchmarks/distributed.py, ``run_multiprocess_benchmark:605``,
one process a rank, aggregated). The JAX package runs each configuration as
one process over a mesh of real or virtual devices; the port runs it as
its ranks: one process of the LitGPT CLI
(``thunder_tpu_torch.benchmarks.litgpt``) a rank, joined through the
``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` environment on a
free port of this host. ``--device cpu`` spawns gloo ranks on the CPU (the
no-hardware run the tests use); on the card each rank takes the card of its
``LOCAL_RANK``, so a machine runs as many NCCL ranks as it has cards (one,
on the H100 machine).

Usage:
    python -m thunder_tpu_torch.benchmarks.distributed --model pythia-160m \\
        --configs dp2,fsdp2,fsdp2-tp2 --device cpu --iters 5

Each configuration prints rank 0's JSON summary of the CLI (tokens/s,
TFLOP/s, MFU, memory, iteration time) tagged with the mesh, or an error
dict: a bad spec, an axis the CLI does not expose, a timeout, a rank that
failed, or a line that does not parse.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from typing import Sequence


def parse_config(spec: str) -> dict:
    """'dp2-fsdp2-tp2' → {'dp': 2, 'fsdp': 2, 'tp': 2}."""
    import re

    axes: dict[str, int] = {}
    for part in spec.split("-"):
        m = re.fullmatch(r"(dp|pp|fsdp|ep|sp|tp)(\d+)", part)
        if not m:
            raise ValueError(f"Bad mesh spec {spec!r} (part {part!r})")
        if m.group(1) in axes:
            raise ValueError(f"Duplicate axis {m.group(1)!r} in mesh spec {spec!r}")
        axes[m.group(1)] = int(m.group(2))
    return axes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_config(spec: str, *, model: str, micro_batch: int, seq: int, iters: int, device: str = "cuda",
               extra: Sequence[str] = (), timeout: float = 1800.0) -> dict:
    """Run the LitGPT CLI on the mesh ``spec`` as its ranks, one process
    each, and return rank 0's summary with ``mesh`` set to ``spec``.
    ``extra`` adds CLI arguments (``--optimizer sgd``, ``--dtype float32``,
    ...); ``timeout`` bounds the whole run, after which every rank is
    killed."""
    try:
        axes = parse_config(spec)
    except ValueError as e:
        return {"mesh": spec, "error": str(e)}
    cmd = [sys.executable, "-m", "thunder_tpu_torch.benchmarks.litgpt", "--model", model,
           "--micro-batch", str(micro_batch), "--seq", str(seq), "--iters", str(iters), "--device", device,
           *extra]
    world = 1
    for ax, n in axes.items():
        if ax not in ("dp", "fsdp", "tp"):
            return {"mesh": spec, "error": f"axis {ax} not exposed by the litgpt CLI"}
        cmd += [f"--{ax}", str(n)]
        world *= n

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world))
    if device == "cpu":
        env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.{k}"), "w+") for r in range(world) for k in ("out", "err")]
        procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=logs[2 * r],
                                  stderr=logs[2 * r + 1], text=True) for r in range(world)]
        try:
            for p in procs:
                p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return {"mesh": spec, "error": f"timed out after {timeout:g} s"}
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            texts = []
            for f in logs:
                f.seek(0)
                texts.append(f.read())
                f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            return {"mesh": spec, "error": f"rank {r} exited {p.returncode}: {texts[2 * r + 1][-500:]}"}
    out_text = texts[0]
    try:
        out = json.loads(out_text.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return {"mesh": spec, "error": f"unparseable output: {out_text[-300:]}"}
    out["mesh"] = spec
    return out


def weak_scaling(*, model: str, micro_batch: int, seq: int, iters: int, axis: str = "dp", max_devices: int = 8,
                 device: str = "cuda", extra: Sequence[str] = ()) -> list[dict]:
    """Weak-scaling sweep: the rank count doubles while the batch a rank
    stays constant, so ideal scaling is flat iteration time and linear
    tokens/s. Each point runs as its own ranks."""
    points = []
    n = 1
    while n <= max_devices:
        spec = f"{axis}{n}" if n > 1 else "dp1"
        out = run_config(spec, model=model, micro_batch=micro_batch * n, seq=seq, iters=iters, device=device,
                         extra=extra)
        out["devices"] = n
        out["global_batch"] = micro_batch * n
        base = points[0] if points else out
        if "tokens_per_sec" in out and "tokens_per_sec" in base:
            out["scaling_efficiency"] = round(out["tokens_per_sec"] / (base["tokens_per_sec"] * n), 3)
        points.append(out)
        n *= 2
    return points


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="pythia-160m")
    p.add_argument("--micro-batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--configs", default="dp2,fsdp2,fsdp2-tp2")
    p.add_argument("--device", default="cuda", help="cuda (NCCL ranks, one a card) or cpu (gloo ranks)")
    p.add_argument("--weak-scaling", default="",
                   help="axis to weak-scale over (dp|fsdp): 1→N ranks, constant batch a rank")
    p.add_argument("--max-devices", type=int, default=8)
    args, extra = p.parse_known_args(argv)

    if args.weak_scaling:
        for point in weak_scaling(model=args.model, micro_batch=args.micro_batch, seq=args.seq, iters=args.iters,
                                  axis=args.weak_scaling, max_devices=args.max_devices, device=args.device,
                                  extra=extra):
            print(json.dumps(point), flush=True)
        return

    for spec in args.configs.split(","):
        spec = spec.strip()
        if not spec:
            continue
        summary = run_config(spec, model=args.model, micro_batch=args.micro_batch, seq=args.seq,
                             iters=args.iters, device=args.device, extra=extra)
        print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
