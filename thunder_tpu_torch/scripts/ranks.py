"""One process a rank, for the scripts that run on several ranks.

``spawn_ranks`` starts one ``python -m <module>`` process a rank, each
writing its output to a file of its own, and kills them all at a deadline;
``join_group`` joins one rank's process group on a FileStore (gloo on the
CPU, NCCL on the card). ``lint_traces``' rank modes and the soak drivers
both use them.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Callable

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def join_group(device: str, rank: int, world: int, store_path: str) -> None:
    """Join rank ``rank`` of ``world`` on a FileStore: gloo on the CPU, NCCL
    on card ``rank``."""
    import torch.distributed as tdist

    import thunder_tpu_torch.distributed as td

    kw = {} if device == "cpu" else {"local_device_ids": [rank]}
    td.init(device=device, store=tdist.FileStore(store_path, world), num_processes=world, process_id=rank, **kw)


def spawn_ranks(module: str, rank_argv: Callable[[int, str], list], world: int, workdir: str, timeout_s: float,
                *, cpu: bool) -> tuple[list, bool, list]:
    """Run ``python -m module *rank_argv(r, store)`` for every rank ``r`` of
    ``world``, all meeting on the FileStore ``workdir/store``, rank r's
    output in ``workdir/rank<r>.log``; on the CPU (``cpu``) each rank gets
    one thread and no card. Returns (the ranks' exit codes, whether they
    outlasted ``timeout_s`` and were killed, the log paths)."""
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""),
               THUNDER_TPU_RETRY_BACKOFF_S="0")
    if cpu:
        env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    store = os.path.join(workdir, "store")
    procs, logs = [], []
    for r in range(world):
        logs.append(os.path.join(workdir, f"rank{r}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen([sys.executable, "-m", module, *rank_argv(r, store)],
                                          stdout=f, stderr=subprocess.STDOUT, env=env, cwd=REPO))
    timed_out = False
    try:
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], timed_out, logs


def tail(path: str, n: int) -> list:
    """The last ``n`` lines of a rank's log."""
    with open(path) as f:
        return f.read().strip().splitlines()[-n:]
