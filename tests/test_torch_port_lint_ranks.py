"""The trace verifier's rank modes on 4 gloo ranks, on the CPU.

``python -m thunder_tpu_torch.scripts.lint_traces --chaos-multihost`` and
``--hlo``, the counterparts of ``scripts/lint_traces.py``'s modes of the same
names, which run on 8 virtual devices in one process: the port runs each as
4 gloo ranks of the module (one process a rank, meeting on a FileStore,
each rank's output in a file of its own, ``SPAWN_TIMEOUT_S`` a spawn).

- ``--chaos-multihost``: gpt-tiny's fsdp2·tp2 AdamW step; a collective hang
  raises the typed timeout naming its ``synchronize`` line and the
  straggler host; a host loss checkpoints and the first 2 ranks resume it on
  fsdp2, reproducing the uninterrupted losses to rtol 1e-5; an SDC injection
  is caught and re-run bit for bit; the ranks' merged event logs pair every
  fault with its recovery.
- ``--hlo``: the compiled-program audit of the fsdp2·tp2 step: every
  collective site is an explicit line of the trace but the loss's
  all-reduce, which is named inserted, as is an all-reduce planted beside
  the step; the report is schema-valid. The JAX wording
  "partitioner-inserted" has no seat: the port spells its collectives in
  the trace.
"""

import os
import subprocess
import sys

from thunder_tpu_torch.scripts.lint_traces import SPAWN_TIMEOUT_S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint(mode: str, tmp_path) -> str:
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "WORLD_SIZE", "RANK")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    log = tmp_path / "lint.log"
    with open(log, "w") as f:
        proc = subprocess.run([sys.executable, "-m", "thunder_tpu_torch.scripts.lint_traces", mode],
                              stdout=f, stderr=subprocess.STDOUT, env=env, cwd=REPO, timeout=SPAWN_TIMEOUT_S + 60)
    out = log.read_text()
    assert proc.returncode == 0, out[-5000:]
    assert "FAILED" not in out
    return out


def test_chaos_multihost_on_four_gloo_ranks(tmp_path):
    out = _lint("--chaos-multihost", tmp_path)
    for ok in ("typed timeout OK", "elastic resume OK", "SDC quarantine + re-run OK",
               "lint_traces --chaos-multihost: 0 error(s) on rank 0"):
        assert ok in out
    assert "suspect=host3" in out and "unrecovered: 0" in out


def test_hlo_audit_on_four_gloo_ranks(tmp_path):
    out = _lint("--hlo", tmp_path)
    for ok in ("sites OK", "planted OK", "schema OK", "garbage OK", "lint_traces --hlo: 0 error(s) on rank 0"):
        assert ok in out

