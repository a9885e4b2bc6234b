"""``lint_traces --soak`` and ``--federation`` on gloo ranks, on the CPU.

Each runs ``python -m thunder_tpu_torch.scripts.lint_traces`` in a process of
its own, which runs its soak script with ``--smoke --seed 7 --device cpu``: the
fleet soak on 4 gloo ranks (fsdp2 x tp2; a host loss shrinks it to the grid
over the first 2 ranks), the pod soak on 2 slices of 2 gloo ranks. Each
rank's output goes to a file of its own, and each lint process's output to
a file in the test's directory. Both exit 0: every check of the JAX CLI's
smokes holds, and each ends with the gate of the port's own series
(``H100_SOAK_r*.json``, ``H100_SOAK_POD_r*.json``), which holds no
committed round: one line names the glob and its 0 rounds, and ``--soak``
says it has no round to compare its recovery seconds a fault with.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 300


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return env


@pytest.mark.parametrize("mode,wants", [
    ("--soak", ("policy coverage OK", "detectors OK", "torn-write fall-through OK",
                "0 round(s) of H100_SOAK_r*.json to compare with", "series gate [H100_SOAK_r*.json]: 0 round(s)",
                "lint_traces --soak: 0 error(s)")),
    ("--federation", ("budget OK", "elastic cycle OK", "peer-tier proof OK",
                      "series gate [H100_SOAK_POD_r*.json]: 0 round(s)", "lint_traces --federation: 0 error(s)")),
], ids=["soak", "federation"])
def test_lint_soak_smokes_exit_0_on_gloo_ranks(mode, wants, tmp_path):
    log = tmp_path / "lint.log"
    env = _env()
    env["TMPDIR"] = str(tmp_path)
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "thunder_tpu_torch.scripts.lint_traces", mode],
                                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=REPO)
        try:
            rc = proc.wait(timeout=SPAWN_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = log.read_text()
    assert rc == 0, out[-4000:]
    for want in wants:
        assert want in out, (want, out[-4000:])
    assert "waits for the port's benchmark PR" not in out
