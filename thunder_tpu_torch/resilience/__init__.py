"""The resilient execution runtime: the recovery layer.

The counterpart of ``thunder_tpu/resilience``. The runtime does not die on
an injected kernel fault, an out-of-memory, a NaN step, a torn kernel
library, a hung collective or a preemption:

- :mod:`~thunder_tpu_torch.resilience.chaos`: deterministic, seedable fault
  injection at named seams (``THUNDER_TPU_CHAOS=<spec>`` /
  ``jit(chaos=...)``), each injection a ``fault_injected`` event;
- :mod:`~thunder_tpu_torch.resilience.demotion`: the (sym, executor)
  quarantine registry consulted by the claiming pass, and the failure
  classification (only an injected kernel fault demotes a kernel);
- :mod:`~thunder_tpu_torch.resilience.deopt`: the compile de-optimization
  ladder with bounded retry/backoff, the recovery driver ``api._dispatch``
  calls, and the post-step isfinite guard (``jit(on_nan=...)``);
- :mod:`~thunder_tpu_torch.resilience.compile_cache`: the sweep of the
  kernel build directory (torn entries removed and rebuilt);
- :mod:`~thunder_tpu_torch.resilience.watchdog`: the collective watchdog
  and the SDC guard (cross-replica checksums, quarantine + re-run);
- :mod:`~thunder_tpu_torch.resilience.snapshot`: the RAM checkpoint tiers;
- :mod:`~thunder_tpu_torch.resilience.preemption`: SIGTERM-triggered
  step-boundary checkpointing, the checkpoint manager, ``resume`` and
  ``run_training``;
- :mod:`~thunder_tpu_torch.resilience.elastic`: the tiered restore and the
  resharded resume onto a smaller mesh.

The fleet layer of the JAX package's ``resilience`` (the autopilot, the
federation and their names: ``Autopilot``, ``AutopilotHalt``, ``Policy``,
``Signal``, ``run_autopiloted_training``, ``FederationLedger``,
``FleetController``, ``FleetReport``, ``run_federated_training``) is not
ported yet.
"""

from thunder_tpu_torch.resilience.chaos import (  # noqa: F401
    ChaosConfig,
    ChaosError,
    InjectedCheckpointError,
    InjectedCompileError,
    InjectedCompileTimeout,
    InjectedKernelError,
    InjectedOOMError,
    chaos_scope,
    parse_spec,
)
from thunder_tpu_torch.resilience.demotion import (  # noqa: F401
    clear_quarantine,
    is_quarantined,
    quarantine,
    quarantine_snapshot,
)
from thunder_tpu_torch.resilience.deopt import NonFiniteOutputError  # noqa: F401
from thunder_tpu_torch.resilience.elastic import (  # noqa: F401
    elastic_resume,
    reshard_state,
    tiered_restore,
)
from thunder_tpu_torch.resilience.preemption import (  # noqa: F401
    CheckpointManager,
    CheckpointRestoreError,
    CheckpointWriteError,
    HostLost,
    Preempted,
    PreemptionGuard,
    resume,
    run_training,
)
from thunder_tpu_torch.resilience.snapshot import Snapshot, SnapshotStore  # noqa: F401
from thunder_tpu_torch.resilience.watchdog import (  # noqa: F401
    CollectiveTimeoutError,
    SDCDetectedError,
    SDCGuard,
)

__all__ = [
    "ChaosConfig", "ChaosError", "parse_spec", "chaos_scope",
    "InjectedKernelError", "InjectedCompileError", "InjectedCompileTimeout",
    "InjectedOOMError", "InjectedCheckpointError",
    "quarantine", "is_quarantined", "clear_quarantine", "quarantine_snapshot",
    "NonFiniteOutputError",
    "PreemptionGuard", "CheckpointManager", "CheckpointWriteError",
    "CheckpointRestoreError", "resume", "run_training",
    "Preempted", "HostLost",
    "CollectiveTimeoutError", "SDCDetectedError", "SDCGuard",
    "elastic_resume", "reshard_state", "tiered_restore",
    "Snapshot", "SnapshotStore",
]
