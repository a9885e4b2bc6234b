"""Deterministic fault injection at named seams.

The counterpart of ``thunder_tpu/resilience/chaos.py``, with its grammar, its
seams and its per-process RNG unchanged, so a seeded spec fires on the same
draws in both packages. Faults are injected at **named seams**, fixed points
in the runtime where production failures occur, so every recovery path
(executor demotion, the compile de-opt ladder, checkpoint retry, preemption
sync) can be exercised deterministically on the CPU instead of waiting for a
card or a host to misbehave.

Seams and their typed errors:

=================  =====================================================
``kernel_raise``   a claimed kernel wrapper raises at its first run
                   (:class:`InjectedKernelError`; recovery: demotion)
``compile_fail``   the compile of an entry fails (:class:`InjectedCompileError`;
                   recovery: de-opt ladder)
``compile_timeout`` the compile times out (:class:`InjectedCompileTimeout`)
``oom``            device OOM at run (:class:`InjectedOOMError`, its message
                   that of the CUDA allocator; recovery: de-opt ladder)
``nan``            NaN-poisons a chosen BoundSymbol's output (a trace
                   pass; recovery: post-step isfinite guard + attribution)
``straggler``      collective straggler: sleeps ``~<delay>`` seconds at
                   the dispatch seam (recovery: none needed, run completes)
``ckpt_io``        checkpoint-write I/O error
                   (:class:`InjectedCheckpointError`; recovery: retry/
                   backoff in :class:`~.preemption.CheckpointManager`)
``preempt``        preemption signal at a chosen training step (recovery:
                   step-boundary checkpoint + resume)
``cache_corrupt``  truncates an entry of the kernel build directory
                   (recovery: :mod:`~.compile_cache` sweep and a rebuild)
``collective_hang`` a peer stops participating in a collective: sleeps
                   ``~<delay>`` seconds inside the watchdog-guarded
                   dispatch (recovery: :mod:`~.watchdog` raises a typed
                   :class:`~.watchdog.CollectiveTimeoutError`)
``host_loss``      a host dies at a chosen training step (recovery:
                   step-boundary checkpoint agreement + elastic resume on
                   the surviving mesh, :mod:`~.elastic`)
``sdc``            silent data corruption: flips one mantissa bit in one
                   data-parallel replica of the training state (recovery:
                   the SDC replica-checksum guard quarantines and re-runs
                   the step, :class:`~.watchdog.SDCGuard`)
``sched_bad``      corrupts a comm-scheduler placement (recovery: the
                   scheduler's own validation falls back to program order)
``snap_torn``      torn write on the background checkpoint flush: the
                   step directory lands WITHOUT its META commit marker
                   (recovery: restore skips the incomplete step)
``snap_corrupt``   flips one bit in the newest RAM-tier snapshot
                   (``@local`` / ``@peer`` / ``@local,peer``; recovery:
                   the tiered restore's checksum gate falls through to
                   the next tier, :mod:`~.snapshot`)
``snap_slow``      slow background flush: sleeps ``~<delay>`` seconds
                   inside the writer thread (recovery: the flush still
                   commits; backpressure coalesces queued snapshots)
``slice_loss``     a whole slice of a federated fleet dies at a chosen step
``dcn_partition``  the cross-slice network partitions at a chosen step
``slice_slow``     one slice's step time inflates by ``~<delay>`` seconds
``slice_flap``     a slice fails and recovers faster than the rejoin window
=================  =====================================================

The four slice seams fire at the step boundaries of the federated driver
(``resilience/federation.run_federated_training``), which recovers from them
through the autopilot's ``shrink_dp``/``regrow_dp`` decisions.

Spec grammar (``THUNDER_TPU_CHAOS=<spec>`` or ``jit(chaos=<spec>)``)::

    spec      := component (";" component)*
    component := "seed=" INT
               | seam ["@" target] ["*" count] ["%" prob] ["~" delay_s]
    target    := clause ("," clause)*
    clause    := "host=" INT | "slice=" INT | <seam-specific target>
    count     := INT | "inf"          (default 1: fire once, then disarm)
    prob      := FLOAT in (0, 1]      (default 1.0; drawn from the seeded RNG)
    delay_s   := FLOAT                (straggler sleep seconds, default 0.01)

``target`` is seam-specific: for ``kernel_raise`` an executor name or
``executor:op`` substring, with the port's executor names (``flash``,
``fused``, ``norm``, ``quant``); for ``nan`` a BoundSymbol-name substring or
``L<index>``; for ``preempt``/``host_loss`` the step number; for ``sdc``
the replica ordinal to corrupt; for ``oom`` an optional ``<LEVEL`` clause
(``oom@<3*inf``) that keeps firing while the entry's de-opt ladder level is
below LEVEL. A ``host=N`` clause restricts any seam to the process of rank
N (``torch.distributed``; ``THUNDER_TPU_CHAOS_PROCESS_INDEX`` overrides the
index for single-process tests). Examples::

    THUNDER_TPU_CHAOS="kernel_raise@flash*1"
    THUNDER_TPU_CHAOS="oom*2;seed=7"
    THUNDER_TPU_CHAOS="nan@tanh;preempt@3"
    THUNDER_TPU_CHAOS="collective_hang@host=2~30;seed=5"
    THUNDER_TPU_CHAOS="host_loss@3,host=1"

Every injection emits a ``fault_injected`` JSONL event and increments
``thunder_tpu_faults_injected_total{seam=...}``. Injection decisions are
deterministic given the spec (counts + seeded RNG). The probability RNG is
seeded from the ``(seed, slice_id, host_id)`` coordinate through a stable
hash, so every process draws its own replayable stream, collision-free when
a fleet shrinks and its hosts are renumbered.

A kernel seam fires only when Python runs the wrapper: an eager run, or the
run a CUDA-graph capture records. A replay of a captured graph never reaches
it (as a cached ``jax.jit`` executable never re-traces).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import time
from dataclasses import dataclass, field
from typing import Optional

from thunder_tpu_torch.observability import events as obs_events
from thunder_tpu_torch.observability import metrics as obsm

SEAMS = (
    "kernel_raise", "compile_fail", "compile_timeout", "oom", "nan",
    "straggler", "ckpt_io", "preempt", "cache_corrupt",
    "collective_hang", "host_loss", "sdc", "sched_bad",
    "snap_torn", "snap_corrupt", "snap_slow",
    "slice_loss", "dcn_partition", "slice_slow", "slice_flap",
)


def process_index() -> int:
    """This process's index in the job: ``THUNDER_TPU_CHAOS_PROCESS_INDEX``
    when set (single-process simulation, tests), else the
    ``torch.distributed`` rank of an initialized default group, else 0.
    Chaos never initializes a process group."""
    env = os.environ.get("THUNDER_TPU_CHAOS_PROCESS_INDEX", "").strip()
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def slice_id() -> int:
    """This process's slice in a federated fleet: ``THUNDER_TPU_SLICE_ID``
    when set (the federation driver and single-process emulation set it),
    else 0 — a plain single-slice job is slice 0 of a one-slice fleet."""
    env = os.environ.get("THUNDER_TPU_SLICE_ID", "").strip()
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    return 0


def _derive_seed(seed: int, slice_: int, host: int) -> int:
    """Stable per-process RNG seed from the ``(seed, slice, host)``
    coordinate. A keyed hash, not arithmetic: ``seed + host`` collides when
    the fleet renumbers hosts after a shrink (host 3's old schedule becomes
    host 2's new one), and Python's ``hash()`` is per-process randomized
    for strings — neither replays."""
    import hashlib

    h = hashlib.blake2s(f"{seed}:{slice_}:{host}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class ChaosError(RuntimeError):
    """Base of every chaos-injected error. ``seam`` names the injection
    point so an unrecovered fault fails loudly with its origin."""

    seam = "unknown"

    def __init__(self, msg: str, *, target: Optional[str] = None):
        self.target = target
        super().__init__(msg)


class InjectedKernelError(ChaosError):
    """A claimed executor kernel raised (chaos seam ``kernel_raise``)."""

    seam = "kernel_raise"

    def __init__(self, executor: str, op: str):
        self.executor = executor
        self.op = op
        super().__init__(
            f"chaos[kernel_raise]: injected kernel failure in executor "
            f"{executor!r} op {op!r}",
            target=f"{executor}:{op}",
        )


class InjectedCompileError(ChaosError):
    seam = "compile_fail"

    def __init__(self, fn_name: str = "?"):
        super().__init__(
            f"chaos[compile_fail]: injected compile failure for {fn_name!r}",
            target=fn_name,
        )


class InjectedCompileTimeout(InjectedCompileError):
    seam = "compile_timeout"

    def __init__(self, fn_name: str = "?"):
        ChaosError.__init__(
            self,
            f"chaos[compile_timeout]: injected compile timeout for {fn_name!r}",
            target=fn_name,
        )


class InjectedOOMError(ChaosError):
    seam = "oom"

    def __init__(self):
        super().__init__(
            "chaos[oom]: CUDA out of memory (injected device out-of-memory)"
        )


class InjectedCheckpointError(OSError):
    """Transient checkpoint-write I/O failure (chaos seam ``ckpt_io``).
    An OSError so the checkpoint retry path treats it like a real disk/
    network write error."""

    seam = "ckpt_io"

    def __init__(self):
        super().__init__("chaos[ckpt_io]: injected checkpoint write I/O error")


@dataclass
class FaultRule:
    """One armed fault: fires up to ``count`` times with probability
    ``prob`` per opportunity (drawn from the config's seeded RNG)."""

    seam: str
    target: Optional[str] = None
    count: float = 1  # float so "inf" parses; compared against fired
    prob: float = 1.0
    delay_s: float = 0.01
    host: Optional[int] = None  # host=N clause: only this process fires
    slice: Optional[int] = None  # slice=N clause: the victim/targeted slice
    fired: int = 0

    def exhausted(self) -> bool:
        return self.fired >= self.count

    def matches(self, target: Optional[str]) -> bool:
        if self.target is None:
            return True
        if target is None:
            return False
        return self.target in str(target)

    def host_matches(self) -> bool:
        return self.host is None or self.host == process_index()


@dataclass
class ChaosConfig:
    """Parsed chaos spec: rules + the seeded RNG driving probability draws.

    The RNG is created lazily on first draw and seeded from the hashed
    ``(seed, slice_id(), process_index())`` coordinate: each process gets
    its own replayable stream that stays collision-free across fleet
    shrink/regrow renumbering (laziness
    matters: specs parse before the process group knows the rank)."""

    rules: list = field(default_factory=list)
    seed: int = 0

    def __post_init__(self):
        self._rng: Optional[random.Random] = None

    @property
    def rng(self) -> random.Random:
        if self._rng is None:
            self._rng = random.Random(
                _derive_seed(self.seed, slice_id(), process_index())
            )
        return self._rng

    def rules_for(self, seam: str):
        return [r for r in self.rules if r.seam == seam]


def parse_spec(spec: str) -> ChaosConfig:
    """Parse the chaos spec grammar (module docstring) into a
    :class:`ChaosConfig`. Raises ``ValueError`` on unknown seams or
    malformed components — a chaos run with a typo'd spec must fail loudly,
    not silently inject nothing."""
    rules: list[FaultRule] = []
    seed = 0
    for comp in str(spec).split(";"):
        comp = comp.strip()
        if not comp:
            continue
        if comp.startswith("seed="):
            seed = int(comp[len("seed="):])
            continue
        rule = FaultRule(seam="")
        rest = comp
        # Peel *count / %prob / ~delay suffixes from the right, in whatever
        # order they were written.
        _attr = {"*": "count", "%": "prob", "~": "delay_s"}
        while True:
            pos = max(rest.rfind(sep) for sep in _attr)
            if pos <= 0:
                break
            sep = rest[pos]
            rest, val = rest[:pos], rest[pos + 1:].strip()
            if sep == "*":
                rule.count = float("inf") if val == "inf" else int(val)
            else:
                setattr(rule, _attr[sep], float(val))
        if "@" in rest:
            rest, _, target = rest.partition("@")
            # A target is a comma-list of clauses; "host=N" clauses restrict
            # the rule to that process, the remainder is the seam target.
            plain = []
            for clause in target.split(","):
                clause = clause.strip()
                if clause.startswith("host=") or clause.startswith("slice="):
                    attr, _, val = clause.partition("=")
                    try:
                        setattr(rule, attr, int(val))
                    except ValueError:
                        raise ValueError(
                            f"chaos spec: malformed {attr} clause {clause!r} "
                            f"in component {comp!r}"
                        ) from None
                elif clause:
                    plain.append(clause)
            rule.target = ",".join(plain) or None
        rule.seam = rest.strip()
        if rule.seam not in SEAMS:
            raise ValueError(
                f"chaos spec: unknown seam {rule.seam!r} in component {comp!r} "
                f"(known: {', '.join(SEAMS)})"
            )
        if not (0.0 < rule.prob <= 1.0):
            raise ValueError(f"chaos spec: prob must be in (0, 1], got {rule.prob}")
        rules.append(rule)
    return ChaosConfig(rules=rules, seed=seed)


# -- activation ----------------------------------------------------------------

_scope: contextvars.ContextVar[Optional[ChaosConfig]] = contextvars.ContextVar(
    "thunder_tpu_chaos", default=None
)
_env = {"resolved": False, "config": None}


def _env_config() -> Optional[ChaosConfig]:
    if not _env["resolved"]:
        spec = os.environ.get("THUNDER_TPU_CHAOS", "").strip()
        _env["config"] = parse_spec(spec) if spec else None
        _env["resolved"] = True
    return _env["config"]


def reset_env_config() -> None:
    """Re-read ``THUNDER_TPU_CHAOS`` on next use (tests)."""
    _env["resolved"] = False
    _env["config"] = None


def active() -> Optional[ChaosConfig]:
    cfg = _scope.get()
    if cfg is not None:
        return cfg
    return _env_config()


def enabled() -> bool:
    return active() is not None


@contextlib.contextmanager
def chaos_scope(config):
    """Activate a chaos config (spec string or :class:`ChaosConfig`) within
    the scope; ``None`` leaves the ambient config in place."""
    if config is None:
        yield None
        return
    if isinstance(config, str):
        config = parse_spec(config)
    tok = _scope.set(config)
    try:
        yield config
    finally:
        _scope.reset(tok)


def resolve(config) -> Optional[ChaosConfig]:
    """Normalize a ``jit(chaos=...)`` value (None | spec str | config)."""
    if config is None or isinstance(config, ChaosConfig):
        return config
    return parse_spec(str(config))


# -- injection core ------------------------------------------------------------


def _should_fire(seam: str, target: Optional[str] = None,
                 matcher=None) -> Optional[FaultRule]:
    """One copy of the fire-decision protocol (exhausted → match → host →
    prob draw → fired/record). ``matcher(rule) -> bool`` replaces the
    default substring ``rule.matches(target)`` for seams whose target
    grammar is not a substring (the oom ``<LEVEL`` ceiling)."""
    cfg = active()
    if cfg is None:
        return None
    for rule in cfg.rules_for(seam):
        if rule.exhausted() or not rule.host_matches():
            continue
        if not (matcher(rule) if matcher is not None else rule.matches(target)):
            continue
        if rule.prob < 1.0 and cfg.rng.random() >= rule.prob:
            continue
        rule.fired += 1
        _record(rule, target)
        return rule
    return None


def _record(rule: FaultRule, target: Optional[str]) -> None:
    if obsm.enabled():
        obsm.FAULTS_INJECTED.inc(seam=rule.seam)
    obs_events.emit_event(
        "fault_injected",
        seam=rule.seam,
        target=target if target is not None else rule.target,
        n=rule.fired,
    )


# -- seams ---------------------------------------------------------------------


def kernel_seam(executor: str, op: str) -> None:
    """Called at the top of each kernel wrapper's implementation (flashex,
    fusedex, normex, quantex): raise :class:`InjectedKernelError` when an armed
    ``kernel_raise`` rule matches ``executor`` or ``executor:op``."""
    if active() is None:  # one-None-check fast path: chaos off costs nothing
        return
    if _should_fire("kernel_raise", f"{executor}:{op}") is not None:
        raise InjectedKernelError(executor, op)


def compile_seam(fn_name: str) -> None:
    """Compile-pipeline seam (``api._compile_entry_impl``): injected compile
    failure or timeout."""
    if active() is None:
        return
    if _should_fire("compile_timeout", fn_name) is not None:
        raise InjectedCompileTimeout(fn_name)
    if _should_fire("compile_fail", fn_name) is not None:
        raise InjectedCompileError(fn_name)


def run_seam(has_collectives: bool = False, deopt_level: int = 0) -> None:
    """Dispatch-time seam (``api._dispatch``, inside a CUDA-graph capture
    when the entry is capturing): device OOM, and the collective
    straggler delay (fires on any entry when the rule's target is ``any``,
    else only on traces containing collectives).

    The ``oom`` seam's target grammar: ``oom`` (fire per its count, as
    before) or ``oom@<L`` — keep firing while the dispatched entry's de-opt
    ladder level is **below** L. The latter is a deterministic memory
    ceiling: exactly what a card whose memory only fits ladder level L
    looks like."""
    if active() is None:
        return

    def _oom_matches(rule: FaultRule) -> bool:
        t = rule.target
        if not t:
            return True
        if not t.startswith("<"):
            return False  # oom has no other target form
        try:
            return deopt_level < int(t[1:])
        except ValueError:
            return False

    if _should_fire("oom", f"level{deopt_level}", matcher=_oom_matches) is not None:
        raise InjectedOOMError()
    cfg = active()
    for rule in cfg.rules_for("straggler"):
        if rule.exhausted() or not rule.host_matches():
            continue
        if rule.target == "step":
            continue  # guarded-step-only rules fire in straggler_seam()
        if rule.target != "any" and not has_collectives:
            continue
        if rule.prob < 1.0 and cfg.rng.random() >= rule.prob:
            continue
        rule.fired += 1
        _record(rule, rule.target)
        time.sleep(rule.delay_s)


def straggler_seam(site: str = "step") -> None:
    """Step-path straggler delay (watchdog.guard_call's worker body): an
    armed ``straggler@step`` rule sleeps ``~<delay>`` seconds inside the
    guarded step — a host slowing down WITHOUT hanging, the drift the
    streaming detectors (observability/detect.py) must flag before the
    watchdog's timeout would. Rules targeting ``any`` (or untargeted) fire
    here too; the dispatch-path straggler in :func:`run_seam` ignores the
    ``step`` target, so the two sites never double-fire a targeted rule."""
    cfg = active()
    if cfg is None:
        return
    for rule in cfg.rules_for("straggler"):
        if rule.exhausted() or not rule.host_matches():
            continue
        if rule.target not in (None, "any", site):
            continue
        if rule.prob < 1.0 and cfg.rng.random() >= rule.prob:
            continue
        rule.fired += 1
        _record(rule, site)
        time.sleep(rule.delay_s)


def sched_seam(site_key: str, placement: int, latest: int) -> int:
    """Comm-scheduler seam (transforms/comm_schedule.py): when an armed
    ``sched_bad`` rule matches the collective site, corrupt the computed
    placement to one past the site's certified ``latest`` — the scheduler's
    own interval validation must catch it and fall back to the unscheduled
    trace (a bad schedule demotes cleanly instead of compiling a potential
    cross-host deadlock). Returns ``placement`` unchanged when not armed."""
    if active() is None:
        return placement
    if _should_fire("sched_bad", site_key) is not None:
        return latest + 8
    return placement


def checkpoint_seam() -> None:
    """Checkpoint-write seam (resilience.preemption.CheckpointManager)."""
    if active() is None:
        return
    if _should_fire("ckpt_io") is not None:
        raise InjectedCheckpointError()


def flush_slow_seam() -> None:
    """Background-flush seam (CheckpointManager's writer thread): an armed
    ``snap_slow`` rule sleeps ``~<delay>`` seconds inside the flush — a
    slow disk or contended network FS. The training loop must not stall
    (the flush is off the hot path) and the single-in-flight backpressure
    must coalesce snapshots queued behind the slow write instead of growing
    an unbounded backlog."""
    if active() is None:
        return
    rule = _should_fire("snap_slow")
    if rule is not None:
        time.sleep(rule.delay_s)


def flush_torn_seam() -> bool:
    """Background-flush seam: True when an armed ``snap_torn`` rule fires —
    the flush must simulate a writer crash between the state write and the
    META commit marker (a step directory in place WITHOUT its marker, the
    torn write the commit protocol exists to catch). The restore path must
    skip the incomplete step and fall through to the next tier/step."""
    if active() is None:
        return False
    return _should_fire("snap_torn") is not None


def snapshot_corrupt_seam(store) -> None:
    """Restore-time seam (the tiered restore in ``resilience/elastic``):
    an armed ``snap_corrupt`` rule flips one bit in the newest snapshot of
    the targeted RAM tier — ``@local``, ``@peer`` (default), or
    ``@local,peer`` for both — before the tiers are validated, so the
    checksum gate must catch it and fall through. A rule that finds
    nothing to corrupt (empty tier) stays armed rather than recording an
    injection that never happened (the cache_corrupt discipline)."""
    cfg = active()
    if cfg is None or store is None:
        return
    for rule in cfg.rules_for("snap_corrupt"):
        if rule.exhausted() or not rule.host_matches():
            continue
        tiers = [t.strip() for t in (rule.target or "peer").split(",")
                 if t.strip() in ("local", "peer")] or ["peer"]
        if rule.prob < 1.0 and cfg.rng.random() >= rule.prob:
            continue
        corrupted = [t for t in tiers if store.corrupt_newest(t)]
        if not corrupted:
            continue
        rule.fired += 1
        _record(rule, ",".join(corrupted))


def preempt_at_step(step: int) -> bool:
    """Training-loop seam: True when an armed ``preempt`` rule targets this
    step (exact match — ``preempt@3`` must not also fire at step 13) or has
    no target. The caller treats it exactly like a SIGTERM."""
    return _step_seam_fires("preempt", step)


def host_loss_at_step(step: int) -> bool:
    """Training-loop seam: True when an armed ``host_loss`` rule targets
    this step (or has no step target). The caller checkpoints at the step
    boundary and raises :class:`~.preemption.HostLost` — the surviving
    processes' elastic-resume path (``resilience/elastic.py``) continues on
    a shrunk mesh from that agreed checkpoint."""
    return _step_seam_fires("host_loss", step)


def _step_seam_fires(seam: str, step: int) -> bool:
    cfg = active()
    if cfg is None:
        return False
    for rule in cfg.rules_for(seam):
        if rule.exhausted() or not rule.host_matches():
            continue
        if rule.target is not None and rule.target != str(step):
            continue
        if rule.prob < 1.0 and cfg.rng.random() >= rule.prob:
            continue
        rule.fired += 1
        _record(rule, str(step))
        return True
    return False


# -- slice-granular seams (federated fleets, resilience/federation.py) ---------


def _slice_step_seam(seam: str, step: int) -> Optional[int]:
    """Exact-step slice seam: the victim slice id when an armed rule fires
    at ``step`` (``slice=N`` clause, default slice 0), else None."""
    cfg = active()
    if cfg is None:
        return None
    for rule in cfg.rules_for(seam):
        if rule.exhausted() or not rule.host_matches():
            continue
        if rule.target is not None and rule.target != str(step):
            continue
        if rule.prob < 1.0 and cfg.rng.random() >= rule.prob:
            continue
        rule.fired += 1
        victim = rule.slice if rule.slice is not None else 0
        _record(rule, f"step{step}:slice{victim}")
        return victim
    return None


def slice_loss_at_step(step: int) -> Optional[int]:
    """Federated training-loop seam: the slice id an armed ``slice_loss``
    rule kills at this step (``slice_loss@3,slice=1``), or None. The fleet
    controller (``resilience/federation.py``) shrinks the DP group, rescales
    gradient accumulation, and restores the lost replica's contribution
    from the victim's cross-slice buddy peer-RAM snapshot."""
    return _slice_step_seam("slice_loss", step)


def slice_flap_at_step(step: int) -> Optional[int]:
    """Federated training-loop seam: the slice id an armed ``slice_flap``
    rule starts flapping at this step — the driver runs it through a
    fail/recover loop faster than the rejoin hysteresis window, and the
    fleet controller must degrade ONCE (one shrink, one deferred regrow)."""
    return _slice_step_seam("slice_flap", step)


def dcn_partition_at_step(step: int) -> Optional[FaultRule]:
    """Federated training-loop seam: the armed ``dcn_partition`` rule firing
    at this step (exact-step target), else None. The caller severs
    cross-slice snapshot replication (``SnapshotStore.partitioned``) and
    heals it after the rule's ``~<delay>`` seconds — or at its own healing
    boundary — while training continues in-slice."""
    cfg = active()
    if cfg is None:
        return None
    for rule in cfg.rules_for("dcn_partition"):
        if rule.exhausted() or not rule.host_matches():
            continue
        if rule.target is not None and rule.target != str(step):
            continue
        if rule.prob < 1.0 and cfg.rng.random() >= rule.prob:
            continue
        rule.fired += 1
        _record(rule, str(step))
        return rule
    return None


def slice_slow_delay(slice_: int) -> float:
    """Federated step-path seam: seconds slice ``slice_``'s step inflates by
    when an armed ``slice_slow`` rule targets it (``slice=N`` clause;
    untargeted rules slow every slice they're asked about). The cross-slice
    step-time spread detector (observability/detect.py) must flag the
    outlier slice from exactly this drift."""
    cfg = active()
    if cfg is None:
        return 0.0
    total = 0.0
    for rule in cfg.rules_for("slice_slow"):
        if rule.exhausted() or not rule.host_matches():
            continue
        if rule.slice is not None and rule.slice != slice_:
            continue
        if rule.prob < 1.0 and cfg.rng.random() >= rule.prob:
            continue
        rule.fired += 1
        _record(rule, f"slice{slice_}")
        total += rule.delay_s
    return total


def collective_hang_seam() -> None:
    """Collective-dispatch seam, called INSIDE the watchdog-guarded call
    (``resilience/watchdog.guard_call``): an armed ``collective_hang`` rule
    sleeps ``~<delay>`` seconds — a peer that stopped participating, from
    this process's point of view — so a delay longer than the watchdog
    timeout exercises the typed-timeout path end to end."""
    if active() is None:
        return
    rule = _should_fire("collective_hang")
    if rule is not None:
        time.sleep(rule.delay_s)


def corrupt_cache_seam(cache_dir: str) -> Optional[str]:
    """Truncate one entry of a kernel build directory to zero bytes (the
    crash/disk-full corruption mode the sweep repairs). Returns the
    corrupted path."""
    if active() is None:
        return None
    from thunder_tpu_torch.resilience.compile_cache import _entry_files

    # Check there IS something to corrupt before consuming the rule:
    # firing (and recording fault_injected) on an empty cache dir would
    # disarm the rule with no injection and leave an unrecoverable-looking
    # fault event in the log.
    entries = _entry_files(cache_dir)
    if not entries:
        return None
    if _should_fire("cache_corrupt", cache_dir) is None:
        return None
    victim = entries[0]
    with open(victim, "w"):
        pass  # truncate
    return victim


# -- silent-data-corruption seam -----------------------------------------------


def maybe_corrupt_replica(state, *, replica_of=None):
    """When an armed ``sdc`` rule fires, flip one mantissa bit (the lowest
    bit of element 0) of ONE data-parallel replica of the first replicated
    floating leaf of ``state``, in place on the tensor's device: the
    replicas now disagree bitwise, which is what a silent hardware
    corruption looks like. Returns ``state``.

    Each rank holds its own replica, so every rank draws the same rule
    decision and only one rank flips the bit: in the first block's replica
    group, the rank whose ordinal is the rule's target (default 1: a
    non-primary copy, so an honest peer disagrees).
    ``replica_of(i, leaf)`` gives ``(block index, this rank's ordinal among
    the block's replicas, their count)`` or None for a leaf with no
    replicas (``watchdog.replica_layout``; the default treats every leaf as
    replicated over the world). A leaf of one replica cannot host a
    divergence and is skipped."""
    cfg = active()
    if cfg is None or not any(
        not r.exhausted() and r.host_matches() for r in cfg.rules_for("sdc")
    ):
        return state

    import torch

    from thunder_tpu_torch.core.pytree import tree_flatten

    if replica_of is None:
        from thunder_tpu_torch.resilience.watchdog import replica_layout

        replica_of = replica_layout()
    flat, _ = tree_flatten(state)
    for i, leaf in enumerate(flat):
        if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0 or leaf.numel() == 0:
            continue
        if not leaf.is_floating_point():
            continue
        where = replica_of(i, leaf)
        if where is None or where[2] < 2:
            continue
        # The sdc target is the replica ordinal, not a match filter, so rule
        # selection bypasses the generic substring matching.
        rule = None
        for r in cfg.rules_for("sdc"):
            if r.exhausted() or not r.host_matches():
                continue
            if r.prob < 1.0 and cfg.rng.random() >= r.prob:
                continue
            rule = r
            break
        if rule is None:
            return state
        rule.fired += 1
        _record(rule, f"leaf{i}")
        ordinal = int(rule.target) if rule.target and rule.target.isdigit() else 1
        key, mine, count = where
        if not any(key) and mine == min(ordinal, count - 1):
            with torch.no_grad():
                leaf.reshape(-1)[:1].view(torch.uint8)[:1].bitwise_xor_(1)
        return state
    return state


# -- NaN poisoning pass --------------------------------------------------------


def _poison_value(x):
    # Pure function of the tensor: it runs in the staged program and in the
    # instrumented re-run alike, so attribution lands here.
    return x * float("nan")


def maybe_poison_nan(extrace):
    """When an armed ``nan`` rule matches a BoundSymbol of ``extrace``
    (by name substring or ``L<index>``), insert a ``chaos_nan_poison`` op
    after it and rewrite downstream uses to consume the poisoned value.
    Runs after claiming so the poison survives into both the staged entry
    and the instrumented attribution re-run."""
    cfg = active()
    if cfg is None or not cfg.rules_for("nan"):
        return extrace

    from thunder_tpu_torch.core import dtypes
    from thunder_tpu_torch.core.proxies import TensorProxy, variableify
    from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
    from thunder_tpu_torch.core.symbol import Symbol
    from thunder_tpu_torch.core.trace import from_trace, tracectx, wrap_in_trace_provenance

    target_idx = None
    target_out = None
    for i, bsym in enumerate(extrace.bound_symbols):
        outs = [
            o for o in bsym.flat_proxy_outs
            if isinstance(o, TensorProxy) and dtypes.is_inexact_dtype(o.dtype)
        ]
        if not outs:
            continue
        name_key = f"L{i}"
        rule = None
        for r in cfg.rules_for("nan"):
            if r.exhausted():
                continue
            if r.target is None or r.target == name_key or r.target in bsym.sym.name:
                rule = r
                break
        if rule is None:
            continue
        rule.fired += 1
        _record(rule, f"L{i}.{bsym.sym.name}")
        target_idx, target_out = i, outs[0]
        break
    if target_idx is None:
        return extrace

    start = time.perf_counter_ns()
    ntrace = from_trace(extrace)
    with tracectx(ntrace):
        poisoned = TensorProxy(like=target_out)
    poison_sym = Symbol(
        "chaos_nan_poison", meta=None, id="resilience.chaos_nan_poison",
        is_prim=True, python_impl=_poison_value,
    )
    swap = {variableify(target_out): poisoned}
    new_bsyms = []
    for i, bsym in enumerate(extrace.bound_symbols):
        if i <= target_idx:
            new_bsyms.append(bsym)
            if i == target_idx:
                new_bsyms.append(poison_sym.bind(target_out, output=poisoned))
        else:
            new_bsyms.append(bsym.from_bsym_swap_proxies(swap, skip_output=True))
    ntrace.bound_symbols = new_bsyms
    flat_out, spec = tree_flatten(ntrace.output)
    ntrace.output = tree_unflatten(
        [swap.get(variableify(p), p) if isinstance(p, TensorProxy) else p for p in flat_out], spec
    )
    return wrap_in_trace_provenance(ntrace, "Chaos NaN poisoning", start)
