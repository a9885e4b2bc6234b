"""Executor demotion: quarantine failing (sym, executor) pairs and re-claim.

The counterpart of ``thunder_tpu/resilience/demotion.py``. The executor model
is a priority-ordered claim list with fallback to the torch executor. This
module holds the process-wide **quarantine registry**: a ``(sym_id,
executor_name) -> expiry`` map that the claiming pass
(``executors/passes.py``) consults, so a recompile after a demotion
re-claims the quarantined ops further down the list (their decompositions,
claimed by ``torch``). Entries expire after a TTL
(``THUNDER_TPU_QUARANTINE_TTL`` seconds, default 300).

The policy, explicit and logged:

- only an injected kernel fault (chaos seam ``kernel_raise``,
  :class:`~.chaos.InjectedKernelError`) classifies as ``KERNEL``. A real
  failure of one of the port's kernels (a failed ``nvcc`` build, a failed
  library load, a non-zero launch status) is not classified at all and
  propagates untouched, so no kernel ever gives way to something else
  unless a chaos rule asked for it;
- every demotion is loud: a ``WARNING`` on the ``thunder_tpu_torch`` logger
  naming the symbol, the executor and the TTL, an ``executor_demoted``
  event, and ``thunder_tpu_executor_demotions_total``;
- the terminal executors (``torch`` and ``python``) are never quarantined.

Also home to the failure classifier the recovery driver (``api._dispatch``)
uses: KERNEL -> quarantine + re-claim, COMPILE/OOM -> the de-opt ladder
(``resilience/deopt.py``), CACHE_CORRUPT -> purge the kernel build
directory, everything else -> propagate.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

from thunder_tpu_torch.observability import events as obs_events
from thunder_tpu_torch.observability import metrics as obsm

logger = logging.getLogger("thunder_tpu_torch")

# Executors that are never quarantined: the terminal fallbacks. Demoting the
# whole ladder would leave nothing to claim with.
_TERMINAL_EXECUTORS = frozenset({"torch", "python"})

# A symbol that a pass rewrote from another claims the same kernels: the
# attention-residual pair (``transforms/attention_residuals.py``) is the
# flash executor's rewrite of (sdpa, sdpa_bwd). Demoting the rewrite demotes
# its source too, so the re-claim does not hand the same kernels back
# through the recompute path.
_REWRITTEN_FROM = {
    "torch.sdpa_fwd_res": "torch.scaled_dot_product_attention",
    "torch.sdpa_bwd_res": "torch.sdpa_bwd",
}


def default_ttl() -> float:
    try:
        return float(os.environ.get("THUNDER_TPU_QUARANTINE_TTL", "300"))
    except ValueError:
        return 300.0


_quarantined: dict[tuple, float] = {}  # (sym_id, executor_name) -> expiry


def quarantine(sym_id, executor_name: str, *, ttl: Optional[float] = None,
               reason: str = "runtime failure") -> bool:
    """Quarantine ``(sym_id, executor_name)`` for ``ttl`` seconds and record
    the demotion (a ``WARNING``, the ``executor_demoted`` event and
    ``thunder_tpu_executor_demotions_total``). Terminal executors are never
    quarantined (returns False)."""
    if executor_name in _TERMINAL_EXECUTORS:
        return False
    ttl = default_ttl() if ttl is None else float(ttl)
    _quarantined[(sym_id, executor_name)] = time.monotonic() + ttl
    logger.warning("executor demoted: %s no longer claims %s for %gs (%s); the op re-claims down the "
                   "executor list", executor_name, sym_id, ttl, reason)
    if obsm.enabled():
        obsm.EXECUTOR_DEMOTIONS.inc(executor=executor_name)
    obs_events.emit_event(
        "executor_demoted",
        sym=str(sym_id),
        executor=executor_name,
        ttl_s=ttl,
        reason=reason,
    )
    return True


def is_quarantined(sym_id, executor_name: str) -> bool:
    """Claiming-pass check: True while the pair's quarantine is unexpired.
    A ``("*", executor)`` entry quarantines the whole executor (used when a
    failure names the executor but the failing op is unknown). Expired
    entries are purged on probe, re-enabling the executor."""
    if not _quarantined:
        return False
    for key in ((sym_id, executor_name), ("*", executor_name)):
        expiry = _quarantined.get(key)
        if expiry is None:
            continue
        if time.monotonic() >= expiry:
            del _quarantined[key]
            continue
        return True
    return False


def quarantine_snapshot() -> dict:
    """{(sym_id, executor): seconds-remaining} for live entries."""
    now = time.monotonic()
    return {k: v - now for k, v in _quarantined.items() if v > now}


def clear_quarantine() -> None:
    _quarantined.clear()


# -- failure classification ----------------------------------------------------

KERNEL = "kernel"
COMPILE = "compile"
OOM = "oom"
CACHE_CORRUPT = "cache_corrupt"

# The CUDA caching allocator's message (torch.OutOfMemoryError's text, and
# what a RuntimeError carries when an allocation fails outside it).
_OOM_MARKERS = ("cuda out of memory", "out of memory")


class KernelCacheCorrupt(RuntimeError):
    """A kernel library in the build directory could not be loaded: a torn
    or truncated file (``executors/_build.py``). Classifies as
    ``CACHE_CORRUPT``: the directory is purged and rebuilt."""


def _root_causes(exc: BaseException):
    """``exc`` and the exceptions it was raised from or during (a failure
    inside a CUDA-graph capture arrives wrapped)."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        yield exc
        exc = exc.__cause__ or exc.__context__


def classify_failure(exc: BaseException) -> Optional[str]:
    """Map an exception from compile/first-run to a recovery class, or None
    when it must propagate. Injected chaos errors classify by construction;
    a real out-of-memory by ``torch.OutOfMemoryError`` or the allocator's
    message; a torn kernel library by :class:`KernelCacheCorrupt`. A real
    kernel failure (build, load or launch) is None: it propagates."""
    import torch

    from thunder_tpu_torch.resilience.chaos import (
        InjectedCompileError,
        InjectedKernelError,
        InjectedOOMError,
    )

    for e in _root_causes(exc):
        if isinstance(e, InjectedKernelError):
            return KERNEL
        if isinstance(e, InjectedOOMError):
            return OOM
        if isinstance(e, InjectedCompileError):
            return COMPILE
        if isinstance(e, KernelCacheCorrupt):
            return CACHE_CORRUPT
        if isinstance(e, torch.OutOfMemoryError):
            return OOM
        if isinstance(e, RuntimeError) and any(m in str(e).lower() for m in _OOM_MARKERS):
            return OOM
    return None


def failing_pairs(exc: BaseException, extrace) -> list[tuple]:
    """The (sym_id, executor_name) pairs to quarantine for a KERNEL-class
    failure: the claims of the executor the injected error names (every
    non-terminal claim when it names none in the trace), with the symbols
    a claimed rewrite came from."""
    from thunder_tpu_torch.resilience.chaos import InjectedKernelError

    claimed: list[tuple] = []
    seen = set()
    for bsym in getattr(extrace, "bound_symbols", ()) or ():
        ex = bsym.sym.executor
        if ex is None or ex.name in _TERMINAL_EXECUTORS:
            continue
        for sym_id in (bsym.sym.id, _REWRITTEN_FROM.get(bsym.sym.id)):
            key = (sym_id, ex.name)
            if sym_id is not None and key not in seen:
                seen.add(key)
                claimed.append(key)
    injected = next((e for e in _root_causes(exc) if isinstance(e, InjectedKernelError)), None)
    if injected is not None:
        matched = [k for k in claimed if k[1] == injected.executor]
        if matched:
            return matched
    return claimed
