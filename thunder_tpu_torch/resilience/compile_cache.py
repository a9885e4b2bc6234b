"""The kernel build directory's integrity: sweep torn entries, purge on error.

The counterpart of ``thunder_tpu/resilience/compile_cache.py``. The port has
no XLA cache: its persistent compile cache is the kernel build directory,
``thunder_tpu_torch/_build/<hash>/`` (``executors/_build.py``), where each
source's object and the linked ``libthunder_kernels.so`` live. A file torn
by a crashed or disk-full build must not take the process down or poison
the next start. Two defenses:

- :func:`sweep_corrupt_entries`: run when ``_build`` first looks at a build
  directory, under the directory's build lock; deletes zero-length and
  unreadable entry files, logs a warning naming each, and emits
  ``cache_repair``. The build then rebuilds what the sweep removed (never
  the plain versions in a kernel's place);
- :func:`purge_on_error`: the recovery driver's last resort when a load
  fails as ``CACHE_CORRUPT`` (``demotion.KernelCacheCorrupt``): clear the
  hash directory under the same lock and let the retry rebuild it.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from thunder_tpu_torch.observability import events as obs_events

logger = logging.getLogger("thunder_tpu_torch")


# The entries of a build directory: each source's object and the linked
# library (its lock file and build log are not entries).
_ENTRY_SUFFIXES = (".o", ".so")


def _entry_files(cache_dir: str) -> list[str]:
    try:
        return sorted(
            p for p in (os.path.join(cache_dir, f) for f in os.listdir(cache_dir))
            if os.path.isfile(p) and p.endswith(_ENTRY_SUFFIXES)
        )
    except OSError:
        return []


def _looks_corrupt(path: str) -> Optional[str]:
    """A reason string when the entry file is definitely unusable, else
    None. Deliberately conservative: only signatures that can never be a
    valid object or library (empty file, unreadable)."""
    try:
        size = os.path.getsize(path)
    except OSError as e:
        return f"unreadable ({e})"
    if size == 0:
        return "zero-length (torn write)"
    try:
        with open(path, "rb") as f:
            if not f.read(1):
                return "unreadable (empty read)"
    except OSError as e:
        return f"unreadable ({e})"
    return None


def sweep_corrupt_entries(cache_dir: str) -> list[str]:
    """Delete corrupted/truncated entries under ``cache_dir``; returns the
    removed paths. Each removal logs a warning and emits a ``cache_repair``
    event: the build recompiles them instead of loading a torn file."""
    removed: list[str] = []
    for path in _entry_files(cache_dir):
        reason = _looks_corrupt(path)
        if reason is None:
            continue
        try:
            os.remove(path)
        except OSError:
            continue
        removed.append(path)
        logger.warning(
            "kernel build directory: removed corrupt entry %s (%s); "
            "it will be rebuilt", path, reason,
        )
        obs_events.emit_event(
            "cache_repair", action="removed_entry", path=path, reason=reason
        )
    return removed


def purge_on_error(exc: BaseException) -> bool:
    """Clear the current kernel build directory after a failure that
    classifies as cache corruption. True when a purge happened (the caller
    retries, which rebuilds)."""
    cache_dir = configured_cache_dir()
    if not cache_dir or not os.path.isdir(cache_dir):
        return False
    from pathlib import Path

    from thunder_tpu_torch.executors import _build

    # Under the directory's build lock: a build in another process may be
    # writing these files.
    with _build.dir_lock(Path(cache_dir)):
        entries = _entry_files(cache_dir)
        for path in entries:
            try:
                os.remove(path)
            except OSError:
                pass
    _build.forget()
    logger.warning(
        "kernel build directory: purged %d entr%s from %s after %s; "
        "rebuilding", len(entries), "y" if len(entries) == 1 else "ies",
        cache_dir, type(exc).__name__,
    )
    obs_events.emit_event(
        "cache_repair", action="purged", path=cache_dir, reason=str(exc)[:200]
    )
    return True


def configured_cache_dir() -> Optional[str]:
    """The build directory of this checkout's kernel sources."""
    from thunder_tpu_torch.executors import _build

    try:
        return _build.build_dir()
    except Exception:  # noqa: BLE001 — a purge must not fail on the lookup
        return None
