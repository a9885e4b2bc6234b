"""CompileData / CompileStats / CacheEntry.

Reference parity: thunder/common.py (`CompileData:138`, `CompileStats:54`,
`CacheEntry` in thunder/__init__.py:281). Cut to the jit path of this
package: constant-values caching (every tensor's metadata and every number's
value is guarded by the prologue), no cache or sharp-edge options; the
reference package's symbolic-values caching, distribution state, de-opt
ladder and compile-phase spans come with later parts of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class CompileData:
    """Options resolved at jit() time (reference: thunder/common.py:138)."""

    fn: Callable
    executors_list: tuple = ()
    device: Any = None  # the torch.device the entry runs on
    # Trace-to-trace transforms run after dce/cse and before claiming
    # (``grad`` / ``value_and_grad`` pass the autodiff transform here).
    trace_transforms: tuple = ()


@dataclass
class CacheEntry:
    """One compiled specialization (reference: thunder/__init__.py:281)."""

    prologue_fn: Callable
    computation_fn: Callable
    prologue_traces: list
    computation_traces: list
    # Guards over input-derived scalar values that the trace specialized on
    # (core/concrete.py): all must re-evaluate equal for a cache hit.
    value_guards: tuple = ()


class CompileStats:
    """Caches, counters and trace history (reference: thunder/common.py:54)."""

    def __init__(self):
        self.cache_entries: list[CacheEntry] = []
        self.cache_hits: int = 0
        self.cache_misses: int = 0
        self.last_traces: list = []
