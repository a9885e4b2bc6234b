"""Staging: a program captured whole as one CUDA graph, the seat of ``jax.jit``.

The counterpart of the JAX package's staging: ``api.py:683-688`` decides
whether an entry stages (``will_stage``), ``:774-784`` stages it under
``jax.jit``, and ``bench.py:159`` and ``parallel/train.py:213`` stage their
training steps whole. Here a staged callable's first call runs eagerly (the
warm-up, as XLA compiles at an entry's first run), under
``torch.cuda.set_sync_debug_mode("error")``, so that a host read raises
there; its second call captures one ``torch.cuda.CUDAGraph`` in a private
memory pool and replays it; every later call replays it.

What stays unstaged (:func:`unstaged_reason`): ``disable_jit_staging``; a
program holding a ``DEVICE_SYNC_OP`` (``prims.item``); a program with a
claim whose implementation reads a device value on the host (the flash
executor's masked SDPA, whose verdict the JAX package takes on the device
with ``lax.cond``: a graph would bake one mask's verdict into every later
mask's replays), unless the claim was given its verdict (the module
frontend gives it when it compiles, and guards it); and any device but
CUDA. Each gives its reason.

Inputs are the tensor leaves of the call's arguments, read one of two ways:
- in place, by address: a leaf whose address was the same on the warm-up
  and capture calls (the params and optimizer state of a training step, a
  params dict passed every call). The graph reads, and where the program
  updates it in place writes, the caller's tensor: the counterpart of
  donation. Each call checks the address; a miss re-captures with that leaf
  copied, and is counted;
- copied: every other leaf (a new batch each call; an RNG key, always) is
  copied into a buffer
  the stage owns before each replay; one that the program updates in place
  (seen in the warm-up through the tensor's version counter) is copied back
  after it.
The tree's structure, its other leaves and each tensor's shape, strides,
dtype and device are the stage's signature: another one warms up and
captures anew, and is counted as a miss too. A replay never reads a stale
address.

Outputs: a tensor output that is an input comes back as the caller's tensor;
every other is copied out of the graph's pool into a fresh tensor, so a
result the caller holds is never overwritten by a later call (``jax.jit``
returns fresh arrays). A stage may lend some outputs instead
(``lend_from``: the module forward's saved tensors, which its backward's
graph then reads at those addresses; the module backward's grads, which
autograd takes as
``.grad``): the caller gets aliases of the pool's buffers, with no copy.
Before the graph runs again, an alias it handed out that is still alive is
moved to memory of its own; if a lent buffer is still held by a tensor the
stage did not hand out (autograd's ``.grad`` kept past the next backward,
as under gradient accumulation), the graph is captured anew, leaving the
old pool to its holders, and copies its outputs from then on. No caller
sees its tensor change. Launch counters keep meaning launches per call: a
replay adds to each kernel wrapper's count what its capture launched.

A module's forward and backward are a pair (:class:`GraphPair`): their two
graphs are captured into one memory pool, the backward's right after the
forward's, in the same step (the forward captures when the pair needs it, and
the backward captures only in that window). The forward keeps no reference
to what it lends, so the backward's capture sees each saved tensor freed at
its last use and puts its own buffers there, as eager does; at later replays
the forward hands out views of the addresses its graph writes, and the
autograd node that holds them keeps the stages, and so the pool, alive.
Before the forward replays over the pool, a grad the backward lent that is
still held is moved out if it is the stage's own alias, and otherwise the
pair is captured anew into a fresh pool, the old graphs kept until no lent
tensor reads them, and the backward copies its grads from then on.
A backward whose saved tensors are not where its graph reads them (a second
forward moved the first's out of the pool) runs eagerly.

No fallback: a capture that fails raises ``StagingError``, naming the line of
the program that was running; nothing runs eagerly in its place. A failed
capture ends the capture and drops the graph and its memory pool, and hands
the allocator's cached blocks back (``torch.cuda.empty_cache``), so the
recovery driver's retry (``resilience/deopt.py``: an out-of-memory, or an
injected fault, during the capture) does not see the failed attempt's
blocks. ``seam`` (the dispatch's chaos seam, ``resilience/chaos.run_seam``)
runs at the start of each call's program: inside the capture when the call
captures.
"""

from __future__ import annotations

import linecache
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from thunder_tpu_torch.core.prims import OpTags
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
from thunder_tpu_torch.executors import _build


class StagingError(RuntimeError):
    """A staged program could not be captured as a CUDA graph."""


@dataclass
class StagingStats:
    """How one entry runs. ``reason`` says why it is not staged (None when
    it is). Seconds are the host's, each ending in a synchronize: the
    warm-up call and the last capture (with its first replay). Bytes are
    those copied per replay: inputs in, updated inputs back, outputs out."""

    staged: bool
    reason: Optional[str] = None
    first_call_s: float = 0.0
    capture_s: float = 0.0
    captures: int = 0
    replays: int = 0
    guard_misses: int = 0
    copied_bytes_per_call: int = 0


def unstaged_reason(traces: Sequence, device: torch.device, disabled: bool | str = False) -> Optional[str]:
    """Why the claimed ``traces`` run eagerly on ``device``, or None when
    they stage (``api.py:683-688`` of the JAX package). ``disabled`` is
    True (``disable_jit_staging``) or the caller's own reason."""
    if disabled:
        return disabled if isinstance(disabled, str) else "disable_jit_staging=True"
    for trc in traces:
        for bsym in trc.bound_symbols:
            if OpTags.DEVICE_SYNC_OP in bsym.sym.tags:
                return f"{bsym.sym.name} syncs the device with the host"
            ex = bsym.sym.executor
            if ex is not None and ex.reads_host(bsym):
                return f"the {ex.name} executor's {bsym.sym.name} reads a device value on the host"
    if device.type != "cuda":
        return f"the {device.type} device has no CUDA graphs"
    return None


def _signature(leaves: list) -> tuple:
    return tuple(
        (tuple(x.shape), x.stride(), x.dtype, x.device, x.requires_grad) if isinstance(x, torch.Tensor) else x
        for x in leaves
    )


def _copy(dst: list, src: list) -> None:
    """Copy each of ``src`` into ``dst``, a few launches for the lot (a step
    without donation copies every param and optimizer moment twice): one
    foreach copy per dtype, since a list that mixes dtypes takes the
    one-launch-per-tensor path."""
    groups: dict = {}
    for d, s in zip(dst, src):
        ds, ss = groups.setdefault(s.dtype, ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _where(exc: BaseException) -> str:
    """The deepest line of a generated program on the exception's traceback
    (or on that of the exception it was raised during)."""
    where = ""
    while exc is not None and not where:
        tb = exc.__traceback__
        while tb is not None:
            name = tb.tb_frame.f_code.co_filename
            if name.startswith("<thunder_tpu_torch.gen"):
                where = f" at `{linecache.getline(name, tb.tb_lineno).strip()}`"
            tb = tb.tb_next
        exc = exc.__context__
    return where


class GraphPair:
    """A module entry's forward and backward stages, captured into one
    memory pool: ``pool`` is the current one; ``window`` is open from the
    forward's capture to the next forward call, while the saved tensors it
    handed out are the graph's own tensors, owned by their holders;
    ``want_capture`` asks the forward to capture anew at its next call;
    ``retired`` keeps older graphs alive while a tensor lent from their pool
    is."""

    def __init__(self):
        self.pool = None
        self.window = False
        self.want_capture = False
        self.forward: Optional["CudaGraphStage"] = None
        self.backward: Optional["CudaGraphStage"] = None
        self.retired: list = []

    def retire(self) -> None:
        """Start a new pool: the current graphs are dropped, or kept while a
        tensor lent from them (a view of their pool) is still held."""
        graphs = [st._graph for st in (self.forward, self.backward) if st is not None and st._graph is not None]
        # The backward's lent grads are its graph's own tensors, which keep
        # their memory; the forward's saved tensors are views of the pool.
        live = [ref for ref, _ in self.forward._held if not ref.expired()] if self.forward is not None else []
        if graphs and live:
            self.retired.append((graphs, live))
        self.retired = [(g, r) for g, r in self.retired if any(not x.expired() for x in r)]
        for st in (self.forward, self.backward):
            if st is not None:
                st._graph = None
        self.pool = torch.cuda.graph_pool_handle()
        self.window = self.want_capture = False


def _meta(t: torch.Tensor) -> tuple:
    s = t.untyped_storage()
    return (s.data_ptr(), s.nbytes(), t.storage_offset(), tuple(t.shape), t.stride(), t.dtype, t.device)


def _view_of(meta: tuple) -> torch.Tensor:
    """A tensor over the pool's memory at ``meta``, which it does not own:
    what a graph wrote there at its last replay."""
    ptr, nbytes, offset, shape, stride, dtype, device = meta
    storage = torch._C._construct_storage_from_data_pointer(ptr, device, nbytes)
    return torch.empty(0, dtype=dtype, device=device).set_(storage, offset, shape, stride)


class CudaGraphStage:
    """``fn`` staged as one CUDA graph. ``eager`` is ``fn`` itself, unstaged;
    ``stats`` is the entry's :class:`StagingStats`."""

    def __init__(self, fn: Callable, *, name: str, fresh: Optional[Callable[[tuple], set]] = None,
                 lend_from: Optional[Callable[[Any], int]] = None, pair: Optional[GraphPair] = None,
                 role: str = "forward", strict: bool = False):
        self.eager = fn
        self.name = name
        # ``strict``: inputs of another signature than the first call's
        # raise instead of warming up anew (an entry of cache="same input",
        # whose prologue checks nothing: this is its only check).
        self.strict = strict
        # ``fresh(args)``: the flat indices of the inputs that are new each
        # call (an RNG key, a backward's cotangents): always copied, never
        # read by address, whatever address the allocator happens to reuse.
        self.fresh = fresh
        # ``lend_from(out)``: the output leaves from that flat index on are
        # lent, not copied: the caller gets aliases of the graph's own
        # buffers. ``_lent``: the aliases handed out since the last run;
        # ``_held``: each lent buffer's storage and its count of references
        # when nothing outside the stage held it.
        self.lend_from = lend_from
        self._lent: list = []
        self._held: list = []
        # ``pair``: the module's forward and backward share a pool
        # (:class:`GraphPair`); ``role`` says which this is.
        self.pair, self.role = pair, role
        if pair is not None:
            setattr(pair, role, self)
        self.stats = StagingStats(staged=True)
        self._spec = None
        self._sig = None
        self._warm_addrs: dict[int, int] = {}
        self._mutated: set[int] = set()
        self._graph = None
        # ``on_capture(seconds)``: told of each capture (the compile's
        # "capture" phase, api._record_compile_phase).
        self.on_capture: Optional[Callable[[float], None]] = None
        self.seam: Optional[Callable[[], None]] = None

    def release(self) -> None:
        """Drop the graph, its static buffers and its memory pool (an entry
        the recovery driver evicts); a later call warms up anew."""
        self._graph = self._static = self._outs = None
        self._sig = self._spec = None
        self._lent, self._held = [], []
        if self.pair is not None and self.role == "forward":
            self.pair.retire()

    def __call__(self, *args):
        leaves, spec = tree_flatten(args)
        sig = _signature(leaves)
        pair = self.pair
        window = pair is not None and pair.window
        if pair is not None and self.role == "forward":
            pair.window = False
        if self._sig is None or spec != self._spec or sig != self._sig:
            if self._sig is not None:
                self.stats.guard_misses += 1
                if self.strict:
                    raise StagingError(
                        f"staging {self.name}: the inputs' shapes, strides or dtypes differ from the first call's, "
                        "and cache='same input' strips the guards that would have compiled a new entry")
            if pair is not None:
                pair.want_capture = True
            return self._warm_up(args, leaves, spec, sig)
        if pair is not None:
            return self._pair_call(args, leaves, window)
        if self._graph is None:
            stable = {i for i, a in self._warm_addrs.items() if leaves[i].data_ptr() == a}
            if self.fresh is not None:
                stable -= self.fresh(args)
            return self._capture(args, leaves, stable)
        missed = {i for i in self._by_address if leaves[i].data_ptr() != self._addrs[i]}
        if missed:
            self.stats.guard_misses += 1
            return self._capture(args, leaves, self._by_address - missed)
        return self._replay(args, leaves)

    def _pair_call(self, args: tuple, leaves: list, window: bool):
        """One call of a stage of a :class:`GraphPair`."""
        pair = self.pair
        fresh = self.fresh(args) if self.fresh is not None else set()
        if self.role == "backward":
            if window:
                pair.window = False
                # Right after the forward's capture: read every saved tensor
                # where the forward's graph writes it.
                return self._capture(args, leaves, set(self._warm_addrs) - fresh)
            held = self._graph is not None and self._reclaim()
            if self._graph is None or held or any(leaves[i].data_ptr() != a for i, a in self._addrs.items()):
                # No graph for this pool yet, or a grad it lent still held:
                # eager now, and the pair captures anew in the next step. Or
                # saved tensors moved out of the pool: eager, this once.
                if self._graph is None or held:
                    pair.want_capture = True
                    self.lend_from = None if held else self.lend_from
                leaves.clear()
                return self.eager(*args)
            return self._replay(args, leaves)
        held = pair.backward is not None and pair.backward._graph is not None and pair.backward._reclaim()
        if held:
            # A grad lent from the pool is still held (accumulation): leave
            # it the old pool, and copy the grads from now on.
            pair.backward.lend_from = None
        # A saved tensor still held past the stage's own alias: the same.
        held = self._reclaim() or held
        stable = {i for i, a in self._warm_addrs.items() if leaves[i].data_ptr() == a} - fresh
        if self._graph is None or held or pair.want_capture:
            return self._capture(args, leaves, stable)
        missed = {i for i in self._by_address if leaves[i].data_ptr() != self._addrs[i]}
        if missed:
            self.stats.guard_misses += 1
            return self._capture(args, leaves, self._by_address - missed)
        return self._replay(args, leaves)

    def _warm_up(self, args: tuple, leaves: list, spec, sig: tuple):
        self._graph = None
        tensors = {i: x for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)}
        versions = {i: t._version for i, t in tensors.items()}
        addrs = {i: t.data_ptr() for i, t in tensors.items()}
        # Weak references only, so a backward frees each saved tensor at its
        # last use (the program clears the list it is given).
        refs = {i: weakref.ref(t) for i, t in tensors.items()}
        del tensors
        leaves.clear()
        t0 = time.perf_counter()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            if self.seam is not None:
                self.seam()
            out = self.eager(*args)
        except RuntimeError as e:
            if "synchronizing" not in str(e):
                raise
            raise StagingError(f"staging {self.name}: the program reads the host{_where(e)}: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize()
        self.stats.first_call_s = time.perf_counter() - t0
        self._spec, self._sig = spec, sig
        self._warm_addrs = addrs
        self._mutated = {i for i, r in refs.items() if r() is not None and r()._version != versions[i]}
        return out

    def _reclaim(self) -> bool:
        """Before the graph overwrites the buffers it lent: move every alias
        handed out and still alive to memory of its own, and say whether a
        lent buffer is still held all the same."""
        for ref in self._lent:
            alias = ref()
            if alias is not None:
                alias.set_(alias.clone())
        self._lent = []
        return any(torch._C._storage_Use_Count(ref.cdata) > n for ref, n in self._held)

    def _capture(self, args: tuple, leaves: list, by_address: set):
        t0 = time.perf_counter()
        self._reclaim()
        pair = self.pair
        if pair is not None and self.role == "forward":
            pair.retire()
        self._graph = self._static = self._outs = None  # a re-capture frees the old graph's pool first
        self._held = []
        copied = [i for i in self._warm_addrs if i not in by_address]
        copies = {i: torch.empty_like(leaves[i]).copy_(leaves[i]) for i in copied}
        self._addrs = {i: leaves[i].data_ptr() for i in by_address}
        static = [copies.get(i, x) for i, x in enumerate(leaves)]
        call = tree_unflatten(static, self._spec)
        copied_bytes = sum(_nbytes(leaves[i]) for i in copied + [i for i in copied if i in self._mutated])
        if pair is not None and self.role == "backward":
            # The saved tensors reach the program only in its own list, which
            # it clears as it goes, so that the capture frees each at its
            # last use and reuses its memory, as eager does.
            ids = {id(x): i for i, x in copies.items()}
            for i in by_address:
                leaves[i] = None
            if isinstance(args[0], list):
                args[0].clear()
        else:
            ids = {id(static[i]): i for i in self._warm_addrs}
        del static
        before = _build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=None if pair is None else pair.pool):
                if self.seam is not None:
                    self.seam()
                out = self.eager(*call)
        except Exception as e:
            # The capture has ended (the context's exit); drop what it made.
            del call, graph, copies
            self.release()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            raise StagingError(f"staging {self.name}: the CUDA graph capture failed{_where(e)}: {e}") from e
        del call
        after = _build.launch_counts()
        self._delta = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
        out_leaves, self._out_spec = tree_flatten(out)
        # Each output leaf: ("in", i) for input leaf i, ("new", t) for a tensor
        # in the graph's pool, copied out per call, ("const", x) otherwise.
        self._outs = [("in", ids[id(o)]) if id(o) in ids else ("new", o) if isinstance(o, torch.Tensor)
                      else ("const", o) for o in out_leaves]
        # Only the buffers the stage copies into: a leaf read in place is the
        # caller's to keep alive, or to free.
        self._graph, self._copied = graph, copied
        self._static = [copies.get(i) for i in range(len(leaves))]
        self._by_address = set(by_address)
        self._copy_back = [i for i in copied if i in self._mutated]
        first_lent = len(self._outs) if self.lend_from is None else self.lend_from(out)
        self._outs = [("lent", o) if kind == "new" and j >= first_lent else (kind, o)
                      for j, (kind, o) in enumerate(self._outs)]
        del out, out_leaves, copies
        storages = [StorageWeakRef(o.untyped_storage()) for kind, o in self._outs if kind == "lent"]
        self._held = [(ref, torch._C._storage_Use_Count(ref.cdata)) for ref in storages]
        self.stats.copied_bytes_per_call = copied_bytes + sum(_nbytes(o) for kind, o in self._outs if kind == "new")
        self.stats.captures += 1
        graph.replay()
        result = self._results(leaves)
        if pair is not None and self.role == "forward":
            # Keep no reference to the pool's tensors: what the graph lent is
            # its holders' to free, so that the backward's capture, next,
            # reuses it; later replays hand out views of the same addresses.
            self._outs = [(kind, _meta(o)) if kind in ("new", "lent") else (kind, o) for kind, o in self._outs]
            self._held = [(ref, 0) for ref in storages]
            pair.window = True
        torch.cuda.synchronize()
        self.stats.capture_s = time.perf_counter() - t0
        if self.on_capture is not None:
            self.on_capture(self.stats.capture_s)
        return result

    def _replay(self, args: tuple, leaves: list):
        if self.seam is not None:
            self.seam()
        if self._reclaim() and self.pair is None:
            self.lend_from = None
            return self._capture(args, leaves, self._by_address)
        _copy([self._static[i] for i in self._copied], [leaves[i] for i in self._copied])
        self._graph.replay()
        _build.add_launches(self._delta)
        return self._results(leaves)

    def _results(self, leaves: list):
        self.stats.replays += 1
        _copy([leaves[i] for i in self._copy_back], [self._static[i] for i in self._copy_back])
        pooled = [x if isinstance(x, torch.Tensor) else _view_of(x) for kind, x in self._outs if kind == "new"]
        fresh = [torch.empty_like(x) for x in pooled]
        _copy(fresh, pooled)
        del pooled
        fresh = iter(fresh)
        outs, aliases = [], {}
        if any(kind == "lent" and isinstance(x, tuple) for kind, x in self._outs):
            self._held = []
        for kind, x in self._outs:
            if kind == "lent":
                # An alias, one a buffer (autograd then takes a buffer lent
                # twice as it would the same tensor twice: it copies it): the
                # caller may drop it, or it is moved (_reclaim).
                key = x if isinstance(x, tuple) else id(x)
                if key not in aliases:
                    aliases[key] = x.detach() if isinstance(x, torch.Tensor) else _view_of(x)
                    self._lent.append(weakref.ref(aliases[key]))
                    if isinstance(x, tuple):
                        self._held.append((StorageWeakRef(aliases[key].untyped_storage()), 0))
                x = aliases[key]
            outs.append(leaves[x] if kind == "in" else next(fresh) if kind == "new" else x)
        return tree_unflatten(outs, self._out_spec)


def stage(fn: Callable, traces: Sequence, device: torch.device, *, name: str,
          disabled: bool | str = False, **options) -> tuple[Callable, StagingStats]:
    """``(callable, stats)``: ``fn`` staged as a CUDA graph, or ``fn`` itself
    with the reason it is not (:func:`unstaged_reason` over the claimed
    ``traces`` that ``fn`` runs). ``options`` are :class:`CudaGraphStage`'s
    (``fresh``, ``lend_from``, ``pair``, ``role``, ``strict``)."""
    reason = unstaged_reason(traces, device, disabled)
    if reason is not None:
        return fn, StagingStats(staged=False, reason=reason)
    staged = CudaGraphStage(fn, name=name, **options)
    return staged, staged.stats
