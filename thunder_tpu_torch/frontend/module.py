"""ThunderModule: ``thunder_tpu_torch.jit(torch.nn.Module)``.

Reference parity: ``ThunderModule`` (thunder/__init__.py:178) and the
torch-autograd bridge ``ThunderFunction`` (thunder/executors/torch_autograd.py:20).
The counterpart of ``thunder_tpu/frontend/module.py``; ``seq_bucket=`` pads
dim 1 of the inputs to a bucket and crops the outputs back, so each bucket
is one entry.

Acquisition (the seat of thunder's bytecode interpreter, see
``frontend/__init__.py``): parameters and buffers are swapped for
TensorProxies directly in each submodule's ``_parameters``/``_buffers``
dicts, the original ``forward`` runs under a ``TorchFunctionMode`` that maps
every torch call to its ltorch symbol, and the recorded trace goes through
the functional path's passes: value guards, dce/cse, the autodiff split,
attention residuals, rematerialization, claiming, and ``del`` after each
last use.

Execution: the parameters are the module's own torch tensors; there is no
device copy to keep in step, so an optimizer's in-place update is seen by
the next call. A parameter or input that is not on the jit's device raises,
naming it; nothing is moved. When grad is enabled and some parameter or
input requires it, the forward and backward run inside a
``torch.autograd.Function`` whose inputs are exactly those tensors, so
autograd accumulates each gradient into its ``.grad`` in the parameter's
dtype and any torch optimizer works unchanged. When grad is disabled
(``torch.no_grad()``) the forward alone is compiled and run, and nothing is
saved for a backward that cannot come.

On CUDA the compiled forward and backward each run as a CUDA graph
(``executors/staging.py``), as the JAX package puts each under ``jax.jit``
(``thunder_tpu/frontend/module.py:849-857``, ``:950-951``). A masked
attention's verdict is taken when an entry is compiled and given to its
claims, and a value guard holds each later call to it, so each verdict has
its own entry and graphs. The forward lends its saved tensors to the
backward, whose graph reads them where the forward's graph wrote them and,
captured into the same memory pool, reuses their memory as they die; the
backward lends its grads to autograd, and copies them only once a
``.grad`` is kept past the next forward (``staging.GraphPair``).
``autocast=`` applies ``transforms/autocast.py`` before the split (the JAX
package's module frontend takes the option and leaves the products in
f32); random draws take a fresh key each call, as the functional entries'
do.

Distributed (``distributed.ddp``/``fsdp`` before jit, or
``configure_distributed`` after; thunder_tpu/frontend/module.py:335-460,
:576-957): one process a rank, each called with the same global inputs.
Every parameter passes through ``synchronize`` at trace time, whose VJP
puts the grad all-reduce (ddp) or reduce-scatter (fsdp) in the backward.
Under fsdp each rank's parameter holds its dim-0 block (one whose dim 0
does not divide stays replicated), so ``parameters()`` yields the shards
and their ``.grad`` is the reduce-scattered shard grad; ZERO3 gathers
again in the backward instead of saving the full parameter. The data
inputs whose dim 0 is the batch (``frontend/batchdim.py``) run as this
rank's block, and an output that still leads with the batch is joined by
an all-gather; an output that reduces over the batch, or a differentiable
input that is not the batch, falls back to replicated data. ``no_sync()``
compiles its own entry, whose backward has no collective, and reduces the
accumulated grads when the context exits. A group of one rank runs every
collective too (each is then the identity), so its traces are those of N.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch

from thunder_tpu_torch.common import suppress_sharp_edges, timer_ns
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten


def _make_dispatch_mode():
    """TorchFunctionMode routing torch.* calls to ltorch symbols (factory
    functions; tensor-position dispatch comes from
    TensorProxy.__torch_function__, see frontend/dispatch.py)."""
    from torch.overrides import TorchFunctionMode

    from thunder_tpu_torch.frontend.dispatch import torch_dispatch

    class TorchToLtorch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            return torch_dispatch(func, types, args, kwargs)

    return TorchToLtorch()


def _named_slots(module) -> list[tuple[str, dict, str, Any]]:
    """(qualified_name, owner_dict, key, tensor) for every param/buffer."""
    out = []
    for prefix, sub in module.named_modules():
        for d in (sub._parameters, sub._buffers):
            for k, v in list(d.items()):
                if v is not None:
                    qual = f"{prefix}.{k}" if prefix else k
                    out.append((qual, d, k, v))
    return out


class _patched_factories:
    """Context: torch factory functions (arange/zeros/...) routed to ltorch.

    Factories taking a ``device=`` kwarg fail in torch's C++ argument parser
    when handed a thunder Device (e.g. HF's
    ``torch.arange(..., device=input_ids.device)``): the parse error fires
    before any __torch_function__ hook can run, so the only interception
    point is the Python attribute itself."""

    _NAMES = ("arange", "zeros", "ones", "empty", "full", "rand", "randn", "tensor", "linspace")

    def __enter__(self):
        import thunder_tpu_torch.torch as ltorch

        self._saved = {}
        for name in self._NAMES:
            if hasattr(ltorch, name):
                self._saved[name] = getattr(torch, name)
                setattr(torch, name, getattr(ltorch, name))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(torch, name, fn)
        return False


class _patched_module_setattr:
    """Context: ``nn.Module.__setattr__`` accepts TensorProxy assignments to
    registered params/buffers during tracing (torch's own setattr raises
    TypeError for non-Tensor values). The new proxy simply replaces the dict
    entry; the epilogue diff in ``_compile`` picks it up afterwards
    (reference: thunder records setattr side effects during tracing and
    replays them, thunder/core/jit_ext.py:1302)."""

    def __enter__(self):
        self._orig = torch.nn.Module.__setattr__
        orig = self._orig

        def setattr_(mod, name, value):
            if isinstance(value, TensorProxy):
                for dd in (mod.__dict__.get("_buffers"), mod.__dict__.get("_parameters")):
                    if dd is not None and name in dd:
                        dd[name] = value
                        return
                object.__setattr__(mod, name, value)
                return
            orig(mod, name, value)

        torch.nn.Module.__setattr__ = setattr_
        return self

    def __exit__(self, *exc):
        torch.nn.Module.__setattr__ = self._orig
        return False


class _library_lookasides:
    """Context: proxy-friendly substitutes for third-party helpers that are
    opaque to dispatch interception (reference parity: the interpreter
    frontend's lookaside table, thunder/core/jit_ext.py:344 — same idea,
    scoped to tracing). Without ``transformers`` it does nothing.

    Currently: ``transformers.masking_utils._vmap_for_bhqkv`` — HF builds 4D
    attention masks by ``torch.vmap``-ing a per-position mask closure over
    index tensors; torch.vmap rejects TensorProxy inputs. Broadcasting the
    index tensors is semantically identical for every HF ``mask_function``
    (elementwise predicates and tensor indexing) and traces cleanly.
    """

    def __enter__(self):
        self._saved = None
        try:
            # The first import runs library code (its environment reads),
            # not the traced forward: no sharp edge of the caller's.
            with suppress_sharp_edges():
                from transformers import masking_utils as mu
        except ImportError:
            return self
        orig = getattr(mu, "_vmap_for_bhqkv", None)
        if orig is None:
            return self

        def broadcast_for_bhqkv(mask_function, bh_indices: bool = True):
            if bh_indices:
                def wrapped(b, h, q, kv):
                    return mask_function(
                        b[:, None, None, None], h[None, :, None, None],
                        q[None, None, :, None], kv[None, None, None, :],
                    )
            else:
                def wrapped(q, kv):
                    return mask_function(q[:, None], kv[None, :])
            return wrapped

        self._saved = (mu, orig)
        mu._vmap_for_bhqkv = broadcast_for_bhqkv
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            mu, orig = self._saved
            mu._vmap_for_bhqkv = orig
        return False


class _patched_dtype_introspection:
    """Context: ``torch.finfo``/``torch.iinfo`` accept thunder dtypes.

    HF mask utilities call ``torch.finfo(tensor.dtype)`` on values that are
    TensorProxies during tracing (e.g. BERT's additive-mask expansion,
    transformers/modeling_attn_mask_utils.py); proxies carry thunder dtypes,
    which stock finfo rejects. Translate before delegating."""

    def __enter__(self):
        from thunder_tpu_torch.core import dtypes

        self._orig = (torch.finfo, torch.iinfo)
        orig_finfo, orig_iinfo = self._orig

        def to_torch_dtype(x):
            return dtypes.to_torch_dtype(x) if isinstance(x, dtypes.dtype) else x

        class _Finfo:
            def __new__(cls, dtype=None):
                if dtype is None:  # stock semantics: finfo of the default dtype
                    return orig_finfo()
                return orig_finfo(to_torch_dtype(dtype))

        class _Iinfo:
            def __new__(cls, dtype):
                return orig_iinfo(to_torch_dtype(dtype))

        torch.finfo = _Finfo
        torch.iinfo = _Iinfo
        return self

    def __exit__(self, *exc):
        torch.finfo, torch.iinfo = self._orig
        return False


class _swapped_params:
    """Context: module params/buffers replaced by ``values[qual_name]``."""

    def __init__(self, module, values: dict):
        self.module = module
        self.values = values
        self._saved: list = []

    def __enter__(self):
        for qual, d, k, v in _named_slots(self.module):
            self._saved.append((d, k, v))
            d[k] = self.values[qual]
        return self

    def __exit__(self, *exc):
        for d, k, v in self._saved:
            d[k] = v
        self._saved.clear()
        return False


class _tracing_patches:
    """Every context above, entered together around the module's forward."""

    active: list = []  # the entered instances, innermost last

    def __enter__(self):
        self._ctxs = [_patched_module_setattr(), _patched_factories(), _library_lookasides(),
                      _patched_dtype_introspection(), _make_dispatch_mode()]
        for c in self._ctxs:
            c.__enter__()
        _tracing_patches.active.append(self)
        return self

    def __exit__(self, *exc):
        _tracing_patches.active.pop()
        for c in reversed(self._ctxs):
            c.__exit__(*exc)
        return False


@contextlib.contextmanager
def suspended_tracing_patches():
    """Plain torch for a staged program that runs eagerly while a module is
    being traced (guarded concretization, ``core/concrete.py``): its torch
    calls must not be routed to ltorch or meet patched factories. The JAX
    package needs no such scope: its staged programs run on JAX ops."""
    if not _tracing_patches.active:
        yield
        return
    ctxs = _tracing_patches.active[-1]._ctxs
    for c in reversed(ctxs):
        c.__exit__(None, None, None)
    try:
        yield
    finally:
        for c in ctxs:
            c.__enter__()


class ThunderModule:
    """Compiled wrapper around a torch.nn.Module (reference: __init__.py:178).

    Caching: compiled entries are keyed on the input metadata (shape,
    device, dtype, requires_grad per leaf, the value of every number or
    string, the pytree spec) and on torch's grad mode; traces that
    specialized on input-derived scalars (``core/concrete.py``) share a key
    and are told apart by their value guards. The parameters are the
    module's own tensors, read at every call. ``last_traces``,
    ``cache_hits`` and ``cache_misses`` work on a jitted module as on a
    jitted function."""

    def __init__(self, module, *, executors=None, device: Any = None, sharp_edges: Any = "allow",
                 rematerialize: bool = True, disable_jit_staging: bool = False, autocast: Any = None,
                 seq_bucket: Any = None, seq_pad_value: Any = None, debug_checks: Any = None,
                 events: Optional[str] = None, **options):
        from thunder_tpu_torch.api import _autocast_transforms
        from thunder_tpu_torch.common import CompileData, CompileStats, resolve_sharp_edges_option
        from thunder_tpu_torch.core import devices
        from thunder_tpu_torch.extend import resolve_executors
        from thunder_tpu_torch.observability.events import log_for_path

        # Sequence bucketing (thunder_tpu/frontend/module.py:977); the fill
        # is None when the caller chose none (0 is used, with a warning).
        self._seq_bucket = None if seq_bucket is None else int(seq_bucket)
        self._seq_pad_value = seq_pad_value
        self._seq_crop_cache: dict = {}
        if options:
            raise TypeError(f"jit(nn.Module) got unexpected options {sorted(options)}")
        self._module = module
        self._rematerialize = bool(rematerialize)
        self._cache: dict[Any, list[dict]] = {}  # metadata key → entries (value-guard disambiguated)
        self._lc_cd = CompileData(
            fn=module,
            executors_list=resolve_executors(executors),
            device=devices.resolve_device(device),
            trace_transforms=_autocast_transforms(autocast),
            sharp_edges=resolve_sharp_edges_option(sharp_edges),
            disable_jit_staging=bool(disable_jit_staging),
            compile_options={**({} if autocast is None else {"autocast": autocast}),
                             **({} if debug_checks is None else {"debug_checks": bool(debug_checks)})},
            event_log=log_for_path(events) if events else None,
            is_module=True,
        )
        self._lc_cs = CompileStats()
        self._params()  # a parameter off the jit's device raises here, not at the first call
        self._dist: Optional[dict] = None
        self._groups: dict = {}
        self._sharded: dict[str, tuple] = {}  # fsdp: qual → the full shape of a param held as its dim-0 block
        self._nosync_accum: dict[str, torch.Tensor] = {}  # no_sync: qual → the local grads summed
        if getattr(module, "_thunder_dist", None) is not None:
            self.configure_distributed(module._thunder_dist)

    # -- module surface (reference: thunder/__init__.py:246-250) --------------

    def state_dict(self, *args, **kwargs):
        return self._module.state_dict(*args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        r = self._module.load_state_dict(*args, **kwargs)
        self.resync_params()
        return r

    def resync_params(self) -> None:
        """Check that every param/buffer is on the jit's device. The module's
        tensors are what each call runs on, so nothing needs copying; kept
        for the JAX package's surface, where it re-bridges device copies."""
        self._params()

    def named_parameters(self, *a, **kw):
        return self._module.named_parameters(*a, **kw)

    def parameters(self, *a, **kw):
        return self._module.parameters(*a, **kw)

    def train(self, mode: bool = True):
        self._module.train(mode)
        self._cache.clear()  # dropout etc. change the trace
        return self

    def eval(self):
        return self.train(False)

    @property
    def original_module(self):
        return self._module

    # -- distributed (thunder_tpu/frontend/module.py:335-485) -----------------

    def configure_distributed(self, cfg: Optional[dict]) -> None:
        """Install a ddp/fsdp config (``{mode, mesh, axis, ...}``), or None to
        leave it: params an earlier fsdp config sharded are gathered back
        first, compiled entries are dropped. Under ddp each param takes rank
        ``broadcast_from``'s value; under fsdp each divisible param keeps its
        dim-0 block."""
        from thunder_tpu_torch.distributed import _validate_dist_cfg, runtime

        if self._sharded:
            self._gather_params()
        self._dist, self._groups = None, {}
        self._cache.clear()
        if cfg is None:
            return
        _validate_dist_cfg(cfg)
        self._groups = runtime.resolve_axes(cfg.get("mesh"), (cfg["axis"],))
        self._dist = cfg
        if cfg["mode"] == "ddp" and cfg.get("broadcast_from") is not None:
            self._broadcast_params(cfg["broadcast_from"])
        if cfg["mode"] == "fsdp":
            self._shard_params()

    def _group(self):
        return self._groups[self._dist["axis"]]

    def _dist_axis_size(self) -> int:
        import torch.distributed as tdist

        return tdist.get_world_size(self._group()) if self._dist is not None else 1

    def _broadcast_params(self, root: int) -> None:
        import torch.distributed as tdist

        group = self._group()
        src = tdist.get_global_rank(group, root)
        with torch.no_grad():
            for _, _, _, t in _named_slots(self._module):
                tdist.broadcast(t.data, src=src, group=group)

    def _shard_params(self) -> None:
        """Each parameter whose dim 0 divides over the axis keeps this
        rank's block (``_shard_param:406``; buffers stay replicated)."""
        import torch.distributed as tdist

        n, r = self._dist_axis_size(), tdist.get_rank(self._group())
        for qual, _, _, t in _named_slots(self._module):
            if isinstance(t, torch.nn.Parameter) and t.ndim >= 1 and t.shape[0] % n == 0:
                self._sharded[qual] = tuple(t.shape)
                if n > 1:
                    m = t.shape[0] // n
                    t.data = t.data.narrow(0, r * m, m).clone()
                    t.grad = None

    def _gather_params(self) -> None:
        from thunder_tpu_torch.distributed.prims import gather_dim

        n, named = self._dist_axis_size(), {qual: t for qual, _, _, t in _named_slots(self._module)}
        for qual in self._sharded:
            t = named[qual]
            if n > 1:
                t.data = gather_dim(t.data, self._group(), n, 0)
                t.grad = None
        self._sharded.clear()

    @contextlib.contextmanager
    def no_sync(self):
        """Gradient accumulation: backwards inside the context run an entry
        compiled without grad collectives, their local grads summed here;
        leaving the context reduces the sums over the axis into ``.grad``
        (thunder/__init__.py:197-239). On an exception the partial sums are
        dropped and ``.grad`` is left as it was."""
        from thunder_tpu_torch.distributed import no_sync

        self._nosync_accum.clear()
        try:
            with no_sync():
                yield
        except BaseException:
            self._nosync_accum.clear()
            raise
        self._sync_grads()

    def _sync_grads(self) -> None:
        """Reduce the no-sync sums over the axis onto ``.grad``: a sum (the
        VJP already scaled them), reduce-scattered into an fsdp shard's
        grad, all-reduced into a replicated param's."""
        from thunder_tpu_torch.distributed.prims import _reduce, scatter_dim

        if not self._nosync_accum:
            return
        group, n = self._group(), self._dist_axis_size()
        named = {qual: t for qual, _, _, t in _named_slots(self._module)}
        with torch.no_grad():
            for qual, total in self._nosync_accum.items():
                g = scatter_dim(total, group, n, 0) if qual in self._sharded else _reduce(total, group, n, "sum")
                owner = named[qual]
                g = g.to(owner.dtype)
                owner.grad = g if owner.grad is None else owner.grad + g
        self._nosync_accum.clear()

    # -- inputs ---------------------------------------------------------------

    def _params(self) -> dict:
        """The module's params and buffers by qualified name, each checked to
        be on the jit's device."""
        dev = self._lc_cd.device
        params = {}
        for qual, _, _, t in _named_slots(self._module):
            if not _on(t, dev):
                raise ValueError(f"parameter or buffer {qual!r} is on {t.device}, the module is jitted for {dev}; "
                                 "move the module before jit (nothing is moved for it)")
            params[qual] = t
        return params

    def _check_inputs(self, args: tuple, kwargs: dict) -> None:
        dev = self._lc_cd.device
        named = [(f"argument {i}", a) for i, a in enumerate(args)] + [(f"argument {k!r}", v) for k, v in kwargs.items()]
        for name, tree in named:
            for x in tree_flatten(tree)[0]:
                if isinstance(x, torch.Tensor) and not _on(x, dev):
                    raise ValueError(f"{name} holds a tensor on {x.device}, the module is jitted for {dev} "
                                     "(nothing is moved for it)")

    def _cache_key(self, args: tuple, kwargs: dict, grad: bool):
        from thunder_tpu_torch.executors import bridge

        def leaf_key(x):
            if bridge.is_concrete_tensor(x):
                shape, dev, dt, rg = bridge.tensor_metadata(x)
                return (tuple(shape), dev, str(dt), rg)
            return x if isinstance(x, (int, float, bool, str, type(None))) else type(x).__name__

        from thunder_tpu_torch.distributed import skip_data_parallel_grad_sync

        flat, spec = tree_flatten((args, kwargs))
        nosync = self._dist is not None and skip_data_parallel_grad_sync()
        return (tuple(leaf_key(x) for x in flat), str(spec), grad, nosync)

    # -- compilation ----------------------------------------------------------

    def _compile(self, params: dict, args: tuple, kwargs: dict, grad: bool) -> dict:
        """One entry, under the module's ``debug_checks`` (the trace verifier
        after every pass of the forward and backward) and its observability
        bracket (thunder_tpu/frontend/module.py:494-560): a compile id for
        the passes' events, ``compile_start`` and ``compile_end`` with the
        forward's claimed trace. ``cache_option`` is "module", or
        "module+seq_bucket", which the replay's storm rule reads as one
        compile a sequence bucket."""
        import time

        from thunder_tpu_torch.core.trace import debug_checks
        from thunder_tpu_torch.observability import events as obs_events
        from thunder_tpu_torch.observability import metrics as obsm

        cd, cs, name = self._lc_cd, self._lc_cs, type(self._module).__name__
        t0 = time.perf_counter()
        with debug_checks(cd.compile_options.get("debug_checks")), \
                obs_events.compile_scope(cd.event_log) as compile_id:
            obs_events.emit_event("compile_start", compile_id=compile_id, fn=name,
                                  cache_option="module+seq_bucket" if self._seq_bucket else "module",
                                  call=cs.calls)
            entry = self._compile_impl(params, args, kwargs, grad)
            if entry["split"]:
                entry["value_guards"] = [_BlockGuard(g, entry["split"], self._dist["axis"], self._groups)
                                         for g in entry["value_guards"]]
            cs.compile_count += 1
            if obsm.enabled():
                obsm.COMPILES.inc()
                if cs.compile_count > 1:
                    obsm.RECOMPILES.inc()
                # The forward's and the backward's collectives (the JAX
                # package's module frontend counts none).
                nbytes = sum(entry[k].tags.get("collective_bytes") or 0 for k in ("fw_trace", "bw_trace") if k in entry)
                if nbytes:
                    obsm.COLLECTIVE_BYTES.inc(nbytes)
            obs_events.emit_compile_end(compile_id, name, (time.perf_counter() - t0) * 1e3, entry["fw_trace"],
                                        recompile=cs.compile_count > 1)
            return entry

    def _compile_impl(self, params: dict, args: tuple, kwargs: dict, grad: bool, replicated: bool = False) -> dict:
        from thunder_tpu_torch.api import trace_program
        from thunder_tpu_torch.common import sharp_edges_policy
        from thunder_tpu_torch.core import dtypes, prims
        from thunder_tpu_torch.core.concrete import value_guards_of
        from thunder_tpu_torch.core.symbol import resolve_inplace
        from thunder_tpu_torch.executors import bridge
        from thunder_tpu_torch.executors.passes import del_last_used, take_saved_as_list, transform_for_execution
        from thunder_tpu_torch.transforms.attention_residuals import save_sdpa_residuals
        from thunder_tpu_torch.transforms.autodiff import forward_and_backward_from_trace
        from thunder_tpu_torch.transforms.common import cse, dce
        from thunder_tpu_torch.transforms.rng import RNG_TAG, functionalize_rng_ops

        module = self._module
        executors = self._lc_cd.executors_list
        dist_cfg = self._dist
        axis = dist_cfg["axis"] if dist_cfg is not None else None
        n = self._dist_axis_size()
        nosync = False
        trace_args, trace_kwargs, batch0, split_ids = args, kwargs, None, set()
        if axis is not None:
            from thunder_tpu_torch.distributed import skip_data_parallel_grad_sync

            nosync = skip_data_parallel_grad_sync()
            if dist_cfg.get("shard_data", True) and not replicated:
                trace_args, trace_kwargs, batch0, split_ids = self._split_data(args, kwargs)
        # Split data: the ranks' partial grads sum; replicated data: every
        # rank computes the same grad, and the sync averages the copies.
        grad_scale = 1.0 if split_ids else 1.0 / n

        def functional_fwd(params: dict, *fargs, **fkwargs):
            if axis is not None:
                params = self._synchronized(params, axis, n, grad_scale, nosync)
            with _swapped_params(module, params), _tracing_patches():
                out = module(*fargs, **fkwargs)
                # Epilogue diff (reference: jit_ext.py:1302
                # `process_recorded_modifications`): any param/buffer whose
                # proxy was replaced (setattr) or updated in place (BatchNorm
                # running stats, step counters) becomes an extra, detached
                # output replayed onto the module after execution.
                updates = {}
                for qual, _, _, cur in _named_slots(module):
                    base = params.get(qual)
                    final = resolve_inplace(cur) if isinstance(cur, TensorProxy) else cur
                    if isinstance(base, TensorProxy) and isinstance(final, TensorProxy) and final is not base:
                        updates[qual] = prims.stop_gradient(final)
            if updates:
                return {"__out": _normalize_output(out), "__updates": updates}
            return _normalize_output(out)

        with sharp_edges_policy(self._lc_cd.sharp_edges):
            _, comp = trace_program(functional_fwd, (params,) + trace_args, trace_kwargs)
        vguards = value_guards_of(comp)
        traces = [comp]
        comp = cse(dce(comp))
        traces.append(comp)
        for transform in self._lc_cd.trace_transforms:  # autocast
            comp = transform(comp)
            traces.append(comp)

        # Mark requires_grad on the trace's tensor args, which align with the
        # concrete tensor leaves of ((params, *args), kwargs) in pytree order.
        flat_concrete, _ = tree_flatten(((params,) + trace_args, trace_kwargs))
        concrete = [x for x in flat_concrete if bridge.is_concrete_tensor(x)]
        split = {i for i, x in enumerate(concrete) if id(x) in split_ids}
        wrt = []  # positions in the flat tensor inputs of the grads the backward returns
        for i, (proxy_arg, conc) in enumerate(zip(comp.args, concrete)):
            rg = grad and bool(getattr(conc, "requires_grad", False)) and dtypes.is_inexact_dtype(proxy_arg.dtype)
            proxy_arg._requires_grad = rg
            if rg:
                wrt.append(i)
        if split and any(i >= len(params) and i not in split for i in wrt):
            # A differentiable input that is not split would take each rank's
            # partial grad with no sync: replicated data instead.
            return self._compile_impl(params, args, kwargs, grad, replicated=True)
        out_specs = ct_specs = None
        if axis is not None:
            out_specs = self._out_specs(comp, split, batch0, n)
            if out_specs is None:  # an output that reduces over the batch
                return self._compile_impl(params, args, kwargs, grad, replicated=True)
            ct_specs = [s for leaf, s in zip(tree_flatten(comp.output)[0], out_specs) if isinstance(leaf, TensorProxy)]
        has_updates = isinstance(comp.output, dict) and "__updates" in comp.output
        # Random draws read a key passed in each call, the forward's last
        # input; the backward sees the forward's draws as saved tensors, or
        # recomputes them from the saved key, bit for bit.
        comp = functionalize_rng_ops(comp)
        needs_rng = bool(comp.tags.get(RNG_TAG))
        if needs_rng:
            traces.append(comp)
        entry = {"wrt": wrt, "has_updates": has_updates, "needs_rng": needs_rng, "stages": None,
                 "n_params": len(params), "split": split, "out_specs": out_specs, "ct_specs": ct_specs,
                 "nosync": nosync}

        if not wrt:
            guard, claimed, _ = _with_mask_verdicts(transform_for_execution(comp, executors), None, concrete, needs_rng)
            ex = del_last_used(claimed)
            traces.append(ex)
            return {**entry, "fwd": self._bound(ex.python_callable()), "bwd": None, "traces": traces,
                    "fw_trace": ex, "value_guards": vguards + guard}

        fw, bw = forward_and_backward_from_trace(comp)
        fw, bw = save_sdpa_residuals(fw, bw, executors)
        if self._rematerialize:
            from thunder_tpu_torch.distributed import FSDPType
            from thunder_tpu_torch.transforms.rematerialization import rematerialize_forward_and_backward

            # ZERO3: the backward gathers each param again from its shard
            # instead of saving the gathered param; ZERO2 saves it.
            zero3 = (dist_cfg is not None and dist_cfg["mode"] == "fsdp"
                     and dist_cfg.get("fsdp_type", FSDPType.ZERO3) is FSDPType.ZERO3)
            fw, bw = rematerialize_forward_and_backward(fw, bw, remat_collectives=zero3)
        n_saved = len(fw.tags["saved_for_backward"])
        guard, fw_claimed, bw_claimed = _with_mask_verdicts(transform_for_execution(fw, executors),
                                                            transform_for_execution(bw, executors), concrete, needs_rng)
        fw_ex = del_last_used(fw_claimed)
        bw_ex = del_last_used(take_saved_as_list(bw_claimed, n_saved))
        return {**entry, "fwd": self._bound(fw_ex.python_callable()), "bwd": self._bound(bw_ex.python_callable()),
                "traces": traces + [fw_ex, bw_ex], "fw_trace": fw_ex, "bw_trace": bw_ex,
                "value_guards": vguards + guard}

    def _bound(self, fn):
        """``fn`` with the config's axis resolved to its process group while
        it runs (a staged program's warm-up and capture)."""
        if self._dist is None:
            return fn
        from thunder_tpu_torch.distributed import runtime

        groups = self._groups

        def bound(*args):
            with runtime.bound_axes(groups):
                return fn(*args)

        return bound

    def _synchronized(self, params: dict, axis: str, n: int, grad_scale: float, nosync: bool) -> dict:
        """Every param through ``synchronize`` (thunder/common.py:521-528):
        an fsdp shard all-gathers, a replicated param passes through; the
        VJP puts the grad sync in the backward."""
        from thunder_tpu_torch.core.proxies import DistParallelType
        from thunder_tpu_torch.distributed import prims as dist_prims

        synced = {}
        for qual, p in params.items():
            if not isinstance(p, TensorProxy):
                synced[qual] = p
                continue
            sharded = qual in self._sharded
            p.dist_parallel_type = DistParallelType.FULLY_SHARDED if sharded else DistParallelType.REPLICATED
            synced[qual] = dist_prims.synchronize(p, axis, n, "fsdp" if sharded else "replicated",
                                                  grad_scale=grad_scale, grad_sync=not nosync)
        return synced

    def _split_data(self, args: tuple, kwargs: dict) -> tuple:
        """``(args, kwargs, batch, ids)``: each tensor input of rank 2 or more
        whose dim 0 is the batch (the most common such dim 0) and divides
        over the axis, as this rank's block; ``ids`` are the blocks'. An
        input whose dim 0 is another size (a (T, T) mask) stays whole."""
        from thunder_tpu_torch.distributed import runtime

        n = self._dist_axis_size()
        flat, spec = tree_flatten((args, kwargs))
        dim0s = [int(x.shape[0]) for x in flat if isinstance(x, torch.Tensor) and x.ndim >= 2]
        if not dim0s:
            return args, kwargs, None, set()
        batch0 = max(set(dim0s), key=lambda d: (dim0s.count(d), -dim0s.index(d)))
        if batch0 < n or batch0 % n:
            return args, kwargs, None, set()
        spec_p = runtime.P(self._dist["axis"])
        blocks = [runtime.split(x, spec_p, self._groups) if isinstance(x, torch.Tensor) and x.ndim >= 2
                  and x.shape[0] == batch0 else x for x in flat]
        ids = {id(b) for b, x in zip(blocks, flat) if b is not x}
        new_args, new_kwargs = tree_unflatten(blocks, spec)
        return new_args, new_kwargs, batch0, ids

    def _out_specs(self, comp, split: set, batch0, n: int):
        """A spec for each leaf of the traced output: ``P(axis)`` for an
        output that still leads with the split batch (joined by an
        all-gather), ``P()`` for one no split input reaches; None when an
        output depends on the split data but not batch-first (the compile
        then falls back to replicated data)."""
        from thunder_tpu_torch.distributed.runtime import P
        from thunder_tpu_torch.frontend.batchdim import propagate_batch_lead

        names = {comp.args[i].name for i in split}
        tainted, lead = (propagate_batch_lead(comp.bound_symbols, names, batch0 // n) if names else (set(), set()))
        specs = []
        for leaf in tree_flatten(comp.output)[0]:
            if isinstance(leaf, TensorProxy) and leaf.name in tainted:
                if leaf.ndim == 0 or leaf.name not in lead:
                    return None
                specs.append(P(self._dist["axis"]))
            else:
                specs.append(P())
        return specs

    def _staged(self, entry: dict) -> tuple:
        """The entry's forward and backward, each staged as a CUDA graph
        (``executors/staging.py``) at the entry's first call, with their
        stats. An entry holds one mask verdict (a value guard), so a graph
        never replays under another mask's verdict."""
        from thunder_tpu_torch.api import _key_input
        from thunder_tpu_torch.executors import staging

        if entry["stages"] is None:
            cd, name = self._lc_cd, type(self._module).__name__
            # The forward lends its saved tensors (its output's second part)
            # to the backward, whose graph reads them in place; the backward
            # lends its grads to autograd, which takes them as ``.grad``.
            lend = (lambda out: len(tree_flatten(out[0])[0])) if entry["bwd"] is not None else None
            fresh = _key_input if entry["needs_rng"] else None
            if self._seq_bucket:
                # Padded inputs are new tensors each call: always copied in,
                # whatever address the allocator hands them.
                n = entry["n_params"]
                fresh = lambda args: set(range(n, len(args)))  # noqa: E731
            # With a backward, the two graphs share one memory pool
            # (staging.GraphPair), so the backward reuses the saved tensors'
            # memory as they die, as eager does.
            pair = staging.GraphPair() if entry["bwd"] is not None else None
            fwd, fstats = staging.stage(entry["fwd"], [entry["fw_trace"]], cd.device, name=f"{name}.forward",
                                        disabled=cd.disable_jit_staging, fresh=fresh, lend_from=lend, pair=pair)
            bwd, bstats = None, None
            if entry["bwd"] is not None:
                bwd, bstats = staging.stage(entry["bwd"], [entry["bw_trace"]], cd.device, name=f"{name}.backward",
                                            disabled=cd.disable_jit_staging, fresh=_cotangents,
                                            lend_from=lambda out: 0, pair=pair, role="backward")
            entry["stages"] = (fwd, bwd, fstats, bstats)
        return entry["stages"]

    # -- call -----------------------------------------------------------------

    def __call__(self, *args, **kwargs):
        from thunder_tpu_torch.core import devices

        with devices.default_device(self._lc_cd.device):
            if self._seq_bucket:
                pargs, pkwargs, t, t_pad = self._apply_seq_bucketing(args, kwargs)
                if t is not None and t_pad != t:
                    plan = self._seq_crop_plan(args, kwargs, pargs, pkwargs, t, t_pad)
                    return self._crop_seq_outputs(self._call_impl(pargs, pkwargs), t, t_pad, plan)
            return self._call_impl(args, kwargs)

    # -- sequence bucketing (thunder_tpu/frontend/module.py:975-1165) ---------

    def _apply_seq_bucketing(self, args: tuple, kwargs: dict):
        """Pad dim 1 of every tensor input of rank 2 or more up to the next
        multiple of ``seq_bucket``, so every T of a bucket runs one entry
        (and, on CUDA, one forward graph and one backward graph).

        Sound for causal models: a padded tail position cannot reach a real
        one under causal attention, outputs are cropped back to T along dim
        1, and autograd sends zero cotangents through the pad, so grads match
        the unpadded run. ``seq_pad_value`` (default 0) fills the pad; pick a
        token the loss ignores when a target is among the inputs. Returns
        ``(args, kwargs, T, T_padded)``, T None when the inputs disagree."""
        bucket = self._seq_bucket
        flat, spec = tree_flatten((args, kwargs))
        lens = {int(x.shape[1]) for x in flat if isinstance(x, torch.Tensor) and x.ndim >= 2}
        if len(lens) != 1:
            return args, kwargs, None, None  # ambiguous: the exact-shape path
        t = lens.pop()
        t_pad = -(-t // bucket) * bucket
        if t_pad == t:
            return args, kwargs, t, t
        fill = 0 if self._seq_pad_value is None else self._seq_pad_value
        if self._seq_pad_value is None and not getattr(self, "_seq_pad_warned", False):
            # An integer target padded with the default fill gains fill-token
            # positions in a loss computed inside the module: say so once.
            kinds = {str(x.dtype) for x in flat if isinstance(x, torch.Tensor) and x.ndim >= 2 and x.shape[1] == t}
            if len(kinds) > 1:
                import warnings

                warnings.warn(f"seq_bucket pads every dim-1={t} tensor input (dtypes {sorted(kinds)}) with "
                              "seq_pad_value=0; if one of these is a loss target, pass an explicit "
                              "seq_pad_value your loss ignores (e.g. -100)", stacklevel=3)
                self._seq_pad_warned = True

        def pad_leaf(x):
            if not (isinstance(x, torch.Tensor) and x.ndim >= 2 and x.shape[1] == t):
                return x
            pad = torch.full((x.shape[0], t_pad - t) + tuple(x.shape[2:]), fill, dtype=x.dtype, device=x.device)
            return torch.cat([x, pad], dim=1)

        new_args, new_kwargs = tree_unflatten([pad_leaf(x) for x in flat], spec)
        return new_args, new_kwargs, t, t_pad

    def _seq_crop_plan(self, args, kwargs, pargs, pkwargs, t: int, t_pad: int):
        """Which output leaves carry the padded sequence dim: a leaf whose
        dim 1 is T on the unpadded inputs and T_padded on the padded ones,
        every other dim equal, found by running the module under
        ``FakeTensorMode`` on both (shapes only, no compute). An output whose
        dim 1 is T_padded by coincidence is not cropped. Returns
        ``(n_leaves, {leaf: padded shape})``, or None when the probe cannot
        run (the shape heuristic then decides); a failure is retried once
        before None is kept."""
        key = (self._cache_key(pargs, pkwargs, torch.is_grad_enabled()), t, t_pad)
        if key in self._seq_crop_cache:
            return self._seq_crop_cache[key]
        from torch._subclasses.fake_tensor import FakeTensorMode

        def probe_shapes(a, kw):
            with torch.no_grad(), FakeTensorMode(allow_non_fake_inputs=True):
                out = self._module(*a, **kw)
            flat, _ = tree_flatten(_normalize_output(out))
            return [tuple(x.shape) if hasattr(x, "shape") else None for x in flat]

        # A forward that replaces a slot, registers a buffer or caches a
        # tensor on an attribute would leave a fake tensor behind: restore
        # every slot and instance dict, and drop what the probe created.
        snapshot = [(d, k, v) for _, d, k, v in _named_slots(self._module)]
        pre_keys = {(id(d), k) for d, k, _ in snapshot}
        dict_snapshot = [(m.__dict__, dict(m.__dict__)) for m in self._module.modules()]
        plan, failed = None, False
        try:
            s_unpadded, s_padded = probe_shapes(args, kwargs), probe_shapes(pargs, pkwargs)
            if len(s_unpadded) == len(s_padded):
                crops = {i: sp for i, (su, sp) in enumerate(zip(s_unpadded, s_padded))
                         if su is not None and sp is not None and len(su) == len(sp) >= 2
                         and su[1] == t and sp[1] == t_pad and su[:1] == sp[:1] and su[2:] == sp[2:]}
                plan = (len(s_padded), crops)
        except Exception:  # noqa: BLE001 - the probe is advisory; the heuristic takes over
            failed = True
        finally:
            for d, snap in dict_snapshot:
                for k in list(d):
                    if k not in snap:
                        del d[k]
                    elif d[k] is not snap[k]:
                        d[k] = snap[k]
            for d, k, v in snapshot:
                if d.get(k) is not v:
                    d[k] = v
            for _, d, k, _v in _named_slots(self._module):
                if (id(d), k) not in pre_keys:
                    del d[k]
        if failed:
            fails = self.__dict__.setdefault("_seq_crop_probe_fails", {})
            fails[key] = fails.get(key, 0) + 1
            if fails[key] >= 2:  # a module that cannot be fake-probed: stop probing each call
                self._seq_crop_cache[key] = None
        else:
            self._seq_crop_cache[key] = plan
        return plan

    def _crop_seq_outputs(self, out, t: int, t_pad: int, plan=None):
        if plan is not None:
            n_leaves, crops = plan
            flat, spec = tree_flatten(out)
            if len(flat) == n_leaves and all(isinstance(flat[i], torch.Tensor) and tuple(flat[i].shape) == shape
                                             for i, shape in crops.items()):
                for i in crops:
                    flat[i] = flat[i].narrow(1, 0, t)
                return tree_unflatten(flat, spec)
            # the plan does not describe this output: the heuristic decides
        flat, spec = tree_flatten(out)
        return tree_unflatten([x.narrow(1, 0, t) if isinstance(x, torch.Tensor) and x.ndim >= 2
                               and x.shape[1] == t_pad else x for x in flat], spec)

    def _call_impl(self, args: tuple, kwargs: dict):
        if self._lc_cd.event_log is None:
            return self._run(args, kwargs)
        from thunder_tpu_torch.observability.events import event_scope

        with event_scope(self._lc_cd.event_log):
            return self._run(args, kwargs)

    def _run(self, args: tuple, kwargs: dict):
        from thunder_tpu_torch.core.concrete import first_holding
        from thunder_tpu_torch.executors import bridge
        from thunder_tpu_torch.observability import events as obs_events
        from thunder_tpu_torch.observability import metrics as obsm

        params = self._params()
        self._check_inputs(args, kwargs)
        cs = self._lc_cs
        cs.calls += 1
        grad = torch.is_grad_enabled()
        key = self._cache_key(args, kwargs, grad)
        flat_concrete, _ = tree_flatten(((params,) + args, kwargs))
        inputs = [x for x in flat_concrete if bridge.is_concrete_tensor(x)]
        # A metadata key maps to a LIST of entries: traces that specialized
        # on input-derived scalar values (core/concrete.py value guards) are
        # disambiguated by re-evaluating their guards on the actual inputs.
        cands = list(reversed(self._cache.get(key, ())))
        held = first_holding([c["value_guards"] for c in cands], inputs)
        entry = None if held is None else cands[held]
        if entry is None:
            cs.cache_misses += 1
            if obsm.enabled():
                obsm.CACHE_MISSES.inc()
            obs_events.emit_event("cache_miss", fn=type(self._module).__name__, call=cs.calls)
            cs.last_trace_tracing_start = timer_ns()
            entry = self._compile(params, args, kwargs, grad)
            cs.last_trace_tracing_stop = timer_ns()
            self._cache.setdefault(key, []).append(entry)
        else:
            cs.cache_hits += 1
            if obsm.enabled():
                obsm.CACHE_HITS.inc(kind="module")
        traces = entry["traces"]
        cs.last_traces = traces[:-1] if entry["bwd"] is not None else list(traces)
        cs.last_backward_traces = traces[-1:] if entry["bwd"] is not None else []
        if entry["needs_rng"]:
            from thunder_tpu_torch.api import _next_key

            inputs = inputs + [_next_key(self._lc_cd.device)]

        fwd, bwd, cs.last_staging, cs.last_backward_staging = self._staged(entry)
        sources = inputs
        if self._dist is not None:
            from thunder_tpu_torch.distributed import runtime

            spec = runtime.P(self._dist["axis"])
            inputs = [runtime.split(x, spec, self._groups) if i in entry["split"] else x for i, x in enumerate(inputs)]
            fwd, bwd = self._dist_fwd(entry, fwd), self._dist_bwd(entry, bwd, list(params))
        if bwd is None:
            with torch.no_grad():
                out = fwd(*inputs)
        else:
            out = _run_thunder_function(fwd, bwd, entry["wrt"], inputs, sources)
        return self._postprocess_output(entry, out)

    def _dist_fwd(self, entry: dict, fwd):
        """The forward with its outputs joined by their specs (a leaf that
        leads with the split batch is all-gathered along dim 0)."""
        from thunder_tpu_torch.distributed import runtime

        groups, specs, grad = self._groups, entry["out_specs"], entry["bwd"] is not None

        def joined(*inputs):
            res = fwd(*inputs)
            out = res[0] if grad else res
            flat, spec = tree_flatten(out)
            out = tree_unflatten([runtime.join(x, s, groups) for x, s in zip(flat, specs)], spec)
            return (out, res[1]) if grad else out

        return joined

    def _dist_bwd(self, entry: dict, bwd, quals: list):
        """The backward on this rank's blocks of the cotangents; the grad of
        a split input joined; under ``no_sync`` the params' local grads
        summed into the accumulator instead of returned."""
        if bwd is None:
            return None
        from thunder_tpu_torch.distributed import runtime

        groups, axis = self._groups, self._dist["axis"]
        wrt, split, nosync, accum = entry["wrt"], entry["split"], entry["nosync"], self._nosync_accum
        ct_specs = entry["ct_specs"]  # the cotangents follow the output's tensor leaves

        def local(saved, *cotangents):
            cts = [runtime.split(c, s, groups) for c, s in zip(cotangents, ct_specs)]
            grads = list(bwd(saved, *cts))
            for k, i in enumerate(wrt):
                if i in split:
                    grads[k] = runtime.join(grads[k], runtime.P(axis), groups)
                elif nosync and i < len(quals):
                    g, grads[k] = grads[k], None
                    accum[quals[i]] = g if quals[i] not in accum else accum[quals[i]] + g
            return grads

        return local

    def _postprocess_output(self, entry: dict, out):
        """Split epilogue updates off the output tree and replay them onto
        the module's buffers."""
        if not entry["has_updates"]:
            return out
        self._apply_updates(out["__updates"])
        return out["__out"]

    def _apply_updates(self, updates: dict) -> None:
        named = {qual: t for qual, _, _, t in _named_slots(self._module)}
        with torch.no_grad():
            for qual, val in updates.items():
                t = named.get(qual)
                if t is not None:
                    t.copy_(val.to(t.dtype))


class _BlockGuard:
    """A value guard of an entry traced on this rank's blocks of split
    inputs, read on the same blocks of a call's global inputs."""

    def __init__(self, guard, split: set, axis: str, groups: dict):
        self.guard, self.split, self.axis, self.groups = guard, split, axis, groups

    def holds(self, tensor_inputs):
        from thunder_tpu_torch.distributed.runtime import P, split

        spec = P(self.axis)
        return self.guard.holds([split(x, spec, self.groups) if i in self.split else x
                                 for i, x in enumerate(tensor_inputs)])

    def __getattr__(self, name):
        return getattr(self.guard, name)


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (dev.type == "cpu" or t.device == dev)


def _cotangents(args: tuple) -> set:
    """A backward's inputs are ``(saved, *cotangents)``: the cotangents'
    positions in its flat inputs, after the saved tensors."""
    n = len(args[0])
    return set(range(n, n + len(args) - 1))


def _with_mask_verdicts(fw_claimed, bw_claimed, inputs: list, needs_rng: bool) -> tuple:
    """``(guards, fw, bw)``: the claimed traces with each masked attention's
    verdict (``flashex.mask_verdict``) taken on this call's ``inputs`` and
    given to its claims, so that none reads the host when it runs, and the
    value guard that holds a later call to those verdicts, read with the
    entry's other guards. The JAX package decides on the device with
    ``lax.cond``. A backward mask is one the forward computed, saved or
    recomputed under its name."""
    from thunder_tpu_torch.core import prims
    from thunder_tpu_torch.core.concrete import ValueGuard
    from thunder_tpu_torch.core.prims import PrimIDs
    from thunder_tpu_torch.core.trace import from_trace, tracectx
    from thunder_tpu_torch.executors import flashex
    from thunder_tpu_torch.transforms.common import dce

    sites = flashex.masked_sites(fw_claimed)
    if not sites:
        return (), fw_claimed, bw_claimed
    names = [m.name for m, _ in sites]
    missing = {m.name for m, _ in flashex.masked_sites(bw_claimed or fw_claimed)} - set(names)
    if missing:
        raise NotImplementedError(f"the backward reads the verdict of masks the forward does not compute: {missing}")
    trc = from_trace(fw_claimed)
    trc.bound_symbols.extend(b for b in fw_claimed.bound_symbols if b.sym.id != PrimIDs.RETURN)
    with tracectx(trc):
        prims.python_return(tuple(m for m, _ in sites))
    trc.output = tuple(m for m, _ in sites)
    masks_of = dce(trc).python_callable()
    key = [None] if needs_rng else []  # the forward's last input, which no mask reads

    def verdicts(*tensor_inputs):
        """The verdicts as the digits of one base-3 number."""
        with torch.no_grad():
            masks = masks_of(*tensor_inputs, *key)
            return sum(flashex.mask_verdict(m, *shape) * 3**i for i, (m, (_, shape)) in enumerate(zip(masks, sites)))

    code = int(verdicts(*inputs))
    by_name = {name: code // 3**i % 3 for i, name in enumerate(names)}
    guard = ValueGuard(verdicts, "int", code, f"mask verdicts of {', '.join(names)}")
    return ((guard,), flashex.with_verdicts(fw_claimed, by_name),
            None if bw_claimed is None else flashex.with_verdicts(bw_claimed, by_name))


def _run_thunder_function(fwd, bwd, wrt: list, inputs: list, sources: Optional[list] = None):
    """Run a compiled forward and backward as one ``torch.autograd.Function``
    (reference parity: thunder/executors/torch_autograd.py:20). Its inputs are
    the tensors that the backward returns grads for (of ``sources``, the
    caller's tensors that ``inputs`` were taken from: the same but for a
    rank's block of a split input), so autograd sends each grad to the right
    ``.grad`` or upstream node; the outputs are the tensor leaves of the
    forward's output tree, rebuilt around its other leaves."""
    holder: dict = {}

    class ThunderFunction(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *grad_inputs):
            out, saved = fwd(*inputs)
            flat, spec = tree_flatten(out)
            pos = [i for i, x in enumerate(flat) if isinstance(x, torch.Tensor)]
            # A saved tensor that is also an output is detached: it would
            # otherwise carry the requires_grad autograd sets on the outputs,
            # and the staged backward's signature would change with it. Every
            # other is held as given: the staged forward lends its saved
            # tensors and moves these very objects out of its graph's
            # buffers if they are still held when it runs again.
            returned = {id(flat[i]) for i in pos}
            ctx.thunder_saved = [t.detach() if id(t) in returned else t for t in saved]
            # Only the tree's other leaves: an output tensor held here would
            # keep its own grad_fn, and through this class's closure the
            # staged programs and their pools, alive past the outputs' life
            # (autograd's nodes are not traversed by the cycle collector).
            holder.update(flat=[None if i in pos else x for i, x in enumerate(flat)], spec=spec, pos=pos)
            return tuple(flat[i] for i in pos)

        @staticmethod
        def backward(ctx, *cotangents):
            saved, ctx.thunder_saved = ctx.thunder_saved, None
            # The backward clears ``saved`` as it goes (take_saved_as_list),
            # so each saved tensor is freed after its last use.
            grads = bwd(saved, *cotangents)
            return tuple(grads)

    sources = inputs if sources is None else sources
    outs = ThunderFunction.apply(*(sources[i] for i in wrt))
    if not isinstance(outs, tuple):
        outs = (outs,)
    flat = list(holder["flat"])
    for i, t in zip(holder["pos"], outs):
        flat[i] = t
    return tree_unflatten(flat, holder["spec"])


def _normalize_output(out):
    """Convert dataclass-style outputs (an HF ModelOutput, an OrderedDict
    subclass) into a plain dict of traceable entries; opaque stateful
    objects (KV caches) are dropped."""
    if type(out) in (dict, tuple, list) or isinstance(out, TensorProxy):
        return out
    if hasattr(out, "items") and hasattr(out, "to_tuple"):  # ModelOutput duck-type
        kept = {}
        for k, v in out.items():
            flat, _ = tree_flatten(v)
            if all(isinstance(x, TensorProxy) or x is None or isinstance(x, (int, float, bool)) for x in flat):
                kept[k] = v
        return kept
    return out


def thunder_module(module, **jit_options) -> ThunderModule:
    return ThunderModule(module, **jit_options)
