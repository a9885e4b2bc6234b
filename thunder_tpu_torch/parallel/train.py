"""The training step of a GPT: one joint fw+bw program, then AdamW or SGD.

The counterpart of ``thunder_tpu/parallel/train.py``, which the LitGPT
benchmark drives. On one device (no mesh):
``loss_fn`` is traced, dce'd, turned into one joint forward+backward trace
(``grad_transform``), its attention pairs rewritten to save (out, lse) for
the flash backward (``save_sdpa_residuals_joint``), claimed by the
executors and run eagerly with ``del`` after each last use. There is no
rematerialization on this path, as in the JAX package.

The optimizer runs outside the trace, on the grads the program returns:
AdamW with the JAX package's arithmetic (:func:`adamw_update`), or its
bf16-true SGD with weight decay. With ``donate=True`` the params (and the
AdamW state) are updated in place, the counterpart of donating them to the
JAX step. The step is staged whole, as ``thunder_tpu/parallel/train.py:213``
stages it under ``jax.jit``: on the card one CUDA graph
(``executors/staging.py``) runs the program and the optimizer.

**The sharded step** (``mesh``, ``param_specs``, ``batch_spec``). The JAX
step is one ``jax.jit`` over ``NamedSharding``s, and GSPMD places every
collective. The port is SPMD over processes with no partitioner: each rank
runs its own program on its blocks (``parallel.shard_pytree``), and the
program holds the collectives, placed per axis as follows.

- The batch is split by ``batch_spec`` (default ``data_spec``: dim 0 over
  ``(dp, fsdp)``, dim 1, the sequence, over ``sp``); these are the data
  axes. Each rank's loss is its block's mean, scaled by 1/N over the N data
  ranks, so that the grads summed over them are the global mean's; the
  loss returned is that sum. That is the global mean because every block
  holds as many positions and the step assumes targets that ignore none.
- **dp** (a data axis over which a param is replicated): the param passes
  through ``synchronize(..., "replicated")``, whose VJP all-reduces (sums)
  its grad over the axis.
- **fsdp** (a data axis over which a param is split, on whichever dim its
  spec names): ``synchronize(..., "fsdp", dim=d)`` all-gathers it before
  use, and its VJP reduce-scatters the grad back to the block. A param
  split over an axis that holds the same data (fsdp left out of
  ``batch_spec``) is gathered with ``all_gather(replicated_grad=True)``,
  whose VJP keeps this rank's block of the grad, with no collective.
- **tp**, Megatron's conjugate pair, with every replicated value's
  cotangent the same on each tp rank. A tp block opens with
  ``synchronize(x, "tp", ..., "replicated")`` (identity forward, all-reduce
  backward) and closes with ``all_reduce(replicated_grad=True)`` (all-reduce
  forward, identity backward).

  - The MLP is real tensor parallelism: ``fc_1``/``fc_2`` (or ``fc``) on
    this rank's block of the hidden units, the activation on the block,
    ``proj_w`` row-parallel on the matching block of its columns, the
    partial sums all-reduced over tp. No tp rank holds a whole MLP weight.
  - Attention: the fused qkv is laid out q heads, then k, then v, so a
    contiguous block of its rows holds no whole heads. The qkv block's
    output is all-gathered over tp (``all_gather(replicated_grad=True)``)
    before the head split, and every tp rank runs attention on all heads.
    ``attn.proj_w`` stays row-parallel on this rank's columns of the
    attention output (``axis_slice``, whose VJP all-gathers).
  - ``wte`` is all-gathered over tp before the lookup, and the head's
    vocab blocks of the logits before the CE kernel, so that it sees whole
    rows. Head-parallel attention and a vocab-parallel CE are later work;
    neither changes a result.
  - A param that tp replicates (a norm weight, ``proj_b``) has the same
    grad on every tp rank and is synced over the data axes only.
- **sp** (the sequence split over dim 1 of the batch): each rank holds
  ``T/n`` consecutive positions. The model takes a hook (``models/gpt.py``
  ``sp``): rope at the block's global positions, and attention over the
  whole sequence by ``parallel.context.ring_attention`` over ``sp``, the
  JAX package's own sequence-parallel attention (K/V heads of a GQA config
  expanded to the query heads first). With ``sp > 1`` attention is the
  ring's plain f32 products, not the flash kernel, and the step agrees
  with one device within a tolerance, not bit for bit. A param replicated
  over ``sp`` sums its grad over it, as over any data axis.
- **pp** and **ep**: the JAX step's param specs name neither and its batch
  spec splits no dim over them, so GSPMD runs the same program on every
  ``pp``/``ep`` rank. So does the port: no collective names them unless a
  spec does (then a split param is gathered, a batch dim 0 split over them
  is a data axis). The pipeline schedules and the expert shuffle are
  ``parallel/gpt_pp.py`` and ``parallel/moe.py``, outside this step.

The flash forward-with-residuals / backward pair, the CE kernel and rope
stay claimed inside the sharded step, each between the collectives and
never split by one. The comm scheduler (``transforms/comm_schedule.py``)
runs over the claimed program, as ``thunder_tpu/parallel/train.py``'s
``_compile_loss_and_grads`` asks it to; there it is a no-op under GSPMD,
here it hoists the fsdp gathers. On the card the per-rank step (program,
collectives and optimizer) is staged as one CUDA graph, each group warmed
before the capture (``distributed/runtime.resolve_axes``). Each rank keeps
only its blocks of the params and of the AdamW moments (ZeRO for the
optimizer, as the JAX step gets from its specs). At one rank no collective
is placed and the step is the one-device program, bit for bit.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from thunder_tpu_torch.core.pytree import tree_flatten, tree_map, tree_unflatten

# =============================================================================
# AdamW
# =============================================================================


def adamw_init(params: Any) -> dict:
    """{"step": 0-d int32, "m": zeros, "v": zeros}, the moments shaped and
    typed like the params, on the params' device."""
    leaves = tree_flatten(params)[0]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None),
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
    }


def scalar_as(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``. A Python scalar times a JAX array is
    computed in the array's type (weak typing: ``0.9 * bf16`` multiplies by
    bf16(0.9) = 0.8984375), where PyTorch would multiply by x in f32. The
    product of two bf16 values is exact in f32, so multiplying by the
    rounded scalar and rounding once gives JAX's bits."""
    return float(torch.tensor(x, dtype=dtype))


def adamw_update(params: Any, grads: Any, state: dict, *, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.0, in_place: bool = False) -> tuple[Any, dict]:
    """One AdamW step, ``(new_params, new_state)``, as the JAX package
    computes it: the grad is cast to the moments' type (the params' type);
    m = b1·m + (1−b1)·g and v = b2·v + (1−b2)·g², each product and sum
    rounded to that type, with the scalars in that type too
    (:func:`scalar_as`); the bias corrections 1−b^t are f32 0-d tensors, so
    the update (m/c1)/(sqrt(v/c2) + eps) + wd·p is f32 (JAX promotes a bf16
    array against an f32 one; PyTorch would not against a 0-d tensor, hence
    the explicit casts); it is rounded to the param's type before the lr
    multiply. The corrections stay on the device: no host sync.

    ``grads`` is a pytree shaped like ``params`` or the flat list of its
    leaves; a flat list is emptied as it goes, so each grad is freed once
    used. ``in_place`` updates params, moments and step in place and
    returns them."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    flat_p, spec = tree_flatten(params)
    flat_g = grads if isinstance(grads, list) and len(grads) == len(flat_p) else tree_flatten(grads)[0]
    flat_m, flat_v = tree_flatten(state["m"])[0], tree_flatten(state["v"])[0]
    out_p, out_m, out_v = [], [], []
    for i, (p, m, v) in enumerate(zip(flat_p, flat_m, flat_v)):
        g, flat_g[i] = flat_g[i].to(m.dtype), None
        m_new = torch.mul(m, scalar_as(b1, m.dtype)).add_(torch.mul(g, scalar_as(1.0 - b1, m.dtype)))
        v_new = torch.mul(v, scalar_as(b2, v.dtype)).add_(torch.mul(g, g).mul_(scalar_as(1.0 - b2, v.dtype)))
        del g
        update = (m_new.float() / c1) / (torch.sqrt(v_new.float() / c2) + eps)
        if weight_decay:
            update += weight_decay * p.float()
        delta = update.to(p.dtype).mul_(scalar_as(lr, p.dtype))
        del update
        if in_place:
            m.copy_(m_new)
            v.copy_(v_new)
            p.sub_(delta)
        else:
            out_p.append(p - delta)
            out_m.append(m_new)
            out_v.append(v_new)
    if in_place:
        state["step"].copy_(step)
        return params, state
    return (tree_unflatten(out_p, spec),
            {"step": step, "m": tree_unflatten(out_m, spec), "v": tree_unflatten(out_v, spec)})


def sgd_update(flat_p: list, grads: list, lr: float, weight_decay: float, in_place: bool) -> list:
    """bf16-true SGD: p − lr·(g + wd·p), each operation rounded to the
    param's type and the scalars in that type (:func:`scalar_as`), as the
    JAX step computes it; each grad is dropped from ``grads`` once used."""
    out = []
    for i, p in enumerate(flat_p):
        g, grads[i] = grads[i], None
        upd = torch.add(g.to(p.dtype), torch.mul(p, scalar_as(weight_decay, p.dtype)))
        del g
        upd.mul_(scalar_as(lr, p.dtype))
        out.append(p.sub_(upd) if in_place else p - upd)
    return out


# =============================================================================
# The training step
# =============================================================================


def opt_state_specs(param_specs, optimizer: str = "adamw") -> dict:
    """The spec tree of the optimizer state of :func:`adamw_init`: the
    moments take the params' specs (each rank holds their blocks), the step
    counter is replicated."""
    from thunder_tpu_torch.distributed.runtime import P

    if optimizer == "sgd":
        return {"step": P()}
    return {"step": P(), "m": param_specs, "v": param_specs}


def claimed_program(fn, example_args: tuple, executors, *, wrt: Optional[list] = None, comm_schedule: bool = False):
    """``(callable, extrace)``: ``fn`` traced on ``example_args``, claimed by
    ``executors`` (names, or None for the defaults) and run eagerly with a
    ``del`` after each last use. With ``wrt`` (the positions of the trace's
    tensor inputs to differentiate) the program is ``grad_transform``'s joint
    one, ``(value, grads)``, its attention pairs rewritten to save (out, lse)
    for the flash backward. ``comm_schedule`` runs the comm scheduler over
    the claimed program. The callable takes the tensor leaves of the
    arguments in pytree order."""
    from thunder_tpu_torch import api
    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.executors.passes import del_last_used, transform_for_execution
    from thunder_tpu_torch.extend import resolve_executors
    from thunder_tpu_torch.transforms.attention_residuals import save_sdpa_residuals_joint
    from thunder_tpu_torch.transforms.autodiff import grad_transform
    from thunder_tpu_torch.transforms.common import dce

    ex_list = resolve_executors(list(executors) if executors else None)
    device = next(x.device for x in tree_flatten(example_args)[0] if isinstance(x, torch.Tensor))
    with devices.default_device(device):
        _, comp = api.trace_program(fn, example_args, {})
        comp = dce(comp)
        if wrt is not None:
            comp = grad_transform(comp, return_value=True, wrt=[comp.args[i] for i in wrt])
            comp = save_sdpa_residuals_joint(comp, ex_list)
        extrace = del_last_used(transform_for_execution(comp, ex_list, comm_schedule=comm_schedule))
    return extrace.python_callable(), extrace


def _compile_loss_and_grads(config, params, idx: torch.Tensor, targets: torch.Tensor, executors=None, plan=None):
    """Trace ``loss_fn`` into one claimed joint program: ``(callable,
    extrace)``; the callable takes the params' leaves, idx and targets, and
    returns ``(loss, grads)`` with a grad for every param leaf. ``plan``
    (a :class:`_ShardPlan`) traces this rank's program on its blocks, with
    the collectives; the comm scheduler runs over the claimed program."""
    from thunder_tpu_torch.models.gpt import loss_fn

    fn = (lambda p, i, t: loss_fn(p, i, t, config)) if plan is None else plan.loss_fn(config)
    n_params = len(tree_flatten(params)[0])
    return claimed_program(fn, (params, idx, targets), executors, wrt=list(range(n_params)), comm_schedule=True)


# =============================================================================
# The sharded program
# =============================================================================

class _TensorParallel:
    """The tp collectives and blocks ``models/gpt.py`` uses. The model
    decides which weights it reads as tp blocks (:meth:`block`); a
    weight's spec decides whether its region runs on blocks
    (:meth:`split_on`)."""

    def __init__(self, n: int):
        self.n = n

    def split_on(self, p, key: str, dim: int) -> bool:
        """Whether ``p[key]``'s spec splits dim ``dim`` over tp alone."""
        return key in p and p.spec(key).dim_axes(dim) == ("tp",)

    def block(self, p, key: str, dim: int):
        """This rank's tp block of ``p[key]`` along ``dim`` (None where
        ``p`` has no ``key``)."""
        return p.block(key, dim) if key in p else None

    def enter(self, x):
        from thunder_tpu_torch.distributed import prims as dist

        return dist.synchronize(x, "tp", self.n, "replicated", grad_scale=1.0)

    def exit(self, y):
        from thunder_tpu_torch.distributed import prims as dist

        return dist.all_reduce(y, "tp", self.n, replicated_grad=True)

    def gather(self, x, dim: int):
        from thunder_tpu_torch.distributed import prims as dist

        return dist.all_gather(x, "tp", self.n, dim=dim, replicated_grad=True)

    def split(self, x, dim: int):
        from thunder_tpu_torch.distributed import prims as dist

        return dist.axis_slice(x, "tp", self.n, dim=dim)


class _SequenceParallel:
    """The sequence split ``models/gpt.py`` reads: this rank's block of
    positions starts at its index along the axis times the block's length,
    and attention runs over the whole sequence as ring attention. The
    index is read from the group bound to the axis when the rank traces."""

    def __init__(self, axis: str):
        self.axis = axis

    def offset(self, T_local: int) -> int:
        from thunder_tpu_torch.distributed import runtime

        return runtime.axis_index(self.axis) * T_local

    def attention(self, q, k, v, n_head: int, n_groups: int):
        import thunder_tpu_torch.torch as ttorch
        from thunder_tpu_torch.parallel.context import ring_attention

        if n_groups != n_head:
            # Query head h reads K/V head h // (n_head / n_groups), as SDPA's
            # enable_gqa does.
            k = ttorch.repeat_interleave(k, n_head // n_groups, 1)
            v = ttorch.repeat_interleave(v, n_head // n_groups, 1)
        return ring_attention(q, k, v, self.axis, causal=True)


class _Synced(dict):
    """A params dict of this rank's blocks, read by the traced program: a
    weight is synced (``_ShardPlan.sync``) where the program first reads
    it, so each gather sits beside its use. ``p[k]`` is the whole weight,
    ``p.block(k, dim)`` this rank's tp block of it."""

    def __init__(self, tree: dict, specs: dict, plan: "_ShardPlan"):
        super().__init__(tree)
        self._specs, self._plan, self._done = specs, plan, {}

    def __getitem__(self, k):
        v, s = dict.__getitem__(self, k), self._specs[k]
        if isinstance(v, dict):
            return _Synced(v, s, self._plan)
        if isinstance(v, list):
            return [_Synced(b, sb, self._plan) for b, sb in zip(v, s)]
        return self._synced(k, None)

    def get(self, k, default=None):
        return self[k] if k in self else default

    def spec(self, k):
        return self._specs[k]

    def block(self, k, dim: int):
        return self._synced(k, dim)

    def _synced(self, k, tp_dim: Optional[int]):
        if (k, tp_dim) not in self._done:
            self._done[k, tp_dim] = self._plan.sync(dict.__getitem__(self, k), self._specs[k], tp_dim)
        return self._done[k, tp_dim]


class _ShardPlan:
    """What one rank of the sharded step computes: the axis sizes, the data
    axes, and each param's spec."""

    def __init__(self, mesh, param_specs, batch_spec):
        from thunder_tpu_torch.distributed.runtime import P
        from thunder_tpu_torch.parallel.mesh import axis_sizes
        from thunder_tpu_torch.parallel.sharding import _flat_specs

        self.sizes = axis_sizes(mesh)
        self.tp = self.sizes.get("tp", 1)
        self.specs, self.batch_spec = param_specs, batch_spec
        wide = lambda d: tuple(ax for ax in batch_spec.dim_axes(d) if self.sizes.get(ax, 1) > 1)  # noqa: E731
        if any(wide(d) for d in range(2, len(batch_spec))):
            raise ValueError(f"batch_spec {batch_spec!r} splits a dim past the sequence of a (B, T) batch")
        seq = wide(1)
        if len(seq) > 1:
            raise ValueError(f"the sequence splits over one axis, not {seq}")
        self.data_axes = wide(0) + seq
        if "tp" in self.data_axes:
            raise ValueError("the batch cannot be split over tp: its ranks compute on the same rows")
        self.seq_axis = seq[0] if seq else None
        self.n_data = 1
        for ax in self.data_axes:
            self.n_data *= self.sizes[ax]
        named = {ax for s in _flat_specs(param_specs) if isinstance(s, P) for ax in s.axes}
        self.axes = tuple(ax for ax, n in self.sizes.items()
                          if n > 1 and (ax in self.data_axes or ax in named or ax == "tp"))

    def sync(self, x, spec, tp_dim: Optional[int]):
        """The value the program computes with for a param block ``x``: the
        whole param, or with ``tp_dim`` this rank's tp block of it along
        that dim. A dim split over tp alone is gathered last, so that the
        other axes' gathers (and their reduce-scatters) move the block."""
        from thunder_tpu_torch.distributed import prims as dist

        named = set(spec.axes)
        for ax in self.data_axes:
            if ax not in named:
                x = dist.synchronize(x, ax, self.sizes[ax], "replicated", grad_scale=1.0)
        keep = tp_dim is not None and spec.dim_axes(tp_dim) == ("tp",)
        for d, axes in sorted(spec.sharded, key=lambda da: da[1] == ("tp",)):
            if keep and d == tp_dim:
                continue
            for ax in reversed(axes):
                n = self.sizes.get(ax, 1)
                if n == 1:
                    continue
                if ax in self.data_axes:
                    x = dist.synchronize(x, ax, n, "fsdp", grad_scale=1.0, dim=d)
                else:
                    x = dist.all_gather(x, ax, n, dim=d, replicated_grad=True)
        if tp_dim is not None and not keep:
            x = dist.axis_slice(x, "tp", self.tp, dim=tp_dim)
        return x

    def loss_fn(self, config):
        from thunder_tpu_torch.models.gpt import loss_fn

        tp = _TensorParallel(self.tp) if self.tp > 1 else None
        sp = _SequenceParallel(self.seq_axis) if self.seq_axis is not None else None

        def sharded_loss(params, idx, targets):
            loss = loss_fn(_Synced(params, self.specs, self), idx, targets, config, tp, sp)
            return loss * (1.0 / self.n_data) if self.n_data > 1 else loss

        return sharded_loss

    def check(self, config, params) -> None:
        """Each leaf is this rank's block by its spec (not the whole
        value)."""
        from thunder_tpu_torch.core.pytree import tree_flatten
        from thunder_tpu_torch.distributed.runtime import P
        from thunder_tpu_torch.models.gpt import _map_spec, _param_shapes
        from thunder_tpu_torch.parallel.sharding import align_specs

        full = align_specs(_map_spec(_param_shapes(config), lambda shape, init: tuple(shape)), params)
        shapes = tree_flatten(full, is_leaf=lambda x: isinstance(x, tuple))[0]
        got = [tuple(x.shape) for x in tree_flatten(params)[0]]
        specs = tree_flatten(self.specs, is_leaf=lambda x: isinstance(x, P))[0]
        for whole, have, s in zip(shapes, got, specs):
            want = list(whole)
            for d, axes in s.sharded:
                for ax in axes:
                    want[d] //= self.sizes.get(ax, 1)
            if tuple(want) != have:
                raise ValueError(f"a param of shape {have} is not this rank's block {tuple(want)} of {whole} by "
                                 f"{s!r}: pass parallel.shard_pytree(params, mesh, specs)")


def build_train_step(
    config,
    params: dict,
    idx: torch.Tensor,
    targets: torch.Tensor,
    *,
    mesh: Any = None,
    param_specs: Any = None,
    batch_spec: Any = None,
    lr: float = 3e-4,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grads_in_f32: bool = True,
    donate: bool = True,
    executors: Optional[list] = None,
    optimizer: str = "adamw",
    return_extrace: bool = False,
):
    """Build one training step (fw+bw, then AdamW or SGD) of GPT ``config``
    for inputs shaped like ``idx`` and ``targets`` (int tensors on the
    params' device). Returns ``(step_fn, opt_state)``, plus the claimed
    joint trace with ``return_extrace=True``;
    ``step_fn(params, opt_state, idx, targets) -> (params, opt_state, loss)``,
    staged as a CUDA graph on the card (``executors/staging.py``: the first
    call runs eagerly, the second captures, later calls replay).
    ``step_fn.loss_and_grads`` is the claimed program itself:
    ``(*param_leaves, idx, targets) -> (loss, grads)``; ``step_fn.eager``
    is the step unstaged, and ``step_fn.staging`` its ``StagingStats``.

    ``grads_in_f32`` casts each grad to f32 before the update. ``donate``
    updates params and optimizer state in place (the returned ones are the
    same tensors); without it the inputs are left as they were. ``executors``
    lists executor names in priority order (default: flash, fused, torch).

    With ``mesh`` (``parallel.make_mesh``) the step is the sharded one (the
    module docstring): ``params`` are this rank's blocks by ``param_specs``
    (``parallel.shard_pytree``; default: all replicated, data parallelism),
    and so are the params and AdamW moments the step takes and returns;
    ``idx`` and ``targets`` are the global batch, the same on every rank,
    split by ``batch_spec`` (default ``parallel.data_spec(mesh)``); the
    loss is the global batch's. Every rank of the mesh calls the step."""
    if optimizer not in ("adamw", "sgd"):
        raise ValueError(f"optimizer must be 'adamw' or 'sgd', got {optimizer!r}")
    if mesh is None and (param_specs is not None or batch_spec is not None):
        raise ValueError("param_specs and batch_spec need a mesh")
    from thunder_tpu_torch.distributed import runtime

    plan, groups = None, {}
    local_idx, local_tgt = idx, targets
    if mesh is not None:
        from thunder_tpu_torch.distributed.runtime import P
        from thunder_tpu_torch.parallel.sharding import align_specs, data_spec

        if param_specs is None:
            param_specs = tree_map(lambda _: P(), params)
        plan = _ShardPlan(mesh, align_specs(param_specs, params), batch_spec if batch_spec is not None
                          else data_spec(mesh))
        plan.check(config, params)
        if plan.seq_axis is not None and idx.shape[1] % plan.sizes[plan.seq_axis]:
            raise ValueError(f"a sequence of {idx.shape[1]} positions does not split over the "
                             f"{plan.sizes[plan.seq_axis]} ranks of {plan.seq_axis!r}")
        groups = runtime.resolve_axes(mesh, plan.axes) if plan.axes else {}
        local_idx, local_tgt = (runtime.split(x, plan.batch_spec, groups) for x in (idx, targets))
    with runtime.bound_axes(groups):
        loss_and_grads, extrace = _compile_loss_and_grads(config, params, local_idx, local_tgt, executors, plan)

    def run_program(flat_p, idx, targets):
        if plan is None:
            return loss_and_grads(*flat_p, idx, targets)
        from thunder_tpu_torch.distributed import prims as dist

        with runtime.bound_axes(groups):
            idx, targets = (runtime.split(x, plan.batch_spec, groups) for x in (idx, targets))
            loss, grads = loss_and_grads(*flat_p, idx, targets)
            for ax in plan.data_axes:
                loss = dist._reduce(loss, groups[ax], plan.sizes[ax], "sum")
        return loss, grads

    @torch.no_grad()
    def eager_step(params, opt_state, idx, targets):
        flat_p, p_spec = tree_flatten(params)
        loss, grads = run_program(flat_p, idx, targets)
        grads = [g.float() for g in grads] if grads_in_f32 else list(grads)
        if optimizer == "sgd":
            new_p = sgd_update(flat_p, grads, lr, weight_decay, in_place=donate)
            return (params if donate else tree_unflatten(new_p, p_spec)), opt_state, loss
        new_params, new_state = adamw_update(params, grads, opt_state, lr=lr, b1=b1, b2=b2,
                                             weight_decay=weight_decay, in_place=donate)
        return new_params, new_state, loss

    from thunder_tpu_torch.executors import staging

    step, stats = staging.stage(eager_step, [extrace], idx.device,
                                name="train step" if plan is None else "sharded train step")
    step.loss_and_grads, step.eager, step.staging = loss_and_grads, eager_step, stats
    opt_state = adamw_init(params) if optimizer == "adamw" else {"step": 0}
    return (step, opt_state, extrace) if return_extrace else (step, opt_state)
