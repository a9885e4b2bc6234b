"""Pipeline parallelism: GPipe and 1F1B schedules over a ``pp`` mesh axis.

The counterpart of ``thunder_tpu/parallel/pipeline.py``. Stages live on
consecutive ranks of the ``pp`` axis, and activations hop stage to stage by
``ppermute``. The JAX package writes each schedule as one ``lax.scan`` in one
SPMD program; the port is one process a rank, and each rank knows its stage
when it traces, so:

- :func:`pipeline_apply` (GPipe forward) is traced whole on each rank, its
  ``n_micro + n_stages − 1`` ticks unrolled and its hops ``ppermute``
  prims: ``grad_transform`` of a program that calls it is pipeline-parallel
  backprop (the ``ppermute`` VJP is the reverse hop), keeping every
  microbatch's residuals, as ``jax.grad`` of the scan does.
- :func:`pipeline_1f1b` runs the one-forward-one-backward schedule on the
  host: at each tick this rank runs its stage's claimed forward program
  and its claimed backward program (``grad_transform`` of the stage's
  recompute-from-input, which gives the value, the input's cotangent and the
  params' grads), and does both hops. The last stage sends no activation
  on, so it stashes its input and runs no forward program: its backward
  recomputes the forward anyway. The input stash is a circular buffer
  of depth ``n_stages``, so the activation memory is independent of
  ``n_micro``. On the card the whole step (every tick's programs and hops)
  is staged as one CUDA graph by its caller (``parallel/gpt_pp.py``), the
  seat of the JAX package's one ``jit`` of the scan.

Every tick does the ``down`` and the ``up`` hop on every rank, as the JAX
scan does: a rank that skipped a hop its neighbour posts would deadlock. A
stage's work at a tick where it holds no microbatch reaches no output (JAX
computes it under a mask), so the port runs none there; stage 0 and the
last stage have programs of their own in place of JAX's ``where(stage ==
…)`` masks. The axis size and this rank's index are read from the group
bound to the axis (``distributed.runtime.axis_size``/``axis_index``); at one
stage no hop is placed (an empty permutation gives zeros).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

import thunder_tpu_torch.torch as ttorch
from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.pytree import tree_flatten, tree_map, tree_unflatten
from thunder_tpu_torch.parallel.train import claimed_program


def _identity_first(params, x):
    return x


def _identity_last(params, y, mb):
    return y


def _index_stream(xs, i: int):
    """A pytree of (n_micro, ...) streams at microbatch i."""
    return tree_map(lambda a: a[i], xs)


def _stream_len(xs) -> int:
    return tree_flatten(xs)[0][0].shape[0]


def _axis(axis_name: str) -> tuple[int, int]:
    from thunder_tpu_torch.distributed import runtime

    return runtime.axis_size(axis_name), runtime.axis_index(axis_name)


def _hops(n_stages: int) -> tuple[list, list]:
    """The ``down`` (stage i to i+1) and ``up`` (i+1 to i) permutations."""
    return [(i, i + 1) for i in range(n_stages - 1)], [(i + 1, i) for i in range(n_stages - 1)]


def pipeline_apply(stage_fn: Callable, local_params, xs, axis_name: str, *, first_fn: Optional[Callable] = None,
                   last_fn: Optional[Callable] = None, act_shape: Optional[tuple] = None, act_dtype=None,
                   out_shape: Optional[tuple] = None, out_dtype=None):
    """GPipe forward over the ``axis_name`` axis, traced in this rank's
    program.

    stage_fn(params, act) -> act is the trunk (shape-preserving);
    first_fn(params, microbatch) -> act is stage 0's input adapter and
    last_fn(params, act, microbatch) -> out the last stage's output adapter
    (identities by default; last_fn receives the microbatch its activation
    came from). local_params: this stage's params; xs: a pytree of
    (n_micro, ...) streams. act_shape/act_dtype: the trunk activation
    (default: xs's leaf's); out_shape/out_dtype: last_fn's output (default:
    what last_fn gives, found in a detached trace).

    Returns (n_micro,) + out_shape outputs, replicated over the axis by an
    all-reduce whose VJP passes the (replicated) cotangent on.
    ``n_micro + n_stages − 1`` ticks (the GPipe bubble)."""
    from thunder_tpu_torch.core.trace import detached_trace
    from thunder_tpu_torch.distributed import prims as dist

    first_fn = first_fn or _identity_first
    last_fn = last_fn or _identity_last
    n_stages, stage = _axis(axis_name)
    n_micro = _stream_len(xs)
    down, _ = _hops(n_stages)
    leaf = tree_flatten(xs)[0][0]
    if act_shape is None:
        act_shape, act_dtype = tuple(leaf.shape[1:]), leaf.dtype
    zeros = lambda: ttorch.zeros(tuple(act_shape), dtype=act_dtype, device=leaf.device)  # noqa: E731
    if out_shape is None:
        with detached_trace():
            o = last_fn(local_params, zeros(), _index_stream(xs, 0))
        out_shape, out_dtype = tuple(o.shape), o.dtype

    act = zeros()
    outs = []
    for t in range(n_micro + n_stages - 1):
        recv = dist.ppermute(act, axis_name, down) if down else None
        j = t - stage  # the microbatch this stage holds at tick t
        if 0 <= j < n_micro:
            x_in = first_fn(local_params, _index_stream(xs, j)) if stage == 0 else recv
            act = stage_fn(local_params, x_in)
            if stage == n_stages - 1:
                outs.append(last_fn(local_params, act, _index_stream(xs, j)))
        else:
            act = zeros()
    if stage == n_stages - 1:
        out = ttorch.stack(outs, 0)
    else:
        out = ttorch.zeros((n_micro,) + tuple(out_shape), dtype=out_dtype, device=leaf.device)
    return dist.all_reduce(out, axis_name, n_stages, replicated_grad=True) if n_stages > 1 else out


# =============================================================================
# 1F1B
# =============================================================================


def call_flat(fn: Callable, *args):
    """``fn`` (a ``train.claimed_program`` callable) on the tensor leaves of
    ``args``."""
    return fn(*[x for x in tree_flatten(args)[0] if isinstance(x, torch.Tensor)])


class OneFOneB:
    """One rank's 1F1B schedule over its stage's claimed programs (see
    :func:`pipeline_1f1b`): built once on example values, then called as
    ``run(local_params, xs) -> (loss, grads)`` inside the bound axes.
    ``traces`` are the claimed programs (the stage forward, none on the
    last stage, then the recompute-and-VJP); ``stats`` holds the last run's
    ``ticks``, ``fwd_calls`` (the stage forward's calls), ``bwd_calls`` and
    ``stash_peak`` (the most stashed inputs awaiting their backward at
    once)."""

    def __init__(self, stage_fn, local_params, xs, axis_name: str, *, first_fn=None, last_fn=None, act_shape=None,
                 act_dtype=None, executors=("torch",)):
        if last_fn is None:
            raise ValueError("pipeline_1f1b requires last_fn: (params, act, microbatch) -> scalar loss; the "
                             "schedule seeds its backward from it")
        first_fn = first_fn or _identity_first
        self.axis = axis_name
        self.n_stages, self.stage = _axis(axis_name)
        self.n_micro = _stream_len(xs)
        leaf = tree_flatten(xs)[0][0]
        if act_shape is None:
            act_shape, act_dtype = tuple(leaf.shape[1:]), leaf.dtype
        self.act_shape, self.device = tuple(act_shape), leaf.device
        self.act_dtype = dtypes.to_torch_dtype(dtypes.to_dtype(act_dtype))
        self.down, self.up = _hops(self.n_stages)
        first, last, n_micro = self.stage == 0, self.stage == self.n_stages - 1, self.n_micro

        def fwd_one(params, x):
            """One stage-forward of one microbatch: x is the microbatch on
            stage 0 (through first_fn), the received activation elsewhere."""
            return stage_fn(params, first_fn(params, x) if first else x)

        def full(params, x, ct):
            """The stage's forward recomputed from its stashed input, then
            the last stage's loss seeded with 1/n_micro, or elsewhere the
            inner product with the received cotangent (its VJP)."""
            y = fwd_one(params, x)
            if last:
                return (last_fn(params, y, ct) / n_micro).float()
            return ttorch.sum(y.float() * ct.float())

        mb0 = _index_stream(xs, 0)
        act0 = self._zeros()
        x0 = mb0 if first else act0
        # The last stage's third argument is the microbatch (its targets),
        # elsewhere the cotangent received from the next stage.
        third = mb0 if last else act0
        n_p = len(tree_flatten(local_params)[0])
        n_x = len([t for t in tree_flatten(x0)[0] if isinstance(t, torch.Tensor)])
        # The last stage's forward reaches nothing (no hop down from it), so
        # it has no forward program.
        self.fwd, fwd_traces = None, ()
        if not last:
            self.fwd, fwd_trace = claimed_program(fwd_one, (local_params, x0), executors)
            fwd_traces = (fwd_trace,)
        self.bwd, bwd_trace = claimed_program(full, (local_params, x0, third), executors,
                                              wrt=list(range(n_p)) + ([] if first else list(range(n_p, n_p + n_x))))
        self.traces = fwd_traces + (bwd_trace,)
        self.stats: dict = {}

    def _hop(self, x, perm):
        from thunder_tpu_torch.distributed import prims as dist

        return dist._pp(x, self.axis, perm) if perm else torch.zeros_like(x)

    def _zeros(self):
        return torch.zeros(self.act_shape, dtype=self.act_dtype, device=self.device)

    def __call__(self, local_params, xs):
        from thunder_tpu_torch.distributed import prims as dist
        from thunder_tpu_torch.distributed import runtime

        S, s, M = self.n_stages, self.stage, self.n_micro
        first, last = s == 0, s == S - 1
        flat_p, p_spec = tree_flatten(local_params)
        stash: list = [None] * S  # the circular input buffer, one slot a stage
        grads: Optional[list] = None
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        act_fwd, ct_bwd = self._zeros(), self._zeros()
        stats = {"ticks": 2 * (M + S - 1), "fwd_calls": 0, "bwd_calls": 0, "stash_peak": 0}
        for t in range(stats["ticks"]):
            # Forward phase: stage s runs microbatch f at tick s + 2f.
            recv_act = self._hop(act_fwd, self.down)
            act_fwd = self._zeros()
            if (t - s) % 2 == 0 and 0 <= (t - s) // 2 < M:
                f = (t - s) // 2
                mb = _index_stream(xs, f)
                x = mb if first else recv_act
                if not last:
                    act_fwd = call_flat(self.fwd, flat_p, x)
                    stats["fwd_calls"] += 1
                if stash[f % S] is not None:
                    raise RuntimeError(f"1F1B: microbatch {f} would overwrite stash slot {f % S} before its backward")
                stash[f % S] = (mb, x)
                stats["stash_peak"] = max(stats["stash_peak"], sum(e is not None for e in stash))
            # Backward phase: stage s runs microbatch b at tick
            # 2(S − 1) − s + 2b + 1, the opposite parity.
            recv_ct = self._hop(ct_bwd, self.up)
            ct_bwd = self._zeros()
            b_off = t - (2 * (S - 1) - s) - 1
            if b_off % 2 == 0 and 0 <= b_off // 2 < M:
                b = b_off // 2
                mb, x = stash[b % S]
                stash[b % S] = None
                val, g = call_flat(self.bwd, flat_p, x, mb if last else recv_ct)
                g_params = g[:len(flat_p)]
                if not first:
                    ct_bwd = g[len(flat_p)]
                # f32 accumulators: n_micro additions in bf16 would lose bits.
                if grads is None:
                    grads = [gp.float() for gp in g_params]
                else:
                    for acc, gp in zip(grads, g_params):
                        acc.add_(gp)
                if last:
                    loss = loss + val  # val is already loss / n_micro
                stats["bwd_calls"] += 1
        if S > 1:
            loss = dist._reduce(loss, runtime.group_of(self.axis, S), S, "sum")
        self.stats = stats
        return loss, tree_unflatten(grads, p_spec)


def pipeline_1f1b(stage_fn: Callable, local_params, xs, axis_name: str, *, first_fn: Optional[Callable] = None,
                  last_fn: Optional[Callable] = None, act_shape: Optional[tuple] = None, act_dtype=None,
                  executors=("torch",)):
    """1F1B pipeline training step: ``(mean loss, param grads)``.

    ``last_fn(params, act, microbatch) -> scalar loss`` a microbatch; the
    backward is seeded with ``1/n_micro`` (the mean over microbatches).
    Stage s runs the forward of microbatch f at tick ``s + 2f`` and its
    backward at ``2(n_stages − 1) − s + 2b + 1``, over ``2(n_micro +
    n_stages − 1)`` ticks; activations hop down on the forward phase and
    cotangents up on the backward phase. The backward recomputes the
    stage's forward from its stashed input. ``executors`` claim the stage
    programs (the JAX package's stage functions come claimed already).

    Returns ``(loss, grads)``: the loss summed over the axis (it carries
    1/n_micro), and f32 grads matching ``local_params``, each stage's for
    its own slice (a param only some stages use has zero grads on the
    others). Called inside the bound axes, as the JAX function runs inside
    ``shard_map``."""
    return OneFOneB(stage_fn, local_params, xs, axis_name, first_fn=first_fn, last_fn=last_fn, act_shape=act_shape,
                    act_dtype=act_dtype, executors=executors)(local_params, xs)


__all__ = ["pipeline_apply", "pipeline_1f1b", "OneFOneB", "call_flat"]
