"""The GPT split embed → blocks → head across a ``pp`` mesh axis.

The counterpart of ``thunder_tpu/parallel/gpt_pp.py``: stage 0 embeds token
ids (``first_fn``), each stage runs ``n_layer / n_stages`` consecutive
blocks (``stage_fn``), and the last stage applies the final norm, the head
and the cross-entropy (``last_fn``); the fixed-shape trunk activation
(mb, T, n_embd) is the only traffic between stages, and the microbatch
stream is token ids and targets. Both schedules run it: GPipe
(:func:`~thunder_tpu_torch.parallel.pipeline.pipeline_apply` under
``grad_transform``) and 1F1B (:func:`~thunder_tpu_torch.parallel.pipeline.
pipeline_1f1b`).

Where the claiming happens. The JAX package's ``_staged`` turns each adapter
into a finished jax callable that ``lax.scan`` then schedules. Here the
three functions stay functions of the torch language, so that the schedules
can trace through them: GPipe traces the whole schedule of this rank into
one program, and 1F1B traces each stage's forward and its
recompute-and-VJP. Each of those programs is claimed by ``executors`` when
it is built (``train.claimed_program``), so the flash, rope and CE
kernels are claimed inside the stages. ``executors`` defaults to
``("torch",)``, the seat of the JAX package's ``("jax",)``; None is the
default list. The rope tables are built from the traced activations, so
they take the live params' dtype.

The step each rank runs (:func:`build_gpt_pp_step`) is staged as one CUDA
graph on the card, the seat of the JAX package's ``jax.jit``;
:func:`gpt_pp_loss_and_grads` keeps the step it built last, as ``jax.jit``
keeps its compilations.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from thunder_tpu_torch.core.pytree import tree_flatten, tree_map, tree_unflatten
from thunder_tpu_torch.models.gpt import GPTConfig


def split_params_for_pp(params: dict, n_stages: int) -> dict:
    """Stack the per-stage parameters for a ``P("pp")`` split of dim 0.

    Returns {"blocks": a list of ``n_layer / n_stages`` block dicts whose
    leaves have a leading (n_stages,) axis, "wte"/"ln_f"/"lm_head_w": as
    given (replicated)}. Stage s's slice of each leaf is its own blocks."""
    blocks = params["blocks"]
    n_layer = len(blocks)
    if n_layer % n_stages:
        raise ValueError(f"{n_layer} layers do not split over {n_stages} pipeline stages")
    per = n_layer // n_stages
    stage_blocks = [blocks[s * per:(s + 1) * per] for s in range(n_stages)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *stage_blocks)
    return {"blocks": stacked, "wte": params["wte"], "ln_f": params["ln_f"], "lm_head_w": params["lm_head_w"]}


def merge_pp_grads(grads: dict, n_stages: int, n_layer: int) -> dict:
    """The inverse of :func:`split_params_for_pp` for a gradient pytree: the
    per-stage block grads unstacked into the flat ``blocks`` list."""
    blocks = []
    for s in range(n_stages):
        blocks.extend(tree_map(lambda x: x[s], grads["blocks"]))
    return {"wte": grads["wte"], "blocks": blocks, "ln_f": grads["ln_f"], "lm_head_w": grads["lm_head_w"]}


def build_gpt_pp_fns(config: GPTConfig, n_stages: int, mb: int, T: int, *,
                     executors: Optional[Sequence[str]] = ("torch",), dtype=None):
    """(first_fn, stage_fn, last_fn) for the pipeline schedules, functions of
    the torch language.

    first_fn(params, stream) embeds stream["idx"]; stage_fn(params, x)
    applies the stage's blocks; last_fn(params, act, stream) is the mean
    cross-entropy of the microbatch against stream["tgt"]. They are not
    claimed here: ``executors`` is kept for the JAX package's signature,
    and the schedule claims the programs that trace these functions. Each
    checks when it is traced that its activations are (mb, T, n_embd) of
    ``dtype`` (default bf16): a stage traced on another raises."""
    from thunder_tpu_torch.core import dtypes
    from thunder_tpu_torch.models import gpt as m
    import thunder_tpu_torch.torch as ttorch

    want = dtypes.to_torch_dtype(dtypes.to_dtype(dtype if dtype is not None else torch.bfloat16))

    def check(x):
        got = dtypes.to_torch_dtype(x.dtype)
        if got != want or tuple(x.shape) != (mb, T, config.n_embd):
            raise ValueError(f"a pipeline stage built for {want} activations of shape {(mb, T, config.n_embd)} was "
                             f"traced on {got} {tuple(x.shape)}")
        return x

    def first_fn(params, stream):
        return check(ttorch.embedding(stream["idx"], params["wte"]))

    def stage_fn(params, x):
        check(x)
        cos, sin = m._rope_cache(T, config, device=x.device, dtype=x.dtype)
        for p in params["blocks"]:
            x = m._block(x, p, cos, sin, config)
        return x

    def last_fn(params, y, stream):
        x = m._norm(check(y), params["ln_f"], config)
        logits = ttorch.linear(x, params["lm_head_w"])
        B, TT, V = logits.shape
        return ttorch.cross_entropy(ttorch.reshape(logits.float(), (B * TT, V)),
                                    ttorch.reshape(stream["tgt"], (B * TT,)))

    return first_fn, stage_fn, last_fn


def _local(params: dict, stage: int, per: int) -> dict:
    """This stage's params: its blocks (views, in place of a slice of the
    stacked tree) and the replicated embed and head weights."""
    return {"blocks": params["blocks"][stage * per:(stage + 1) * per], "wte": params["wte"],
            "ln_f": params["ln_f"], "lm_head_w": params["lm_head_w"]}


def build_gpt_pp_step(config: GPTConfig, params: dict, idx, tgt, mesh, *, n_micro: int, schedule: str = "1f1b",
                      executors: Optional[Sequence[str]] = ("torch",)):
    """This rank's pipelined step of a ``models/gpt.py`` GPT:
    ``step(params, idx, tgt) -> (loss, grads)`` with the arguments and
    results of :func:`gpt_pp_loss_and_grads`, built for inputs shaped like
    ``params``, ``idx`` and ``tgt`` on the mesh's ``pp`` axis. Staged as one
    CUDA graph on the card (the first call eager, the second captures);
    ``step.staging`` is its ``StagingStats``, ``step.traces`` the claimed
    programs, ``step.schedule`` the 1F1B schedule (its ``stats``)."""
    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.distributed import runtime
    from thunder_tpu_torch.distributed.runtime import P
    from thunder_tpu_torch.executors import staging
    from thunder_tpu_torch.parallel import pipeline
    from thunder_tpu_torch.parallel.train import claimed_program

    if schedule not in ("1f1b", "gpipe"):
        raise ValueError(f"schedule must be '1f1b' or 'gpipe', got {schedule!r}")
    n_stages = mesh.shape["pp"]
    B, T = idx.shape
    if B % n_micro:
        raise ValueError(f"a batch of {B} does not split into {n_micro} microbatches")
    if config.n_layer % n_stages:
        raise ValueError(f"{config.n_layer} layers do not split over {n_stages} pipeline stages")
    mb, per = B // n_micro, config.n_layer // n_stages
    # The live params' dtype, not the bf16 default: an f32 model traced as
    # bf16 would run its trunk in bf16.
    act_dtype = tree_flatten(params)[0][0].dtype
    first_fn, stage_fn, last_fn = build_gpt_pp_fns(config, n_stages, mb, T, dtype=act_dtype)
    groups = runtime.mesh_groups(mesh)
    with runtime.bound_axes(groups):
        stage = runtime.axis_index("pp")
    act_shape = (mb, T, config.n_embd)
    fn_kw = dict(first_fn=first_fn, last_fn=last_fn, act_shape=act_shape, act_dtype=act_dtype)

    def streams(idx, tgt):
        return {"idx": idx.reshape(n_micro, mb, T), "tgt": tgt.reshape(n_micro, mb, T)}

    lp0, xs0 = _local(params, stage, per), streams(idx, tgt)
    one_f_one_b = None
    with runtime.bound_axes(groups):
        if schedule == "1f1b":
            one_f_one_b = pipeline.OneFOneB(stage_fn, lp0, xs0, "pp", executors=executors, **fn_kw)
            traces = one_f_one_b.traces
        else:
            def gpipe_loss(lp, xs):
                losses = pipeline.pipeline_apply(stage_fn, lp, xs, "pp", out_shape=(), out_dtype=torch.float32,
                                                 **fn_kw)
                import thunder_tpu_torch.torch as ttorch

                return ttorch.mean(losses)

            n_p = len(tree_flatten(lp0)[0])
            program, extrace = claimed_program(gpipe_loss, (lp0, xs0), executors, wrt=list(range(n_p)))
            traces = (extrace,)

    def eager_step(params, idx, tgt):
        lp = _local(params, stage, per)
        with runtime.bound_axes(groups):
            if one_f_one_b is not None:
                loss, g = one_f_one_b(lp, streams(idx, tgt))
            else:
                loss, flat_g = pipeline.call_flat(program, lp, streams(idx, tgt))
                g = tree_unflatten(list(flat_g), tree_flatten(lp)[1])
            if n_stages > 1:
                # The embed and head weights' grads summed over the stages
                # (each holds only its own use); the block grads joined in
                # stage order.
                pp = runtime.group_of("pp", n_stages)
                g = {**g, **{k: tree_map(lambda x: dist._reduce(x, pp, n_stages, "sum"), g[k])
                             for k in ("wte", "ln_f", "lm_head_w")}}
                stacked = tree_map(lambda x: runtime.join(x.unsqueeze(0), P("pp"), {"pp": pp}), g["blocks"])
                return loss, merge_pp_grads({**g, "blocks": stacked}, n_stages, config.n_layer)
        return loss, {"wte": g["wte"], "blocks": g["blocks"], "ln_f": g["ln_f"], "lm_head_w": g["lm_head_w"]}

    step, stats = staging.stage(eager_step, list(traces), idx.device, name=f"pipelined step ({schedule})")
    step.staging, step.traces, step.eager, step.schedule = stats, traces, eager_step, one_f_one_b
    return step


def gpt_pp_loss_and_grads(config: GPTConfig, params: dict, idx, tgt, mesh, *, n_micro: int, schedule: str = "1f1b",
                          executors: Optional[Sequence[str]] = ("torch",)):
    """End-to-end pipelined (loss, grads) of a ``models/gpt.py`` GPT.

    idx/tgt: (B, T) int tensors with B divisible by n_micro, the same on
    every rank, as are the whole ``params``. Splits the batch into
    microbatches and the blocks over the mesh's ``pp`` axis, and runs the
    requested schedule. Returns (loss, grads with the flat ``blocks``
    list), the same on every rank: the embed and head weights' grads summed
    over the stages, the block grads gathered. The step built last
    (:func:`build_gpt_pp_step`) is kept in ``gpt_pp_loss_and_grads.last_step``
    and reused while the configuration, mesh and input shapes stay; another
    call replaces it, which frees its CUDA graph's pool."""
    leaves = tree_flatten(params)[0]
    key = (config, n_micro, schedule, tuple(executors) if executors else None, tuple(idx.shape), idx.dtype,
           idx.device, tuple((tuple(x.shape), x.dtype) for x in leaves))
    step = gpt_pp_loss_and_grads.last_step
    if step is None or step.mesh is not mesh or step.key != key:
        gpt_pp_loss_and_grads.last_step = step = None  # the old graph's pool goes before the new one is built
        step = build_gpt_pp_step(config, params, idx, tgt, mesh, n_micro=n_micro, schedule=schedule,
                                 executors=executors)
        step.mesh, step.key = mesh, key
        gpt_pp_loss_and_grads.last_step = step
    return step(params, idx, tgt)


gpt_pp_loss_and_grads.last_step = None


__all__ = ["split_params_for_pp", "merge_pp_grads", "build_gpt_pp_fns", "build_gpt_pp_step",
           "gpt_pp_loss_and_grads"]
