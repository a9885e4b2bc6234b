"""The training step of a GPT on one device: one joint fw+bw program, then AdamW or SGD.

The counterpart of ``thunder_tpu/parallel/train.py``'s single-device path
(``build_train_step`` with no mesh), which the LitGPT benchmark drives:
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
(``executors/staging.py``) runs the program and the optimizer. The sharded step (``mesh``, ``param_specs``, ``batch_spec``)
comes with the distribution slice of the port and raises here.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from thunder_tpu_torch.core.pytree import tree_flatten, tree_map, tree_unflatten

_NO_MESH = "the sharded training step (mesh, param_specs, batch_spec) is not ported yet: ROADMAP.md, slice 5"


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


def _compile_loss_and_grads(config, params, idx: torch.Tensor, targets: torch.Tensor, executors=None):
    """Trace ``loss_fn`` into one claimed joint program: ``(callable,
    extrace)``; the callable takes the params' leaves, idx and targets, and
    returns ``(loss, grads)`` with a grad for every param leaf."""
    from thunder_tpu_torch import api
    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.executors.passes import del_last_used, transform_for_execution
    from thunder_tpu_torch.extend import resolve_executors
    from thunder_tpu_torch.models.gpt import loss_fn
    from thunder_tpu_torch.transforms.attention_residuals import save_sdpa_residuals_joint
    from thunder_tpu_torch.transforms.autodiff import grad_transform
    from thunder_tpu_torch.transforms.common import dce

    ex_list = resolve_executors(executors)
    with devices.default_device(idx.device):
        _, comp = api.trace_program(lambda p, i, t: loss_fn(p, i, t, config), (params, idx, targets), {})
        joint = grad_transform(dce(comp), return_value=True)
        joint = save_sdpa_residuals_joint(joint, ex_list)
        extrace = del_last_used(transform_for_execution(joint, ex_list))
    return extrace.python_callable(), extrace


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
    lists executor names in priority order (default: flash, fused, torch)."""
    if mesh is not None or param_specs is not None or batch_spec is not None:
        raise NotImplementedError(_NO_MESH)
    if optimizer not in ("adamw", "sgd"):
        raise ValueError(f"optimizer must be 'adamw' or 'sgd', got {optimizer!r}")
    loss_and_grads, extrace = _compile_loss_and_grads(config, params, idx, targets, executors)

    @torch.no_grad()
    def eager_step(params, opt_state, idx, targets):
        flat_p, p_spec = tree_flatten(params)
        loss, grads = loss_and_grads(*flat_p, idx, targets)
        grads = [g.float() for g in grads] if grads_in_f32 else list(grads)
        if optimizer == "sgd":
            new_p = sgd_update(flat_p, grads, lr, weight_decay, in_place=donate)
            return (params if donate else tree_unflatten(new_p, p_spec)), opt_state, loss
        new_params, new_state = adamw_update(params, grads, opt_state, lr=lr, b1=b1, b2=b2,
                                             weight_decay=weight_decay, in_place=donate)
        return new_params, new_state, loss

    from thunder_tpu_torch.executors import staging

    step, stats = staging.stage(eager_step, [extrace], idx.device, name="train step")
    step.loss_and_grads, step.eager, step.staging = loss_and_grads, eager_step, stats
    opt_state = adamw_init(params) if optimizer == "adamw" else {"step": 0}
    return (step, opt_state, extrace) if return_extrace else (step, opt_state)
