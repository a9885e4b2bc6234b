"""One GPT training step on one device: forward, backward, bf16-true SGD.

The counterpart of ``bench.py:75-156`` (``build_train``): the reference's
train.py workload, ``torch.optim.SGD(lr=6e-4, weight_decay=0.1)`` with no
momentum state, in the params' own dtype. The program is built once:

- trace ``loss_fn`` (``api.trace_program``), then dce and cse;
- split it into forward and backward (``forward_and_backward_from_trace``);
- let the flash backward run from saved (out, lse)
  (``save_sdpa_residuals``), then recompute cheap chains instead of saving
  them (``rematerialize_forward_and_backward``);
- claim both traces (``transform_for_execution``); the backward takes its
  saved tensors as a list that it clears (``take_saved_as_list``), then
  ``del_last_used`` frees each intermediate after its last use.

A step runs ``loss, saved = fw(*params, idx, tgt)``, then
``grads = bw(saved, 1)``, then ``p -= lr·(g + wd·p)`` on each param **in
place** (the counterpart of the JAX step's donated params), freeing each
grad as it is used. Gradients are for every float param, in the order of
the params' pytree leaves.

``Train.step`` is that step staged whole, as ``bench.py:159`` stages it: on
the card, one CUDA graph (``executors/staging.py``) that reads and updates
the params in place by address; its first call runs eagerly, its second
captures, later calls replay. ``Train.step_eager`` runs the same step
unstaged, op by op.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

LR = 6e-4
WD = 0.1


@dataclass
class Train:
    """A built training step. ``seconds`` holds the first-call (build)
    seconds of each pass: trace, autodiff, residuals, remat, claim."""

    params: dict
    flat_params: list
    idx: torch.Tensor
    tgt: torch.Tensor
    fw_fn: Any
    bw_fn: Any
    fw_trace: Any  # the claimed forward, with dels
    bw_trace: Any  # the claimed backward, with dels
    seconds: dict = field(default_factory=dict)
    staged: Any = None  # run_step staged (executors/staging.stage), set by build_train
    staging: Any = None  # its StagingStats
    # The profiler range the SGD update runs in when the step was built
    # under THUNDER_ANNOTATE_TRACES: line 2 of run_step (after the forward's
    # and backward's programs, whose lines have their own ranges), so that
    # its kernels are charged to a line (observability/attribution.py).
    sgd_scope: Optional[str] = None

    def forward(self) -> tuple[torch.Tensor, list]:
        """(loss, saved): the augmented forward; ``saved`` is the list that
        ``backward`` consumes and clears."""
        loss, saved = self.fw_fn(*self.flat_params, self.idx, self.tgt)
        return loss, list(saved)

    def backward(self, loss: torch.Tensor, saved: list) -> list:
        """The grads of every float param, in ``flat_params`` order; empties
        ``saved`` as it goes, so nothing else may hold its tensors."""
        return list(self.bw_fn(saved, torch.ones((), dtype=loss.dtype, device=loss.device)))

    def forward_backward(self) -> tuple[torch.Tensor, list]:
        """(loss, grads) of one forward and backward, params unchanged."""
        loss, saved = self.forward()
        return loss, self.backward(loss, saved)

    @torch.no_grad()
    def sgd_(self, grads: list) -> None:
        """``p -= lr·(g + wd·p)`` in place, one rounding to the param's dtype
        per operation and the scalars in that dtype, as the JAX step's bf16
        arithmetic computes it (``parallel.train.sgd_update``); each grad is
        dropped from ``grads`` once used."""
        from thunder_tpu_torch.parallel.train import sgd_update

        sgd_update(self.flat_params, grads, LR, WD, in_place=True)

    def run_step(self, flat_params: list, idx: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """One step on these params (updated in place) and this batch: the
        program that ``step`` stages."""
        loss, saved = self.fw_fn(*flat_params, idx, tgt)
        saved = list(saved)  # the backward empties this list as it goes; nothing else may hold its tensors
        grads = list(self.bw_fn(saved, torch.ones((), dtype=loss.dtype, device=loss.device)))
        from thunder_tpu_torch.parallel.train import sgd_update

        with torch.no_grad(), (torch.profiler.record_function(self.sgd_scope) if self.sgd_scope
                               else contextlib.nullcontext()):
            sgd_update(flat_params, grads, LR, WD, in_place=True)
        return loss

    def step(self) -> torch.Tensor:
        """One training step, staged as a CUDA graph on the card; the loss."""
        return self.staged(self.flat_params, self.idx, self.tgt)

    def step_eager(self) -> torch.Tensor:
        """One training step, unstaged; the loss."""
        return self.run_step(self.flat_params, self.idx, self.tgt)


def build_train(cfg, batch: int, seq: int, *, device: Any = None, params: Optional[dict] = None,
                idx: Optional[np.ndarray] = None, seed: int = 0) -> Train:
    """Build the training step of GPT ``cfg`` at (batch, seq).

    ``device`` is CUDA unless the caller passes ``device="cpu"``. ``params``
    defaults to ``gpt.init_params(cfg, seed=seed)`` in bf16; ``idx``
    defaults to random token ids from ``seed``, and the targets are ``idx``
    shifted by one, as in ``bench.py``. The executors are the default
    ones: flash, fused, torch."""
    from thunder_tpu_torch import api
    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.core.trace import annotate_enabled
    from thunder_tpu_torch.executors import staging
    from thunder_tpu_torch.executors.passes import del_last_used, take_saved_as_list, transform_for_execution
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.transforms.attention_residuals import save_sdpa_residuals
    from thunder_tpu_torch.transforms.autodiff import forward_and_backward_from_trace
    from thunder_tpu_torch.transforms.common import cse, dce
    from thunder_tpu_torch.transforms.rematerialization import rematerialize_forward_and_backward

    dev = devices.resolve_device(device)
    if params is None:
        params = gpt.init_params(cfg, seed=seed, device=dev)
    if idx is None:
        idx = np.random.RandomState(seed).randint(0, cfg.vocab_size, (batch, seq))
    idx_t = torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(dev)
    tgt_t = torch.roll(idx_t, -1, dims=1)
    executors = api.DEFAULT_EXECUTORS
    seconds: dict[str, float] = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    with devices.default_device(dev):
        _, comp = timed("trace", api.trace_program, lambda p, i, t: gpt.loss_fn(p, i, t, cfg),
                        (params, idx_t, tgt_t), {})
        comp = cse(dce(comp))
        fw, bw = timed("autodiff", forward_and_backward_from_trace, comp)
        fw, bw = timed("residuals", save_sdpa_residuals, fw, bw, executors)
        fw, bw = timed("remat", rematerialize_forward_and_backward, fw, bw)

        def claim(fw, bw):
            n_saved = len(fw.tags["saved_for_backward"])
            fw_ex = del_last_used(transform_for_execution(fw, executors))
            bw_ex = del_last_used(take_saved_as_list(transform_for_execution(bw, executors), n_saved))
            return fw_ex, bw_ex, fw_ex.python_callable(), bw_ex.python_callable()

        fw_ex, bw_ex, fw_fn, bw_fn = timed("claim", claim, fw, bw)

    flat_params = [p for p in tree_flatten(params)[0] if isinstance(p, torch.Tensor)]
    tr = Train(params=params, flat_params=flat_params, idx=idx_t, tgt=tgt_t, fw_fn=fw_fn, bw_fn=bw_fn,
               fw_trace=fw_ex, bw_trace=bw_ex, seconds=seconds,
               sgd_scope="L2.sgd_update#run_step" if annotate_enabled() else None)
    tr.staged, tr.staging = staging.stage(tr.run_step, [fw_ex, bw_ex], dev, name="train step")
    return tr
