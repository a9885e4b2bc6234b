"""The OpInfo VJP matrix through the port, against the JAX package.

Every OpInfo of ``tests/opinfos.py`` that supports grad, in f32, generated
as ``tests/test_grad.py`` generates it (``framework.ops``): the sum of the
op's outputs goes through ``thunder_tpu.grad`` with the case's executors and
through ``thunder_tpu_torch.grad(..., device="cpu")`` with the port's
counterpart (``tests/torch_port_opinfos.py``), and each gradient is held
against the JAX package's at ``test_grad.py``'s tolerance: the case's
``framework.tolerances``, at least 1e-4 relative and absolute.
"""

import numpy as np
import torch

from framework import ops, tolerances
from opinfos import opinfos
from torch_port_opinfos import port_grad, port_op

import thunder_tpu
import thunder_tpu.torch as jtorch
import thunder_tpu_torch.torch as ttorch
from thunder_tpu.core.pytree import tree_flatten


def _loss(op, ltorch):
    def loss_fn(*args, **kwargs):
        total = None
        for o in tree_flatten(op(*args, **kwargs))[0]:
            if hasattr(o, "dtype") and hasattr(o, "shape"):
                s = ltorch.sum(o)
                total = s if total is None else total + s
        return total

    return loss_fn


@ops([op for op in opinfos if op.supports_grad], supported_dtypes=(torch.float32,))
def test_port_grad(opinfo, executor, dtype):
    jgrad = executor.grad(_loss(opinfo.op, jtorch))
    tgrad = port_grad(_loss(port_op(opinfo.op), ttorch), executor)
    tol = tolerances(dtype, opinfo, executor)
    tol = dict(rtol=max(tol["rtol"], 1e-4), atol=max(tol["atol"], 1e-4))
    for i, sample in enumerate(opinfo.grad_samples(dtype)):
        want = jgrad(*sample.args, **sample.kwargs)
        got = tgrad(*sample.args, **sample.kwargs)
        want = want if isinstance(want, (tuple, list)) else (want,)
        got = got if isinstance(got, (tuple, list)) else (got,)
        assert len(got) == len(want), f"{opinfo.name}: grad arity {len(got)} != {len(want)}"
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g.detach(), dtype=np.float64), np.asarray(w, dtype=np.float64),
                                       err_msg=f"{opinfo.name} sample {i}", **tol)
