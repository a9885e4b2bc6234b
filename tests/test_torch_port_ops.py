"""The OpInfo forward matrix through the port, against the JAX package.

Every OpInfo of ``tests/opinfos.py`` × executor × dtype, generated as
``tests/test_ops.py`` generates it (``framework.ops``): each sample runs
through ``thunder_tpu.jit`` with the case's executors and through
``thunder_tpu_torch.jit(..., device="cpu")`` with the port's counterpart
(``tests/torch_port_opinfos.py``), and the two results are held together at
``framework.tolerances`` for the case.
"""

import torch

from framework import assert_close, ops, tolerances
from opinfos import opinfos
from torch_port_opinfos import port_jit

from thunder_tpu.core.pytree import tree_flatten


def _flat(x):
    if isinstance(x, tuple) and type(x) is not tuple:
        x = tuple(x)  # torch.return_types.* structseq → plain tuple
    flat, _ = tree_flatten(x)
    return [v for v in flat if isinstance(v, torch.Tensor) or hasattr(v, "shape") or isinstance(v, (int, float, bool))]


@ops(opinfos)
def test_port_forward(opinfo, executor, dtype):
    jfn = executor.jit(opinfo.op)
    tfn = port_jit(opinfo.op, executor)
    for i, sample in enumerate(opinfo.samples(dtype)):
        want = jfn(*sample.args, **sample.kwargs)
        got = tfn(*sample.args, **sample.kwargs)
        assert_close(_flat(got), _flat(want), err=f"{opinfo.name} sample {i} ({sample})",
                     **tolerances(dtype, opinfo, executor))
