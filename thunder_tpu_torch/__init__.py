"""thunder_tpu_torch: the PyTorch/CUDA port of thunder_tpu.

A JIT compiler for programs written against a torch-like language: it traces
a program into the IR, runs dce/cse, lets the executors claim it, prints it
as Python and runs it eagerly on one device (CUDA unless the caller passes
``device="cpu"``); ``grad`` and ``value_and_grad`` add the backward to the
traced program. The kernel executors (``flash``, ``fused``) launch
hand-written CUDA kernels for Hopper (``csrc/``); the ``torch`` executor
lowers every other prim to a PyTorch operator.

The module layout mirrors ``thunder_tpu`` so that each module's counterpart
is easy to find. This package imports neither JAX nor ``thunder_tpu``.
"""

from thunder_tpu_torch import models
from thunder_tpu_torch.api import cache_hits, cache_misses, grad, jit, last_traces, value_and_grad

__all__ = ["jit", "grad", "value_and_grad", "last_traces", "cache_hits", "cache_misses", "models"]
