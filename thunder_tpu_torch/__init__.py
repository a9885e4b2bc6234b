"""thunder_tpu_torch: the PyTorch/CUDA port of thunder_tpu.

A JIT compiler for programs written against a torch-like language: it traces
a program into the IR, runs dce/cse, lets the executors claim it, prints it
as Python and runs it on one device (CUDA unless the caller passes
``device="cpu"``), captured as a CUDA graph on the card; ``grad`` and
``value_and_grad`` add the backward to the traced program; ``vmap`` and
``jvp`` apply ``torch.func``'s transforms to it. The kernel
executors (``flash``, ``fused``) launch hand-written CUDA kernels for Hopper
(``csrc/``); the ``torch`` executor lowers every other prim to a PyTorch
operator.

The module layout mirrors ``thunder_tpu`` so that each module's counterpart
is easy to find. This package imports neither JAX nor ``thunder_tpu``.
"""

from thunder_tpu_torch import models
from thunder_tpu_torch.core import devices, dtypes
from thunder_tpu_torch.api import (
    cache_hits,
    cache_info,
    cache_misses,
    compile_data,
    compile_stats,
    grad,
    jit,
    jvp,
    last_backward_traces,
    last_compile_options,
    last_prologue_traces,
    last_staging,
    last_traces,
    seed,
    set_execution_callback_file,
    value_and_grad,
    vmap,
)
from thunder_tpu_torch.common import (
    CACHE_OPTIONS,
    SHARP_EDGES_OPTIONS,
    ThunderSharpEdgeError,
    ThunderSharpEdgeWarning,
)
from thunder_tpu_torch import monitor  # the metrics facade (thunder_tpu/__init__.py:42)
from thunder_tpu_torch.observability.profile import profile

# The legacy entry point (thunder_tpu/__init__.py:45-49): kept out of
# __all__ so that ``from thunder_tpu_torch import *`` cannot shadow the
# builtin.
compile = jit

__all__ = ["jit", "grad", "value_and_grad", "vmap", "jvp", "seed", "last_traces", "last_prologue_traces",
           "last_backward_traces", "last_staging", "last_compile_options", "cache_hits", "cache_misses", "cache_info",
           "compile_data", "compile_stats", "set_execution_callback_file", "models", "CACHE_OPTIONS",
           "SHARP_EDGES_OPTIONS", "ThunderSharpEdgeError", "ThunderSharpEdgeWarning", "dtypes", "devices",
           "monitor", "profile"]
