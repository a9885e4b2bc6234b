"""Program-acquisition frontends.

Reference parity: thunder/core/jit_ext.py + interpreter.py acquire PyTorch
programs by interpreting CPython bytecode against proxies. Like the JAX
package (``thunder_tpu/frontend/``), this package acquires them by dispatch
interception instead: a ``TorchFunctionMode`` routes every ``torch.*`` call
to the ltorch mirror while module parameters are swapped for proxies — no
bytecode VM, same trace out the other end.
"""

from thunder_tpu_torch.frontend.module import ThunderModule, thunder_module  # noqa: F401
