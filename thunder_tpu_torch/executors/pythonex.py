"""The Python executor: host-side guards, unpacking, and utility prims.

Reference parity: thunder/executors/pythonex.py (`ex:28`) — the always-on
executor that runs prologue traces (metadata guards) and utility statements.
Everything here executes on the host in plain Python; no device work.
"""

from __future__ import annotations

from thunder_tpu_torch.core import prims
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.extend import OperatorExecutor, add_always_executor, register_executor

ex = OperatorExecutor("python")
register_executor(ex)
add_always_executor(ex)

_guard_ids = (
    PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA,
    PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE,
    PrimIDs.CHECK_STRING_VALUE,
    PrimIDs.CHECK_LEN,
    PrimIDs.CHECK_KEYS,
    PrimIDs.CHECK_NONE,
    PrimIDs.CHECK_DIM_BUCKET,
)

for pid in _guard_ids:
    ex.register_implementation(pid, fn=prims.get_prim(pid).python_impl)

ex.register_implementation(PrimIDs.PRINT, fn=print)
