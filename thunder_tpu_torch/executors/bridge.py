"""The host-data boundary: numpy arrays and torch tensors as trace inputs.

Reference analogue: the reference executes on torch tensors natively, and so
does this package. The only conversion left is for numpy inputs, which
become torch tensors on the jit's device before the program runs.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from thunder_tpu_torch.core import dtypes


def to_torch(x: Any, device: torch.device) -> Any:
    """Concrete tensor → torch tensor on ``device``. A numpy array is copied
    there; a torch tensor must already be there (no hidden transfer)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if isinstance(x, torch.Tensor):
        if x.device != device and not (x.device.type == device.type == "cpu"):
            raise ValueError(f"input tensor is on {x.device}, the program runs on {device}")
        return x
    return x


def tensor_metadata(x: Any) -> tuple:
    """(shape, device_str, framework dtype, requires_grad) of a concrete
    tensor. A numpy array reports the device it will be copied to."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.device.type, dtypes.from_torch_dtype(x.dtype), bool(x.requires_grad)
    if isinstance(x, np.ndarray):
        from thunder_tpu_torch.core import devices

        return tuple(x.shape), devices.Device().type, dtypes.from_numpy_dtype(x.dtype), False
    raise ValueError(f"Not a tensor: {type(x)}")


def framework_of(x: Any) -> str:
    """Which array framework a concrete tensor belongs to — guarded by the
    prologue so an entry compiled for numpy inputs (copied to the device at
    each call) is not reused for torch inputs."""
    return "torch" if isinstance(x, torch.Tensor) else "numpy"


def is_concrete_tensor(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))
