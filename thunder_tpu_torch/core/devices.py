"""Devices for the trace IR.

Reference parity: thunder/core/devices.py (`Device:84`, `DeviceType:14`).
Device types are CPU and CUDA, and a ``Device`` resolves to a
``torch.device``. A ``Device()`` built with no argument is the device of the
trace being built (``jit(device=...)`` sets it), and CUDA outside any trace.
"""

from __future__ import annotations

import contextvars
import enum
from contextlib import contextmanager
from typing import Any, Optional


class DeviceType(enum.Enum):
    CPU = enum.auto()
    CUDA = enum.auto()


_devicetype_names = {DeviceType.CPU: "cpu", DeviceType.CUDA: "cuda"}
_name_to_devicetype = {v: k for k, v in _devicetype_names.items()}


def devicetype_string(dt: DeviceType) -> str:
    return _devicetype_names[dt]


class Device:
    def __init__(self, string_or_type: Any = None, index: Optional[int] = None):
        if string_or_type is None:
            string_or_type = _default_device.get()
        if isinstance(string_or_type, Device):
            self.devicetype = string_or_type.devicetype
            self.index = string_or_type.index if index is None else index
            return
        if isinstance(string_or_type, DeviceType):
            self.devicetype = string_or_type
            self.index = 0 if index is None else index
            return
        if isinstance(string_or_type, str):
            name, _, idx = string_or_type.partition(":")
            devicetype = _name_to_devicetype.get(name)
            if devicetype is None:
                raise ValueError(f"Unknown device string {string_or_type!r}")
            self.devicetype = devicetype
            self.index = int(idx) if idx else (0 if index is None else index)
            return
        raise ValueError(f"Cannot construct Device from {string_or_type!r}")

    @property
    def type(self) -> str:
        return devicetype_string(self.devicetype)

    def __repr__(self) -> str:
        return f'devices.Device("{self.type}:{self.index}")'

    def __str__(self) -> str:
        return f"{self.type}:{self.index}"

    def __hash__(self) -> int:
        return hash((self.devicetype, self.index))

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Device):
            return NotImplemented
        return self.devicetype == other.devicetype and self.index == other.index

    def torch_device(self):
        import torch

        return torch.device(self.type, self.index)


_default_device = contextvars.ContextVar("default_device", default="cuda")


@contextmanager
def default_device(device: Any):
    """Scope the device that ``Device()`` means (the jit's device)."""
    tok = _default_device.set(Device(to_device(device)))
    try:
        yield
    finally:
        _default_device.reset(tok)


def resolve_device(device: Any = None):
    """The ``torch.device`` an entry point runs on: ``device`` if given,
    else CUDA. Asking for CUDA without a card raises."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type not in _name_to_devicetype:
        raise ValueError(f"Unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(x: Any) -> Optional[Device]:
    if x is None:
        return None
    if isinstance(x, Device):
        return x
    if isinstance(x, (str, DeviceType)):
        return Device(x)
    typ = getattr(x, "type", None)
    if typ is not None:  # torch.device
        return Device(typ, getattr(x, "index", None) or 0)
    raise ValueError(f"Cannot convert {x!r} to a Device")


cpu = Device("cpu")
