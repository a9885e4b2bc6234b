"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` with its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build happens
at first use, into ``thunder_tpu_torch/_build/<hash of sources and flags>/``
(listed in ``.gitignore``), from the package's own sources only. A later
process with the same sources loads the library without building.

There is no fallback: no ``nvcc``, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libthunder_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of csrc/common.cuh
DTYPE_CODES = {"bfloat16": 0, "float16": 1, "float32": 2}

_c_void_p, _c_int, _c_ll, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "thunder_flash_fwd": [_c_void_p] * 7 + [_c_int] * 6 + [_c_ll] * 9 + [_c_float] + [_c_int] * 4 + [_c_void_p],
    "thunder_flash_bwd": [_c_void_p] * 12 + [_c_int] * 6 + [_c_ll] * 15 + [_c_float] + [_c_int] * 4 + [_c_void_p],
    "thunder_rope": [_c_void_p] * 4 + [_c_int] * 4 + [_c_ll] * 3 + [_c_int] * 10 + [_c_void_p],
    "thunder_ce_fwd": [_c_void_p] * 3 + [_c_int] * 2 + [_c_ll, _c_int, _c_int, _c_ll, _c_int, _c_void_p],
    "thunder_ce_bwd": [_c_void_p] * 4 + [_c_int] * 2 + [_c_ll, _c_int, _c_int, _c_int, _c_void_p],
    "thunder_norm_fwd": [_c_void_p] * 4 + [_c_int] * 3 + [_c_float] + [_c_int] * 6 + [_c_void_p],
    "thunder_norm_fwd_blocks_per_sm": [_c_int] * 3,
    "thunder_norm_bwd": [_c_void_p] * 8 + [_c_int] * 8 + [_c_float] + [_c_int] * 2 + [_c_void_p],
    "thunder_int8_gemm": [_c_void_p] * 5 + [_c_int] * 9 + [_c_void_p],
    "thunder_int8_gemm_sync": [_c_void_p] * 5 + [_c_int] * 10 + [_c_void_p],
    "thunder_quantize_rows": [_c_void_p, _c_ll, _c_int, _c_int, _c_float] + [_c_int] * 3 + [_c_void_p] * 3,
    "thunder_quantize_tensor": [_c_void_p] + [_c_ll] * 3 + [_c_float] + [_c_int] * 3 + [_c_void_p] * 3
    + [_c_int, _c_int, _c_void_p],
    "thunder_rng_draw": [_c_void_p, _c_int, ctypes.c_uint, _c_void_p, _c_ll, _c_int, _c_int] + [_c_float] * 3
    + [_c_int, _c_void_p],
}


@dataclass
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output, with the -Xptxas -v register/spill lines and each source's seconds


_lib = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (shutil.which("nvcc"), CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_parallel(cmds: list[list[str]], label=None) -> str:
    """Run ``cmds`` at once; their output, and for each a line "nvcc <label>:
    <seconds> s" (the time to its exit) where ``label`` names it."""
    start = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    ends = {}
    while len(ends) < len(procs):
        for i, proc in enumerate(procs):
            if i not in ends and proc.poll() is not None:
                ends[i] = time.perf_counter() - start
        time.sleep(0.05)
    outs, failed = [], []
    for i, (cmd, proc) in enumerate(zip(cmds, procs)):
        out, _ = proc.communicate()
        outs.append(out)
        if label is not None:
            outs.append(f"nvcc {label(cmd)}: {ends[i]:.1f} s\n")
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return "".join(outs)


def build() -> BuildInfo:
    """Build the library if this set of sources has not been built yet."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            log_path = out_dir / "build.log"
            return BuildInfo(lib_path, 0.0, log_path.read_text() if log_path.exists() else "")
        nvcc = _nvcc()
        start = time.perf_counter()
        objs = [out_dir / (src.stem + ".o") for src in _sources()]
        log = _run_parallel([
            [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            for src, obj in zip(_sources(), objs)
        ], label=lambda cmd: Path(cmd[-3]).name)
        tmp = out_dir / (LIB_NAME + ".tmp")
        log += _run_parallel([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, lib_path)
        (out_dir / "build.log").write_text(log)
        return BuildInfo(lib_path, time.perf_counter() - start, log)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.thunder_cuda_error_string.argtypes = [ctypes.c_int]
        handle.thunder_cuda_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        msg = lib().thunder_cuda_error_string(status).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} (error {status})")


# Every kernel wrapper, by (module, name). A wrapper adds one to its
# ``launches`` attribute where it launches its kernel; a CUDA graph's replay
# adds what its capture launched (``executors/staging.py``). The counts are
# read through the module's attribute, so a wrapper swapped for a stand-in
# counts on the stand-in.
KERNEL_WRAPPERS: list[tuple[str, str]] = []


def counted(fn):
    """Register a kernel wrapper and start its launch count at 0."""
    fn.launches = 0
    KERNEL_WRAPPERS.append((fn.__module__, fn.__name__))
    return fn


def launch_counts() -> dict[tuple[str, str], int]:
    """Every registered wrapper's launch count."""
    return {key: getattr(sys.modules[key[0]], key[1]).launches for key in KERNEL_WRAPPERS}


def refuse_transformed(kernel: str, *ts) -> None:
    """Raise unless every tensor of ``ts`` is a plain tensor: a kernel reads
    its operands through ``data_ptr()``, so a functorch-wrapped tensor (the
    batched tensor of ``torch.func.vmap``, the wrapper of ``torch.func.jvp``
    or ``grad``) or one carrying a forward-mode tangent would lose its batch
    or its tangent. Under vmap a kernel is reached through its batching
    rule (``executors/batching.py``), which hands it plain tensors."""
    import torch
    from torch._C._functorch import is_functorch_wrapped_tensor
    from torch.autograd import forward_ad

    dual = forward_ad._current_level >= 0
    for t in ts:
        if isinstance(t, torch.Tensor) and (is_functorch_wrapped_tensor(t)
                                            or (dual and forward_ad.unpack_dual(t).tangent is not None)):
            raise NotImplementedError(
                f"{kernel}: the kernel was given a tensor under a function transform (a vmap batch or a "
                "forward-mode tangent), which a launch on its address would drop; under vmap a kernel runs "
                "through its batching rule (executors/batching.py), and jvp claims no kernel")


def add_launches(counts: dict[tuple[str, str], int]) -> None:
    for (mod, name), n in counts.items():
        getattr(sys.modules[mod], name).launches += n


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def ptr_align(*ts) -> int:
    """The largest of 16, 8, 4, 2 and 1 bytes that divides every base pointer
    (``None`` is skipped)."""
    return next(a for a in (16, 8, 4, 2, 1) if all(t is None or t.data_ptr() % a == 0 for t in ts))


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def dtype_code(t) -> int:
    return DTYPE_CODES[str(t.dtype).removeprefix("torch.")]
