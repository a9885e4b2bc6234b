"""Min-cut solver for rematerialization: native C++ Dinic, or the same in Python.

Reference parity: thunder/core/rematerialization.py:245 (igraph max-flow).
The counterpart of ``thunder_tpu/transforms/mincut.py``. The native solver
(``csrc/mincut.cpp``) is built at first use with ``g++`` into
``thunder_tpu_torch/_build/mincut-<hash>/`` (listed in ``.gitignore``); where
there is no ``g++`` the pure-Python Dinic below solves the same cut. Both are
host code: the cut is decided once, while the training step is compiled.
Both implement the same interface:

    min_cut(n_nodes, edges=[(u, v, cap)], s, t) -> (flow, source_side_set)

Capacities ≥ INF_CAP are treated as uncuttable.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from collections import deque
from pathlib import Path
from typing import Sequence

INF_CAP = 1 << 60

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "mincut.cpp"

_lib = None
_lib_tried = False


def _load_native():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if shutil.which("g++") is None:
        return None
    out_dir = _PKG / "_build" / f"mincut-{hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]}"
    so_path = out_dir / "libttmincut.so"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so_path.exists():
            tmp = out_dir / "libttmincut.so.tmp"
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    lib.tt_mincut.restype = ctypes.c_int64
    lib.tt_mincut.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib = lib
    return _lib


def _min_cut_py(n: int, edges: Sequence[tuple], s: int, t: int):
    """Pure-Python Dinic: the same algorithm as csrc/mincut.cpp."""
    graph: list[list[list]] = [[] for _ in range(n)]  # [to, cap, rev_idx]

    def add(u, v, cap):
        graph[u].append([v, cap, len(graph[v])])
        graph[v].append([u, 0, len(graph[u]) - 1])

    for u, v, c in edges:
        add(u, v, c)

    flow = 0
    while True:
        level = [-1] * n
        level[s] = 0
        q = deque([s])
        while q:
            u = q.popleft()
            for e in graph[u]:
                if e[1] > 0 and level[e[0]] < 0:
                    level[e[0]] = level[u] + 1
                    q.append(e[0])
        if level[t] < 0:
            break
        it = [0] * n

        def dfs(u, f):
            if u == t:
                return f
            while it[u] < len(graph[u]):
                e = graph[u][it[u]]
                v = e[0]
                if e[1] > 0 and level[u] < level[v]:
                    d = dfs(v, min(f, e[1]))
                    if d > 0:
                        e[1] -= d
                        graph[v][e[2]][1] += d
                        return d
                it[u] += 1
            return 0

        while True:
            f = dfs(s, INF_CAP)
            if f == 0:
                break
            flow += f

    side = set()
    q = deque([s])
    side.add(s)
    while q:
        u = q.popleft()
        for e in graph[u]:
            if e[1] > 0 and e[0] not in side:
                side.add(e[0])
                q.append(e[0])
    return flow, side


def min_cut(n: int, edges: Sequence[tuple], s: int, t: int):
    """(max_flow, source_side_node_set). Uses the C++ solver when g++ built it."""
    lib = _load_native()
    if lib is None:
        return _min_cut_py(n, edges, s, t)
    m = len(edges)
    eu = (ctypes.c_int32 * m)(*[e[0] for e in edges])
    ev = (ctypes.c_int32 * m)(*[e[1] for e in edges])
    ec = (ctypes.c_int64 * m)(*[min(int(e[2]), INF_CAP) for e in edges])
    side = (ctypes.c_uint8 * n)()
    flow = lib.tt_mincut(n, m, eu, ev, ec, s, t, side)
    return int(flow), {i for i in range(n) if side[i]}


def using_native() -> bool:
    return _load_native() is not None
