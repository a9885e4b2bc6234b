"""What a cell is made of, found by name: its configuration, traffic mix,
limits, kernel groups and per-layer metric readers, and the weights and
tokens it makes from the seed.

Everything that belongs to one configuration, mix, cell, metric or kernel
group is a file of its own under the benchmark's folder, named after it:

- ``configs/<config>.json``: the file ``BENCHMARK.json`` names for it;
- ``traffic/<mix>.json``: the mix's parameters (``kind`` picks the runner);
- ``limits/<cell>.json``: each number the cell compares and its limit;
- ``kernels/<group>.json``: kernel-name patterns and the group's order;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``families/<model_type>.py`` and ``reference/<module>.py``: a family's
  layout, its program configuration and its plain reference.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Any, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path = HERE
    family: ModuleType = field(init=False)
    dims: SimpleNamespace = field(init=False)

    def __post_init__(self):
        self.family = importlib.import_module(f"h100bench.families.{self.config['model_type']}")
        self.dims = self.family.dims(self.config)

    def reference(self) -> ModuleType:
        return importlib.import_module(f"h100bench.reference.{self.family.REFERENCE}")

    def program_config(self):
        return self.family.program_config(self.config_name, self.config)


def load_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def load_cell(bench: dict, workload: str, root: Path = HERE) -> Cell:
    """The cell ``workload`` of the benchmark description ``bench`` (the
    parsed ``BENCHMARK.json``), with its files read from ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    in_cell = lambda m: workload in m.get("workloads", [workload])  # noqa: E731
    return Cell(
        name=workload,
        config_name=w["config"],
        config=load_json(root / Path(conf["file"]).relative_to(Path(conf["file"]).parts[0])),
        traffic_name=w["traffic"],
        traffic=load_json(root / "traffic" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        limits=load_json(root / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if in_cell(m)],
        per_layer=[m for m in bench["per_layer"] if in_cell(m)],
        root=root,
    )


def kernel_groups(root: Path = HERE) -> list:
    """``[(group, patterns)]`` in claiming order: a kernel belongs to the
    first group one of whose patterns its name contains."""
    groups = []
    for path in sorted((root / "kernels").glob("*.json")):
        g = load_json(path)
        groups.append((g["order"], path.stem, tuple(g["patterns"])))
    return [(name, pats) for _, name, pats in sorted(groups)]


def metric_reader(name: str, root: Path = HERE) -> ModuleType:
    """The reader module of per-layer metric ``name`` (``metrics/<name>.py``)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# =============================================================================
# Inputs from the seed
# =============================================================================


def _leaves(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def flatten(tree: Any) -> dict:
    """``{path: leaf}`` of a nested dict/list, in order."""
    return dict(_leaves(tree))


def rebuild(layout: Any, leaves: dict, prefix: str = "") -> Any:
    """A tree shaped like ``layout`` whose leaves are ``leaves[path]``."""
    if isinstance(layout, dict):
        return {k: rebuild(v, leaves, f"{prefix}{k}.") for k, v in layout.items()}
    if isinstance(layout, list):
        return [rebuild(v, leaves, f"{prefix}{i}.") for i, v in enumerate(layout)]
    return leaves[prefix[:-1]]


def torch_generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of the seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + salt) % (2**63 - 1))


def host_rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, salt])


ALIGN = 128  # elements: every leaf starts 256-byte aligned in the draw


def make_params(cell: Cell, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The cell's weights from the seed, on ``device`` in ``dtype``: one
    draw of normals for all of them, then each leaf scaled by its init and
    copied out as a tensor of its own."""
    layout = cell.family.layout(cell.config)
    specs = flatten(layout)
    spans, total = {}, 0
    for path, (shape, _) in specs.items():
        n = int(np.prod(shape))
        spans[path] = (total, n)
        total += -(-n // ALIGN) * ALIGN
    flat = torch.randn(total, generator=torch_generator(seed, 1, device), device=device, dtype=dtype)
    leaves = {}
    for path, (shape, (kind, std)) in specs.items():
        off, n = spans[path]
        leaf = flat[off: off + n].view(shape).clone()
        leaf.mul_(std)
        if kind == "one_plus":
            leaf.add_(1.0)
        leaves[path] = leaf
    del flat
    return rebuild(layout, leaves)


def make_pool(cell: Cell, seed: int, rows: int, length: int, device) -> torch.Tensor:
    """``rows`` rows of ``length`` token ids from the seed, on ``device``."""
    return torch.randint(0, cell.dims.vocab, (rows, length), generator=torch_generator(seed, 2, device),
                         device=device, dtype=torch.int64)


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def unit_norms(cell: Cell, leaves, scale: float = 1.0) -> dict:
    """``{unit: norm · scale}`` of each parameter that the ``(path, tensor)``
    pairs hold (``family.units``: a fused leaf is several). The pairs may
    be a generator: each tensor is dropped once its norms are taken."""
    names, norms = [], []
    for path, leaf in leaves:
        for name, x in cell.family.units(cell.config, path, leaf):
            names.append(name)
            norms.append(torch.linalg.vector_norm(x, dtype=torch.float32))
    return {name: n * scale for name, n in zip(names, torch.stack(norms).tolist())}


def gap_by_leaf(program: dict, reference: dict, keep: Optional[set] = None, zero: bool = False) -> tuple:
    """The worst leaf's gap of norms: max over leaves of |‖prog‖ − ‖ref‖|
    over the larger of the reference's norm of that leaf and its median
    leaf's; with ``zero``, ``program`` holds the norms of the differences
    themselves, ‖prog − ref‖, and those are measured the same way.
    Returns ``(gap, leaf)``."""
    paths = [p for p in reference if keep is None or p in keep]
    median = float(np.median([reference[p] for p in paths]))
    worst = (0.0, None)
    for p in paths:
        g = (program[p] if zero else abs(program[p] - reference[p])) / max(reference[p], median)
        if g > worst[0]:
            worst = (g, p)
    return worst
