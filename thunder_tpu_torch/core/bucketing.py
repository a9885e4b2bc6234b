"""Shape-bucketing policy for symbolic-values caching.

Under ``cache="symbolic values"`` a marked tensor dim is guarded by BUCKET
membership instead of its exact extent: the prologue checks ``lo < d <= hi``
and the dispatcher pads the dim up to ``hi``, so one trace + one staged
program serves every extent in the bucket (the standard answer to
recompile storms under variable batch/sequence traffic). In the port a
bucket entry is also one CUDA graph, captured at the bucket ceiling
(``api.py``, ``executors/staging.py``).

Default policy (the JAX package's, ``thunder_tpu/core/bucketing.py``):

- dim 0 ("batch"): powers of two — extent n lands in ``(p/2, p]`` for the
  next power of two p;
- dim 1 ("seq"):   multiples of 128;
- dims >= 2 ("other"): exact — a varying feature dim recompiles per extent
  (padding a reduced-over feature dim is unsound without full masking).

Knobs: the ``THUNDER_TPU_BUCKETS`` environment variable and the ``buckets=``
jit option, e.g. ``THUNDER_TPU_BUCKETS="batch=pow2,seq=64,other=exact"`` or
``jit(fn, cache="symbolic values", buckets={"seq": 64})``. A rule is either
``"pow2"``, ``"exact"``, or a positive integer m (buckets are multiples of m).
"""

from __future__ import annotations

import os
from typing import Any, Optional


_RULE_NAMES = ("batch", "seq", "other")


def _validate_rule(rule: Any) -> Any:
    if rule in ("pow2", "exact"):
        return rule
    try:
        m = int(rule)
    except (TypeError, ValueError):
        raise ValueError(
            f"Invalid bucket rule {rule!r}: expected 'pow2', 'exact', or a positive integer"
        )
    if m <= 0:
        raise ValueError(f"Invalid bucket multiple {m}: must be positive")
    return m


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class BucketPolicy:
    """Maps (dim index, observed extent) -> the half-open bucket ``(lo, hi]``."""

    def __init__(self, batch: Any = "pow2", seq: Any = 128, other: Any = "exact"):
        self.batch = _validate_rule(batch)
        self.seq = _validate_rule(seq)
        self.other = _validate_rule(other)

    @classmethod
    def resolve(cls, option: Optional[dict] = None) -> "BucketPolicy":
        """Defaults <- THUNDER_TPU_BUCKETS env <- per-jit ``buckets=`` dict."""
        rules: dict[str, Any] = {}
        env = os.environ.get("THUNDER_TPU_BUCKETS", "").strip()
        if env:
            for part in env.split(","):
                if not part.strip():
                    continue
                k, _, v = part.partition("=")
                k = k.strip()
                if k not in _RULE_NAMES:
                    raise ValueError(
                        f"THUNDER_TPU_BUCKETS: unknown rule name {k!r} (expected one of {_RULE_NAMES})"
                    )
                rules[k] = v.strip()
        if option:
            for k, v in option.items():
                if k not in _RULE_NAMES:
                    raise ValueError(
                        f"buckets: unknown rule name {k!r} (expected one of {_RULE_NAMES})"
                    )
                rules[k] = v
        return cls(**{k: rules[k] for k in rules})

    def rule_for(self, dim: int) -> Any:
        if dim == 0:
            return self.batch
        if dim == 1:
            return self.seq
        return self.other

    def bucket(self, dim: int, extent: int) -> tuple[int, int]:
        """The bucket ``(lo, hi]`` containing ``extent`` for dim ``dim``.
        An empty dim (extent 0) opens its bucket downward (``lo = -1``) so
        the ``lo < d`` guard admits it."""
        rule = self.rule_for(dim)
        extent = int(extent)
        if rule == "exact":
            lo, hi = extent - 1, extent
        elif rule == "pow2":
            hi = _next_pow2(max(extent, 1))
            lo = hi // 2 if hi > 1 else 0
        else:
            m = int(rule)
            hi = -(-extent // m) * m if extent > 0 else m
            lo = hi - m
        if extent == 0:
            lo = -1
        return lo, hi

    def __repr__(self) -> str:
        return f"BucketPolicy(batch={self.batch!r}, seq={self.seq!r}, other={self.other!r})"


class SymbolicSpec:
    """Everything a symbolic cache entry needs at dispatch time.

    - ``marks``: tensor-leaf index -> {dim: (lo, hi, class_id)} — which dims
      are symbolic and their buckets (``hi`` is the padded extent);
    - ``classes``: class_id -> (leaf_idx, dim, lo, hi) — one class per marked
      dim; the representative (leaf, dim) is where the runtime true extent is
      read from;
    - ``mask_classes``: ordered class ids whose TRUE extents are appended as
      extra 0-d int32 inputs to the staged computation (set by the pad-mask
      transform when a masked reduction consumes them);
    - ``crop_plan``: [(flat output leaf index, {dim: class_id}), ...] from
      dim provenance (re-analyzed after grad/autocast transforms); an empty
      plan means no output carries padding and nothing is cropped.
    """

    __slots__ = ("marks", "classes", "mask_classes", "crop_plan")

    def __init__(self, marks: dict):
        self.marks = marks
        self.classes: dict[int, tuple] = {}
        for li, dims in sorted(marks.items()):
            for d, (lo, hi, cid) in sorted(dims.items()):
                self.classes[cid] = (li, d, lo, hi)
        self.mask_classes: tuple = ()
        self.crop_plan = None

    def padded_extent(self, cid: int) -> int:
        return self.classes[cid][3]

    def true_extents(self, flat_tensor_leaves) -> dict[int, int]:
        """class_id -> the CURRENT call's extent, read off the raw inputs."""
        out = {}
        for cid, (li, d, _lo, _hi) in self.classes.items():
            out[cid] = int(flat_tensor_leaves[li].shape[d])
        return out

    def describe(self) -> str:
        parts = []
        for li, dims in sorted(self.marks.items()):
            for d, (lo, hi, _cid) in sorted(dims.items()):
                parts.append(f"leaf{li}.dim{d}∈({lo},{hi}]")
        return " ".join(parts) or "exact"


def make_symbolic_spec(marks_dims: dict, shapes: dict, policy: BucketPolicy) -> SymbolicSpec:
    """Build a spec from ``{leaf_idx: iterable-of-dims}`` marks and the
    current call's ``{leaf_idx: shape}``; buckets come from ``policy``."""
    marks: dict[int, dict[int, tuple]] = {}
    cid = 0
    for li in sorted(marks_dims):
        if li not in shapes:
            raise ValueError(
                f"symbolic_dims: no tensor input leaf {li} (the call has "
                f"{len(shapes)} tensor leaves)"
            )
        shape = shapes[li]
        dmap: dict[int, tuple] = {}
        for d in sorted(set(marks_dims[li])):
            if d < 0 or d >= len(shape):
                raise ValueError(
                    f"symbolic_dims: dim {d} out of range for input leaf {li} of rank {len(shape)}"
                )
            lo, hi = policy.bucket(d, shape[d])
            dmap[d] = (lo, hi, cid)
            cid += 1
        if dmap:
            marks[li] = dmap
    return SymbolicSpec(marks)
