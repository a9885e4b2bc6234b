"""The verifier's rule registry (a copy of ``thunder_tpu/analysis/registry.py``): every invariant is a named,
suppressible rule.

Rules register under a stable dotted id (``ssa.use-before-def``,
``mem.predicted-oom``); :func:`thunder_tpu_torch.analysis.verify` runs every
enabled rule over one shared :class:`~thunder_tpu_torch.analysis.context.VerifyContext`
(the trace is walked once; rules consume the precomputed def/use indexes).

Extending: third-party passes register their own invariants with
``@register_rule("mypass.my-invariant")`` — the function receives the
VerifyContext and reports via ``ctx.report(...)``. Suppressing: pass
``disable={"rule.id", ...}`` to ``verify``/``verify_or_raise``, or disable a
rule globally for a process with :func:`set_rule_enabled`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional


@dataclass
class Rule:
    id: str
    description: str
    fn: Callable
    enabled: bool = True


_RULES: dict[str, Rule] = {}


def register_rule(id: str, description: str = "") -> Callable:
    """Decorator: register ``fn(ctx: VerifyContext) -> None`` under ``id``.

    Re-registering an id replaces the rule (lets tests shadow a built-in).
    """

    def deco(fn: Callable) -> Callable:
        _RULES[id] = Rule(id=id, description=description or (fn.__doc__ or "").strip(), fn=fn)
        return fn

    return deco


def all_rules() -> dict[str, Rule]:
    _ensure_builtin_rules()
    return dict(_RULES)


def get_rule(id: str) -> Optional[Rule]:
    _ensure_builtin_rules()
    return _RULES.get(id)


def set_rule_enabled(id: str, enabled: bool) -> None:
    _ensure_builtin_rules()
    rule = _RULES.get(id)
    if rule is None:
        raise KeyError(f"No such verifier rule: {id!r} (known: {sorted(_RULES)})")
    rule.enabled = enabled


def enabled_rules(disable: Iterable[str] = ()) -> list[Rule]:
    _ensure_builtin_rules()
    off = set(disable)
    return [r for r in _RULES.values() if r.enabled and r.id not in off]


_builtins_loaded = False


def _ensure_builtin_rules() -> None:
    """Import the built-in rule modules exactly once (registration happens at
    module import). Deferred so registry import carries no dependency weight."""
    global _builtins_loaded
    if _builtins_loaded:
        return
    _builtins_loaded = True
    from thunder_tpu_torch.analysis import collectives, hlo_audit, liveness, rules, schedule  # noqa: F401
