"""Language contexts: pluggable method-resolution for proxies.

Reference parity: thunder/core/langctxs.py (`LanguageContext:17`,
`resolve_method:66`, `langctx` decorator). A language context decides what
``proxy.foo(...)`` and operator dunders mean while tracing — e.g. the torch
language resolves ``t.view`` to the torch-mirror symbol while the core
language exposes only the clang surface.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import Any, Callable, Optional


class Languages:
    CLANG = "clang"
    TORCH = "torch"
    NUMPY = "numpy"


class LanguageContext:
    def __init__(self, name: str):
        self.name = name
        self._methods: dict[str, Callable] = {}

    def register_method(self, name: str, fn: Callable) -> None:
        self._methods[name] = fn

    def get_method(self, name: str) -> Callable:
        fn = self._methods.get(name)
        if fn is None:
            raise AttributeError(f"The {self.name} language has no method {name!r}")
        return fn

    def has_method(self, name: str) -> bool:
        return name in self._methods


_langctx_registry: dict[str, LanguageContext] = {}


def register_langctx(name: str, ctx: LanguageContext) -> LanguageContext:
    _langctx_registry[name] = ctx
    return ctx


def resolve_language(name: str) -> LanguageContext:
    return _langctx_registry[name]


_langctx_var = contextvars.ContextVar("langctx", default=None)


def get_langctx() -> LanguageContext:
    ctx = _langctx_var.get()
    if ctx is None:
        # The torch language is the default method-resolution table: the
        # framework's public surface mirrors torch (reference defaults to its
        # torch langctx the same way).
        try:
            return resolve_language(Languages.TORCH)
        except KeyError:
            return resolve_language(Languages.CLANG)
    return ctx


@contextmanager
def langctx_ctx(ctx: LanguageContext | str):
    if isinstance(ctx, str):
        ctx = resolve_language(ctx)
    tok = _langctx_var.set(ctx)
    try:
        yield ctx
    finally:
        _langctx_var.reset(tok)


def langctx(ctx: LanguageContext | str):
    """Decorator: run ``fn`` under the given language context."""

    def decorator(fn: Callable) -> Callable:
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with langctx_ctx(ctx):
                return fn(*args, **kwargs)

        return wrapper

    return decorator


def resolve_method(name: str, *args, **kwargs) -> Optional[Callable]:
    """Find the current language's implementation of method ``name``.

    Reference parity: thunder/core/langctxs.py `resolve_method:66`.
    """
    ctx = get_langctx()
    if ctx.has_method(name):
        return ctx.get_method(name)
    # Fall back to clang for core ops absent from the active language.
    clang_ctx = _langctx_registry.get(Languages.CLANG)
    if clang_ctx is not None and clang_ctx.has_method(name):
        return clang_ctx.get_method(name)
    return None
