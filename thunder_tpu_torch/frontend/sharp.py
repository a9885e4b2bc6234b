"""Sharp-edge interception for tracing-unsafe Python.

Reference parity: thunder/core/jit_ext.py `_minimal_lookaside:344` routes
``random.*`` (and friends) through the interpreter's sharp-edges machinery,
and `_general_jit_sharp_edge:468` reports them per the policy
(thunder/core/options.py:146). This frontend has no bytecode VM, so the
same surface is covered by *scoped patching*: while a trace is being
acquired, the known nondeterminism entry points — the ``random`` module,
``time`` clocks, and ``os.environ`` reads — report through
``common.sharp_edge()`` (allow → silent, warn → ThunderSharpEdgeWarning,
error → ThunderSharpEdgeError) and then execute normally, so under the
default policy behavior is unchanged but the observed value is known to be
baked into the cached trace.
"""

from __future__ import annotations

import contextlib
from typing import Any

from thunder_tpu_torch.common import sharp_edge

_RANDOM_FNS = (
    "random", "randint", "uniform", "randrange", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "betavariate",
    "expovariate", "lognormvariate", "vonmisesvariate", "paretovariate",
    "weibullvariate", "triangular", "getrandbits", "randbytes",
)
_TIME_FNS = ("time", "time_ns", "perf_counter", "perf_counter_ns", "monotonic", "monotonic_ns")


def _reporting(mod_name: str, fn_name: str, fn):
    def wrapper(*args, **kwargs):
        sharp_edge(
            f"call to {mod_name}.{fn_name}() while tracing — the returned value is "
            f"baked into the compiled program and will NOT be re-evaluated on later calls"
        )
        return fn(*args, **kwargs)

    wrapper.__name__ = fn_name
    return wrapper


class _ReportingEnviron:
    """os.environ stand-in: reads report as sharp edges, everything else
    forwards (reference: env reads inside a traced forward are baked
    configuration, jit_ext.py sharp-edge surface)."""

    def __init__(self, real):
        object.__setattr__(self, "_real", real)

    def _report(self, key):
        sharp_edge(
            f"read of os.environ[{key!r}] while tracing — the value is baked into "
            f"the compiled program"
        )

    def __getitem__(self, key):
        self._report(key)
        return self._real[key]

    def get(self, key, default=None):
        self._report(key)
        return self._real.get(key, default)

    def __contains__(self, key):
        self._report(key)
        return key in self._real

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_real"), name)

    def __setitem__(self, key, value):
        self._real[key] = value

    def __delitem__(self, key):
        del self._real[key]

    def __iter__(self):
        return iter(self._real)

    def __len__(self):
        return len(self._real)


@contextlib.contextmanager
def sharp_edge_interceptors():
    """Scoped patches over the nondeterminism surface, active while the
    user's function executes under the tracer."""
    import os
    import random
    import time

    saved: list[tuple[Any, str, Any]] = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    try:
        for fn_name in _RANDOM_FNS:
            fn = getattr(random, fn_name, None)
            if fn is not None:
                patch(random, fn_name, _reporting("random", fn_name, fn))
        for fn_name in _TIME_FNS:
            fn = getattr(time, fn_name, None)
            if fn is not None:
                patch(time, fn_name, _reporting("time", fn_name, fn))
        patch(os, "environ", _ReportingEnviron(os.environ))
        grad_tok = None
        try:
            import torch

            # Grad-mode contexts: torch's autograd flag means nothing to
            # the tracer, so no_grad/enable_grad/set_grad_enabled ALSO
            # toggle the trace-level flag — Symbol.__call__ stop_gradients
            # op outputs while disabled (eager parity: values computed
            # under no_grad are detached). The REAL torch context is still
            # entered alongside, so concrete (non-proxy) tensor work under
            # the block keeps eager autograd behavior.
            from thunder_tpu_torch.core.trace import _grad_mode_ctx

            real_no_grad = torch.no_grad
            real_enable_grad = torch.enable_grad
            real_grad_state = torch.is_grad_enabled()
            grad_tok = _grad_mode_ctx.set(_grad_mode_ctx.get())  # restore point

            class _GradMode:
                def __init__(self, mode: bool):
                    self._mode = mode
                    self._real = (real_enable_grad if mode else real_no_grad)()

                def __enter__(self):
                    self._tok = _grad_mode_ctx.set(self._mode)
                    self._real.__enter__()
                    return self

                def __exit__(self, *exc):
                    self._real.__exit__(*exc)
                    _grad_mode_ctx.reset(self._tok)
                    return False

                def _wrap(self, fn):
                    import functools

                    mode = self._mode

                    @functools.wraps(fn)
                    def wrapped(*a, **kw):
                        with _GradMode(mode):
                            return fn(*a, **kw)

                    return wrapped

                def __call__(self, fn):  # decorator form with parentheses
                    return self._wrap(fn)

            def _factory(mode):
                # torch.no_grad works as @torch.no_grad (bare), @torch.no_grad()
                # and `with torch.no_grad():` — accept all three shapes.
                def make(fn=None):
                    if callable(fn):
                        return _GradMode(mode)._wrap(fn)
                    return _GradMode(mode)

                return make

            class _SetGradEnabled:
                """torch.set_grad_enabled: takes effect IMMEDIATELY at call
                (statement form) and restores on __exit__ (with form)."""

                def __init__(self, mode):
                    self._tok = _grad_mode_ctx.set(bool(mode))
                    torch._C._set_grad_enabled(bool(mode))

                def __enter__(self):
                    return self

                def __exit__(self, *exc):
                    _grad_mode_ctx.reset(self._tok)
                    torch._C._set_grad_enabled(_grad_mode_ctx.get())
                    return False

            patch(torch, "no_grad", _factory(False))
            patch(torch, "enable_grad", _factory(True))
            patch(torch, "set_grad_enabled", _SetGradEnabled)
            patch(torch, "inference_mode",
                  lambda mode=True: (_GradMode(not mode)._wrap(mode) if callable(mode)
                                     else _GradMode(not bool(mode))))
            patch(torch, "is_grad_enabled", lambda: _grad_mode_ctx.get())
            if hasattr(torch, "is_inference_mode_enabled"):
                patch(torch, "is_inference_mode_enabled",
                      lambda: not _grad_mode_ctx.get())
        except ImportError:
            pass
        yield
    finally:
        for obj, name, orig in reversed(saved):
            setattr(obj, name, orig)
        if grad_tok is not None:
            _grad_mode_ctx.reset(grad_tok)
            import torch as _t

            _t._C._set_grad_enabled(real_grad_state)
