"""Configuration carried by context (operator/injection:36-127): the
process options, the settings and the name of the controller reconciling,
readable at any depth of a call without plumbing.

Singleton and reconcile_concurrently set the controller name around each
reconcile, and the log filter of the process entry reads it. The entry
sets the options and the settings once at start-up (inject_defaults): a
thread does not inherit another thread's context values, so those
defaults live in module globals, and a value set in a context still wins
within its scope.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

_options: contextvars.ContextVar = contextvars.ContextVar("karpenter_options",
                                                         default=None)
_settings: contextvars.ContextVar = contextvars.ContextVar("karpenter_settings",
                                                          default=None)
_controller: contextvars.ContextVar = contextvars.ContextVar("karpenter_controller",
                                                            default="")
# the process-level values inject_defaults sets, seen from every thread
_default_options = None
_default_settings = None


@contextlib.contextmanager
def with_options(options) -> Iterator[None]:
    token = _options.set(options)
    try:
        yield
    finally:
        _options.reset(token)


def get_options():
    o = _options.get()
    return o if o is not None else _default_options


@contextlib.contextmanager
def with_settings(settings) -> Iterator[None]:
    token = _settings.set(settings)
    try:
        yield
    finally:
        _settings.reset(token)


def get_settings():
    """The context's settings, else the injected process defaults, else
    the process-wide current settings (settings.go:53-68)."""
    s = _settings.get()
    if s is not None:
        return s
    if _default_settings is not None:
        return _default_settings
    from karpenter_core_tpu_torch.api.settings import current

    return current()


@contextlib.contextmanager
def with_controller_name(name: str) -> Iterator[None]:
    token = _controller.set(name)
    try:
        yield
    finally:
        _controller.reset(token)


def controller_name() -> str:
    return _controller.get()


def inject_defaults(options=None, settings=None) -> None:
    """Set the process-level options and settings once at start-up
    (injection.go:116-127), visible from every thread."""
    global _default_options, _default_settings
    if options is not None:
        _default_options = options
    if settings is not None:
        _default_settings = settings
