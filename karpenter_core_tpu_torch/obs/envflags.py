"""The port's single funnel for environment configuration.

Every environment read of the observability modules and of the process
entry routes through these accessors. One funnel means the truthy/falsy
grammar cannot drift between parsers, the knob surface is greppable in one
place, and tests that monkeypatch os.environ keep working (reads stay live,
nothing is cached).

The variables are the reference package's own (KARPENTER_TPU_TRACE,
KARPENTER_TPU_LOG, KARPENTER_TPU_FLIGHTREC, KARPENTER_TPU_FLIGHTREC_DIR,
KARPENTER_TPU_PROFILE), so one deployment arms both packages alike.
TRUTHY/FALSY are the shared spellings for the arming hooks. The empty
string is deliberately NOT in FALSY: each parser decides what "unset"
means (the tracer and the recorder leave their state to the entry point's
default; the log parser treats it as off).
"""
from __future__ import annotations

import os
from typing import Mapping

TRUTHY = ("1", "true", "on", "yes")
FALSY = ("0", "false", "off", "no")


def raw(name: str, default: str = "") -> str:
    """os.environ.get with a string default, for callers that parse."""
    return os.environ.get(name, default)


def environ() -> Mapping[str, str]:
    """The live process environment, for callers that take a mapping (a
    child process's environment, the redaction of its output): handed
    out, never copied, so monkeypatched entries are visible."""
    return os.environ


def require(name: str) -> str:
    """A mandatory variable; KeyError naming it when unset."""
    return os.environ[name]


def get_bool(name: str, default: bool = False) -> bool:
    """TRUTHY or FALSY spellings; unset or unrecognized gives `default`."""
    value = os.environ.get(name, "").strip().lower()
    if value in TRUTHY:
        return True
    if value in FALSY:
        return False
    return default
