"""The name of the controller reconciling, carried by context
(operator/injection:36-127) so that any depth of a call can read it
without plumbing. Singleton and reconcile_concurrently set it around each
reconcile. The reference's options and settings values have their only
reader in the process entry (operator/__main__), which the port does not
have yet; the port's loop reads api.settings.current()."""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

_controller: contextvars.ContextVar = contextvars.ContextVar("karpenter_controller",
                                                            default="")


@contextlib.contextmanager
def with_controller_name(name: str) -> Iterator[None]:
    token = _controller.set(name)
    try:
        yield
    finally:
        _controller.reset(token)


def controller_name() -> str:
    return _controller.get()
