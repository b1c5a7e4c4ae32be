"""No-op span/instant hooks.

The copied host modules call ``trace.span`` and ``trace.instant`` at the
same points the JAX package's flight recorder does.  The recorder itself is
not ported yet, so both do nothing here.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def span(name: str, cat: str = "", **args):
    yield


def instant(name: str, cat: str = "", **args) -> None:
    return None
