"""Execution markers for the attention dispatch, as in the JAX package.

Each attention core calls :func:`record` with its name when it runs; a test
or ``chip_smoke.py`` wraps a call in :func:`capture` and asserts that the
expected marker appeared, so a path that silently runs another core fails.
PyTorch runs eagerly, so a marker is recorded on every call (the JAX
package records at trace time). Recording is off outside a capture scope.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Set

# One set per active capture scope: markers record into all of them, so
# nested captures neither wipe the outer scope's markers nor leak past
# their own scope.
_scopes: List[Set[str]] = []


def record(name: str) -> None:
    """Mark that the named core ran (no-op outside capture())."""
    for scope in _scopes:
        scope.add(name)


@contextlib.contextmanager
def capture() -> Iterator[Set[str]]:
    """Enable recording; yields this scope's live set of marker names."""
    scope: Set[str] = set()
    _scopes.append(scope)
    try:
        yield scope
    finally:
        _scopes.remove(scope)
