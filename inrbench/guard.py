"""The import guard: no module of JAX or of the JAX package may be loaded in
a benchmark process.  Names are compared by their top-level package (the
part before the first dot), whole: ``repro_torch`` is not ``repro``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Names in ``modules`` (default ``sys.modules``) whose top-level
    package is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def check(where: str) -> None:
    """Raise ``ImportError`` naming what was found."""
    found = forbidden_modules()
    if found:
        raise ImportError(f"import guard ({where}): {', '.join(found[:20])}"
                          f" loaded in a benchmark process")
