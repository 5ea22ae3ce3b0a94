"""Which route the layers took to each kernel: its wrapper, or the plain
PyTorch route where the kernel's shape predicate (``supported`` in its
``ops/cuda/*_kernel.py``) refuses the shapes.

The layers decide from shapes and dtype before any launch, beside the JAX
package's configuration conditions (which stay as they are: a configuration
JAX runs without its kernel runs here without one too, and is not counted).
``counts[(kernel, "kernel" | "plain")]`` counts each decision since the last
``counts.clear()``; a plain route leaves the kernel's count in ``utils/tracing.launches`` alone.
"""

from __future__ import annotations

import collections

counts: collections.Counter = collections.Counter()


def take(kernel: str, ok: bool) -> bool:
    """Record the route to ``kernel`` (the kernel where ``ok``, else the plain route); returns ``ok``."""
    counts[(kernel, "kernel" if ok else "plain")] += 1
    return ok


def plain_routes() -> dict:
    """{kernel: count} of the decisions that took the plain route."""
    return {k: n for (k, route), n in counts.items() if route == "plain"}
