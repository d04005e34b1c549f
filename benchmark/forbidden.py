"""The modules no run may hold once its window has closed: JAX, and the JAX
package the program was ported from."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "isingmontecarlo_tpu"})


def loaded() -> list[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole (the
    program's name begins with the JAX package's)."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & FORBIDDEN)
