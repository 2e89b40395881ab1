"""The JAX package and JAX stay out of every process the benchmark runs.

Module names are compared by their top-level part, whole: the port's
``sdr_pmr446_tpu_torch`` begins with the JAX package's ``sdr_pmr446_tpu``
and is not it.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "sdr_pmr446_tpu")
#: what the plain reference may not load besides: the program under test
PROGRAM = "sdr_pmr446_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".")[0]


def found(modules=None, forbidden=FORBIDDEN) -> list:
    """The loaded modules (``sys.modules`` by default) whose top-level name
    is one of ``forbidden``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in forbidden)
