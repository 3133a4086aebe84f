"""The check that nothing the run loaded is JAX or the JAX package."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "glio_tpu")


def loaded_forbidden(modules=None) -> list:
    """Top-level names of loaded modules that are forbidden, compared whole
    (the part before the first dot), so ``glio_tpu_torch`` is not one."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))
