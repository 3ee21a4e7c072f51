"""What a run must not have loaded: JAX, its libraries, or the JAX package
the port was made from.  A module counts by its top-level name, the part
before the first dot, compared whole: `vk3dgaussiansplatting_tpu_torch`
(the port) passes, `vk3dgaussiansplatting_tpu.ops` does not."""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vk3dgaussiansplatting_tpu"})


def forbidden_modules(modules: dict) -> list[str]:
    """The loaded modules of `modules` (sys.modules; an entry set to None
    blocks an import and is no module) whose top level is forbidden,
    sorted."""
    return sorted(m for m, mod in modules.items()
                  if mod is not None and m.split(".", 1)[0] in FORBIDDEN)
