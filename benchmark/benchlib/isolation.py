"""The JAX side must stay out of every process the benchmark runs: the port
is measured alone.  Module names are compared by their whole top-level
name, since the port's own name begins with the JAX package's."""

FORBIDDEN = ("jax", "jaxlib", "flax", "mixgrpo_tpu")


def forbidden_modules(modules) -> list:
    """The names in ``modules`` (such as ``sys.modules``) whose top-level
    name is one of ``FORBIDDEN``."""
    return sorted(n for n in modules if n.split(".", 1)[0] in FORBIDDEN)
