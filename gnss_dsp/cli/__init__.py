"""Argv-compatible CLI front doors.

The reference ships 65 clone scripts; here two dispatchers (acquire,
track) plus the standalone utilities (cn0, spectrum, squaring) regenerate
every script's behavior from the signal registry.  scripts/ holds thin
drop-in wrappers with the reference's exact file names.
"""

import os as _os

# <checkout>/.cache/jax: a fixed path, so every process of this checkout
# shares one cache (the path is part of the cache key)
_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = _os.path.join(_CHECKOUT, ".cache", "jax")


def enable_compilation_cache() -> str:
    """Persistent jit-compilation cache; returns its directory.

    Every CLI invocation is a fresh process, so without this each run
    pays the full XLA compile (tens of seconds for the acquisition
    grid).  Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself
    and nothing is set here; otherwise the cache lives at
    <checkout>/.cache/jax.
    """
    import jax

    path = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    _os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
