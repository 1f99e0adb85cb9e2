"""Where JAX keeps its persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR`, when set, is the only directory used: JAX reads
it itself and nothing here overrides it.  Otherwise the cache goes to one
fixed path inside the checkout (`<checkout>/.jax_cache`, listed in
`.gitignore`) — the path is part of the cache key, so a directory that moves
between runs never hits.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["CHECKOUT_CACHE_DIR", "compilation_cache_dir",
           "enable_compilation_cache"]

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compilation_cache_dir(fallback: Optional[str] = None) -> str:
    """The cache directory in force: `JAX_COMPILATION_CACHE_DIR` if set,
    else ``fallback``, else `CHECKOUT_CACHE_DIR`."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or fallback or CHECKOUT_CACHE_DIR)


def enable_compilation_cache(fallback: Optional[str] = None) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    With `JAX_COMPILATION_CACHE_DIR` set this sets no directory (JAX already
    uses the variable); otherwise it points JAX at ``fallback`` or the
    checkout's `.jax_cache`."""
    import jax

    path = compilation_cache_dir(fallback)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
