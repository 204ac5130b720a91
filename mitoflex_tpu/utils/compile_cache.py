"""Persistent XLA compilation cache, on every backend.

The pipeline is many mid-size programs compiled per shape bucket, so a cold
process spends much of a small run compiling. The persistent cache makes a
repeat run start at steady state.

Placement: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
itself; nothing else is set in code), otherwise :data:`DEFAULT_DIR`, one
fixed path inside the checkout (listed in ``.gitignore``). The path is part
of the cache key, so a fixed path is what lets a later run hit.
``MITOFLEX_COMPILE_CACHE=0`` disables the cache.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_enabled = False


def cache_dir() -> str:
    """The directory the cache uses (or would use) in this process."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> bool:
    """Idempotently turn the persistent compile cache on. Returns True when
    active."""
    global _enabled
    if _enabled:
        return True
    if os.environ.get("MITOFLEX_COMPILE_CACHE", "1") in ("0", "false", "off"):
        return False
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    # the pipeline is many mid-size programs (~0.3 s compiles), not one
    # big one — the 1 s default would cache almost nothing
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.08)
    _enabled = True
    return True
