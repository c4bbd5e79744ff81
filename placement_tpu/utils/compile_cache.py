"""The persistent XLA compilation cache that every entry point uses.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache directory and no
other is set. Otherwise the cache lives at one fixed path inside the
checkout (``.jax_cache/``, git-ignored): the path is part of what a later
process looks up, so a directory that moved would never be hit again.
"""

from __future__ import annotations

import os
import pathlib

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the cache uses in this process."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()`` and cache
    every compiled program, however quick its compile. Returns the path."""
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
