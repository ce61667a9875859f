"""Persistent XLA compile cache placement for the repo's entry scripts."""

from __future__ import annotations

import os
from pathlib import Path

import jax


def enable_compile_cache(root) -> str:
    """Keep JAX's persistent compile cache where ``JAX_COMPILATION_CACHE_DIR``
    says (JAX reads the variable itself; no other directory is set), else at
    the fixed ``<root>/.jax_cache``, so one checkout's runs share compiled
    programs. Returns the directory in use."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(Path(root).resolve() / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
