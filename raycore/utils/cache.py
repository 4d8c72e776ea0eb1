"""Where compiled programs and capacity hints persist between processes.

``JAX_COMPILATION_CACHE_DIR``, when set, is the place (JAX reads it
itself). Otherwise the cache lives at one fixed path inside the checkout,
``.jax_cache/`` at its root (listed in .gitignore): the path is part of
the cache key, so a directory that moved would never hit.
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
