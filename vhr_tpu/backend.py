"""The one place that knows which platform the program runs on.

Everything else in the package is plain JAX and runs wherever JAX does; no
code path is chosen by platform.  This module answers the questions whose
answer depends on the device:

* :func:`device_info` — the platform, device kind and device count that
  every measurement names beside its numbers; :func:`require_gpu` refuses
  a measurement run without a GPU instead of falling back to the CPU.
* :func:`enable_compile_cache` — where JAX keeps its persistent compile
  cache.  Entry points call it; importing the package does not.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import jax

__all__ = ["device_info", "require_gpu", "enable_compile_cache",
           "CACHE_ENV", "default_cache_dir"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def device_info() -> Dict[str, object]:
    """``{"platform", "kind", "count"}`` of the default backend's devices,
    as JAX reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(count: int = 1) -> Dict[str, object]:
    """:func:`device_info`, or ``RuntimeError`` unless JAX's default
    backend is a GPU with at least ``count`` devices."""
    info = device_info()
    if info["platform"] != "gpu" or info["count"] < count:
        raise RuntimeError(f"need {count} GPU device(s); JAX found {info} "
                           f"(no fallback to the CPU)")
    return info


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``: a fixed path (the path is part of the
    cache key, so a cache that moves never hits)."""
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(checkout, ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Turn on JAX's persistent compile cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    other directory is set here.  Otherwise the cache goes to
    :func:`default_cache_dir`.  Returns the directory in use.
    """
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
