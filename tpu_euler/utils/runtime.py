"""Runtime setup helpers (compilation cache, device check).

Every distinct XLA program costs a compile; the persistent cache lets a later
process load it instead. Safe to call on any backend.
"""

from __future__ import annotations

import logging
import os
import subprocess

import jax

log = logging.getLogger("tpu_euler")

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def setup_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache (idempotent).

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the cache: JAX reads it
    itself and nothing here overrides it. Otherwise the cache is the fixed
    ``<repo>/.jax_cache``, so that every process of this checkout finds the
    entries of the ones before it. Returns the directory in use.
    """
    path = os.environ.get(CACHE_ENV) or _DEFAULT_CACHE
    try:
        os.makedirs(path, exist_ok=True)
        if not os.environ.get(CACHE_ENV):
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except OSError as e:  # cache is an optimization; never fail the run
        log.warning("compilation cache disabled: %s", e)
    return path


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them.

    A card set below its maximum power runs slower under load, so every
    device number is reported beside this line.
    """
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=30,
            check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip()


def require_gpu() -> None:
    """Raise unless JAX's default backend is a GPU.

    The measuring entry points (bench.py, chip_smoke.py) call this so that a
    machine without a card fails instead of silently timing the CPU.
    """
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {backend!r} "
            f"(devices: {jax.devices()})"
        )
