"""Where the program runs: the accelerator predicate that picks the
device-side defaults, the GPU check that measurement entry points
make, and the persistent compile cache."""

from __future__ import annotations

import os
import pathlib

_CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def on_accelerator() -> bool:
    """True when JAX's default backend is a GPU.  Defaults that only
    pay off on the card (device entropy decode, the while-loop unroll)
    read this, never a backend name."""
    import jax
    return jax.default_backend() == "gpu"


def require_gpu():
    """Return ``jax.devices()`` when they are GPUs, else raise.

    Entry points that measure or prove the card (chip_smoke.py,
    bench.py) call this first, so no number is ever taken on the CPU
    by mistake."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default devices are {devs[0].platform!r} "
            f"({devs[0].device_kind})")
    return devs


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``.
    The path is part of the cache key, so it never depends on a
    temporary name, a pid or the time."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(_CHECKOUT / ".jax_cache"))


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir()."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
