"""Global configuration: x64 handling, matmul precision and the XLA
compilation cache.

The reference implementation is all-fp64 NumPy/SciPy. On the GPU the fast
path is fp32 (dense matvecs streaming device memory); fp64 runs at a
fraction of the fp32 rate and doubles every byte streamed. The dtype
policy is threaded per-solver through the ``accum_dtype`` argument of the
jitted step functions (fp64 when x64 is enabled, else the compute dtype
with two-float compensated reductions — see ops/math.py). Tests run on CPU
with x64 enabled and everything fp64, which reproduces the reference
numerics exactly.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# The persistent compile cache when JAX_COMPILATION_CACHE_DIR is unset: a
# fixed directory inside the checkout (listed in .gitignore). The path is
# part of the cache key, so it must not move between runs.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_x64(enable: bool = True) -> None:
    """Enable 64-bit types in JAX (idempotent).

    Must be called before the first jitted computation for best results;
    JAX supports toggling later but recompiles everything.
    """
    jax.config.update("jax_enable_x64", enable)


def x64_enabled() -> bool:
    return bool(jax.config.read("jax_enable_x64"))


def pin_fp32_matmul_precision() -> None:
    """Make fp32 matrix products actually fp32.

    At the DEFAULT matmul precision XLA:GPU may run fp32 matrix products
    on the tensor cores in TF32, which keeps a 10-bit mantissa: about
    1e-3 relative error instead of fp32's 1e-7. A solver chasing 1e-8
    suboptimality gaps cannot survive that in its fp32 algebra, so the
    package pins the global default to HIGHEST (true fp32 products;
    chip_smoke.py checks a (21 x 10) @ (10 x n) product against fp64 on
    the card). Deliberately low-precision paths keep working: bf16 x bf16
    inputs with fp32 accumulation are unaffected by this setting.
    """
    jax.config.update("jax_default_matmul_precision", "highest")


def compilation_cache_dir() -> str:
    """Where the persistent compile cache lives: JAX_COMPILATION_CACHE_DIR
    when set, else DEFAULT_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        DEFAULT_CACHE_DIR)


def enable_compilation_cache(min_compile_secs: float = 2.0) -> None:
    """Persistent XLA compilation cache, shared by every process of one
    checkout. When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself
    and nothing is set here; otherwise the cache goes to the fixed
    DEFAULT_CACHE_DIR inside the checkout."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
