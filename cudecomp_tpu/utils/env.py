"""Environment-variable configuration — the analog of the reference's env
layer (``docs/env_vars.rst``, ``getCudecompEnvVars`` src/cudecomp.cc:597-713,
autotune filters src/autotune.cc:108-165).

Supported variables:
  CUDECOMP_TPU_ENABLE_PERFORMANCE_REPORT=1    enable op sample capture
  CUDECOMP_TPU_PERF_N_WARMUP / _MAX_SAMPLES   perf-report tuning
  CUDECOMP_TPU_DISABLE_TRACING=1              no named_scope/profiler ranges
  CUDECOMP_TPU_DISABLE_NATIVE=1               never load the C++ core
  CUDECOMP_TPU_AUTOTUNE_TRANSPOSE_METHODS     comma list; "^name" excludes
  CUDECOMP_TPU_AUTOTUNE_HALO_METHODS          same for halo strategies
  CUDECOMP_TPU_AUTOTUNE_P_ROW_RANGE="lo,hi"   clamp process-grid rows
  CUDECOMP_TPU_AUTOTUNE_P_COL_RANGE="lo,hi"   clamp process-grid cols
  CUDECOMP_TPU_FFT_DIRECT_THRESHOLD           dense-DFT cutoff (mxu_fft)
  CUDECOMP_TPU_FFT_FACTORS="1024=128x8,..."   per-size factor overrides

JAX's own ``JAX_COMPILATION_CACHE_DIR`` is honoured by the entry scripts
(see :func:`use_compile_cache`); the library never sets a cache itself.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence, Tuple


def log_info(msg: str):
    print(f"CUDECOMP_TPU: {msg}", file=sys.stderr)


def log_warn(msg: str):
    print(f"CUDECOMP_TPU:WARN: {msg}", file=sys.stderr)


def log_error(msg: str):
    print(f"CUDECOMP_TPU:ERROR: {msg}", file=sys.stderr)


def filter_candidates(env_name: str, all_values: Sequence, value_of=lambda v: v.value):
    """Apply a comma-separated include/exclude list (reference "^" exclusion
    syntax, src/autotune.cc:108-144) to candidate enums."""
    spec = os.environ.get(env_name, "").strip()
    if not spec:
        return list(all_values)
    items = [s.strip() for s in spec.split(",") if s.strip()]
    excludes = {s[1:].lower() for s in items if s.startswith("^")}
    includes = [s.lower() for s in items if not s.startswith("^")]
    vals = list(all_values)
    if includes:
        vals = [v for v in vals if value_of(v).lower() in includes]
    if excludes:
        vals = [v for v in vals if value_of(v).lower() not in excludes]
    if not vals:
        log_warn(f"{env_name} filtered out every candidate; ignoring it")
        return list(all_values)
    return vals


def int_range(env_name: str) -> Optional[Tuple[int, int]]:
    spec = os.environ.get(env_name, "").strip()
    if not spec:
        return None
    try:
        lo, hi = (int(x) for x in spec.split(","))
        return (lo, hi)
    except ValueError:
        log_warn(f"could not parse {env_name}={spec!r}; expected 'lo,hi'")
        return None


def use_compile_cache(root: Optional[str] = None) -> str:
    """Point JAX's persistent compilation cache at a fixed directory, for
    entry scripts (``chip_smoke.py``, ``bench.py``, ``bench_full.py``).

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is changed.  Otherwise the cache goes to ``<root>/.jax_cache``,
    ``root`` defaulting to the checkout that holds this package — a fixed
    path, since the path is part of the cache key.  Returns the directory
    in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    path = os.path.join(root, ".jax_cache")
    import jax
    jax.config.update("jax_compilation_cache_dir", path)
    return path
