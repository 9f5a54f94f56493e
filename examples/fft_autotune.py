"""Autotuned distributed FFT — the analog of examples/*/basic_usage autotuned
variants plus the FFT benchmark skeleton (benchmark/benchmark.cu).

    python examples/fft_autotune.py [N]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

import cudecomp_tpu as cd
from cudecomp_tpu.ops.fft import DistributedFFT


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    cfg = cd.GridConfig(gdims=(n, n, n), pdims=(0, 0),
                        transpose_axis_contiguous=(True, True, True))
    grid = cd.make_grid(cfg, autotune_options=cd.AutotuneOptions(
        n_warmup=1, n_trials=2))
    print(f"autotuned pdims={grid.pdims} method="
          f"{grid.config.transpose_method.value}")

    # split-complex (matmul FFT): works with or without complex support
    plan = DistributedFFT(grid=grid, split_complex=True)
    x = jax.device_put(
        jax.random.normal(jax.random.PRNGKey(0), cfg.gdims + (2,),
                          dtype=jnp.float32), grid.sharding(0))

    @jax.jit
    def roundtrip(v):
        return plan.inverse(plan.forward(v))

    err = float(jnp.max(jnp.abs(roundtrip(x) - x)))
    print(f"round-trip max err: {err:.3e}")
    t0 = time.perf_counter()
    err = float(jnp.max(jnp.abs(roundtrip(x) - x)))
    dt = (time.perf_counter() - t0) / 2
    import math
    gflops = 5 * n**3 * math.log2(n**3) / dt / 1e9
    print(f"one direction: {dt*1e3:.2f} ms  ({gflops:.1f} GFLOPS)")

    # plan-level policy autotuning: gate-check + time each (precision,
    # gauss) matmul-FFT policy and pin the fastest passing one into the plan
    res = cd.autotune_fft(grid, n_warmup=1, n_trials=2, iters=4)
    print(res.report())


if __name__ == "__main__":
    main()
