"""Benchmark — distributed 3D c2c FFT through the full cudecomp_tpu pipeline.

Methodology mirrors the reference FFT benchmark (benchmark/benchmark.cu:
501-665): forward+inverse round trips, time halved for one direction,
GFLOPS = 5 * N^3 * log2(N^3) / t.  ITERS round trips run inside one jit via
lax.scan, so per-dispatch overhead is amortized.

The local FFTs are ``jnp.fft`` (``split_complex=False``): XLA hands them to
cuFFT on GPUs, the reference's own engine.  A CPU mesh runs the same
program through the matmul FFT core (see ``ops.fft._use_matmul_complex``).

vs_baseline = per-device GFLOPS vs the reference's best single-precision
number: 2048^3 C2C at 16826 GFLOPS on 8x A100 = ~2103 GFLOPS/GPU
(BASELINE.md).  Cross-hardware and cross-size — indicative only.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
"""

import json
import math
import time

import jax
import jax.numpy as jnp
from jax import lax


def main(N: int = 512, ITERS: int = 20, n_trials: int = 3):
    import cudecomp_tpu as cd
    from cudecomp_tpu.config import GridConfig
    from cudecomp_tpu.ops.fft import DistributedFFT

    from bench_full import default_pdims
    devices = jax.devices()
    n_dev = len(devices)
    pdims = default_pdims(n_dev)

    cfg = GridConfig(gdims=(N, N, N), pdims=pdims)
    grid = cd.make_grid(cfg, devices=devices)
    plan = DistributedFFT(grid=grid)

    def cycle(x, _):
        return plan.inverse(plan.forward(x)), ()

    def make_run(iters):
        @jax.jit
        def run(x):
            out, _ = lax.scan(cycle, x, None, length=iters)
            return jnp.max(jnp.abs(out - x))
        return run

    x = jax.jit(lambda k: jax.random.normal(k, grid.global_shape(0),
                                            jnp.complex64),
                out_shardings=grid.sharding(0))(jax.random.PRNGKey(0))

    # correctness gate after ONE round trip: the reference's single-
    # precision tolerance (benchmark.cu:23-27)
    err = float(make_run(1)(x))
    assert err < 5e-4, f"FFT round-trip max err {err}"

    run = make_run(ITERS)
    for _ in range(2):
        float(run(x))
    times = []
    for _ in range(n_trials):
        t0 = time.perf_counter()
        float(run(x))  # scalar fetch = completion barrier
        times.append((time.perf_counter() - t0) / ITERS / 2.0)  # one dir

    t = min(times)
    n_total = N ** 3
    gflops = 5.0 * n_total * math.log2(n_total) / t / 1e9
    baseline_per_gpu = 16826.0 / 8.0
    dev = devices[0]
    payload = {
        "metric": f"{N}^3 c2c FFT single-direction (jnp.fft, gate-checked "
                  f"err {err:.1e}, {n_dev} device{'s' if n_dev > 1 else ''},"
                  f" pdims {pdims})",
        "value": round(gflops, 2),
        "unit": "GFLOPS",
        "vs_baseline": round(gflops / n_dev / baseline_per_gpu, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": n_dev},
    }
    print(json.dumps(payload))
    return payload


if __name__ == "__main__":
    import sys
    from cudecomp_tpu.utils.env import use_compile_cache
    use_compile_cache()
    kw = {}
    if len(sys.argv) > 1:
        kw["N"] = int(sys.argv[1])
    if len(sys.argv) > 2:
        kw["ITERS"] = int(sys.argv[2])
    main(**kw)
