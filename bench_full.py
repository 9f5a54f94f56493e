"""Extended benchmark — the BASELINE.md headline metrics.

Prints one JSON object per line:
  * c2c and r2c FFT GFLOPS (same convention as bench.py / benchmark.cu:658);
  * transpose round-trip ms (512^3 f32, axis-contiguous) with the a2a/local
    segmentation and effective all-to-all GB/s per device (at_results
    analog, autotune.cc:546-626 + performance.cc:391,450);
  * halo update, fused diffusion step and CG Poisson solve times;
  * on one accelerator, the large-grid FFT and transpose cells.

All timings are forced-completion (a scalar fetch ends every timed
program), with ITERS repetitions inside one jit.
"""

import json
import math

import numpy as np
import jax
import jax.numpy as jnp


def _time_scanned_local(fn, x, iters, n_trials):
    """min over trials of the shared forced-completion scanned protocol."""
    from cudecomp_tpu import performance as perf
    return min(perf.time_scanned(fn, x, iters=iters, n_warmup=2,
                                 n_trials=n_trials))


def default_pdims(n_dev: int):
    """Squarest factor pair (pr, pc) of the device count."""
    from cudecomp_tpu.geometry import squarest_pdims
    return squarest_pdims(n_dev)


def _devices_label(n_dev):
    return f"{n_dev} device{'s' if n_dev > 1 else ''}"


def fft_r2c(N=256, ITERS=10, n_trials=3):
    import cudecomp_tpu as cd
    from cudecomp_tpu.config import GridConfig
    from cudecomp_tpu.ops.fft import DistributedFFT

    devices = jax.devices()
    n_dev = len(devices)
    cfg = GridConfig(gdims=(N, N, N), pdims=default_pdims(n_dev))
    grid = cd.make_grid(cfg, devices=devices)
    plan = DistributedFFT(grid=grid, real=True)

    x = jax.jit(lambda k: jax.random.normal(k, grid.global_shape(0),
                                            jnp.float32),
                out_shardings=grid.sharding(0))(jax.random.PRNGKey(1))

    def cycle(v):
        return plan.inverse(plan.forward(v))

    # correctness gate: one round trip (reference 5e-4 single)
    err = float(jax.jit(lambda v: jnp.max(jnp.abs(cycle(v) - v)))(x))
    assert err < 5e-4, f"r2c round-trip max err {err}"

    t = _time_scanned_local(cycle, x, ITERS, n_trials) / 2.0
    n_total = N ** 3
    # reference convention: the SAME 5 N^3 log2(N^3) formula as c2c, with
    # N^3 the real grid size (benchmark.cu:658 uses fftsize = gx*gy*gz for
    # both c2c and r2c)
    gflops = 5.0 * n_total * math.log2(n_total) / t / 1e9
    return {"metric": f"{N}^3 r2c FFT single-direction (jnp.fft, "
                      f"gate-checked err {err:.1e}, {_devices_label(n_dev)})",
            "value": round(gflops, 2), "unit": "GFLOPS", "err": err}


def transpose_headline(N=512, n_trials=3, iters=96):
    import cudecomp_tpu as cd
    from cudecomp_tpu.config import GridConfig
    from cudecomp_tpu import performance as perf

    devices = jax.devices()
    n_dev = len(devices)
    cfg = GridConfig(gdims=(N, N, N), pdims=default_pdims(n_dev),
                     transpose_axis_contiguous=(True, True, True))
    grid = cd.make_grid(cfg, devices=devices)
    seg = perf.segment_roundtrip(grid, np.float32, iters=iters,
                                 n_warmup=2, n_trials=n_trials, record=False)
    nbytes_moved = 4 * N ** 3 * 4 / n_dev  # 4 ops, f32, per device
    return {"metric": f"{N}^3 f32 transpose round-trip (X2Y;Y2Z;Z2Y;Y2X, "
                      f"{_devices_label(n_dev)}, axis-contiguous)",
            "value": round(seg["total_ms"], 3), "unit": "ms",
            "a2a_ms": round(seg["a2a_ms"], 3),
            "local_ms": round(seg["local_ms"], 3),
            "a2a_gbps_per_chip": (round(seg["a2a_gbps"], 2)
                                  if seg["a2a_ms"] > 0 else None),
            "local_gbps_per_chip": (round(
                2 * nbytes_moved / (seg["local_ms"] / 1e3) / 1e9, 2)
                if seg["local_ms"] > 0 else None)}


def fft_headline_large(gdims, ITERS=8, n_trials=3):
    """c2c FFT GFLOPS at headline scale on one device, with the input
    generated inside the jit from a PRNG key (a GiB-class benchmark
    ARGUMENT would double the resident footprint).  The round trip is
    gate-checked at the reference's 5e-4 single-precision tolerance
    (benchmark.cu:23-27) before it is timed.  GFLOPS convention:
    5 * prod(gdims) * log2(prod(gdims)) / t (benchmark.cu:658)."""
    import time as _time
    import cudecomp_tpu as cd
    from cudecomp_tpu.config import GridConfig
    from cudecomp_tpu.ops.fft import DistributedFFT
    from jax import lax

    grid = cd.make_grid(GridConfig(gdims=tuple(gdims), pdims=(1, 1)),
                        devices=jax.devices()[:1])
    plan = DistributedFFT(grid=grid)
    shape = grid.global_shape(0)

    def cycle(x, _):
        return plan.inverse(plan.forward(x)), ()

    def make_run(iters):
        @jax.jit
        def run(key):
            x = jax.random.normal(key, shape, jnp.complex64)
            out, _ = lax.scan(cycle, x, None, length=iters)
            return jnp.max(jnp.abs(out - x))
        return run

    key = jax.random.PRNGKey(1)
    err = float(make_run(1)(key))
    assert err < 5e-4, f"c2c round-trip max err {err}"
    run = make_run(ITERS)
    for _ in range(2):
        float(run(key))
    ts = []
    for _ in range(n_trials):
        t0 = _time.perf_counter()
        float(run(key))
        ts.append((_time.perf_counter() - t0) / ITERS / 2.0)
    t = min(ts)
    n_total = int(np.prod(gdims))
    gflops = 5.0 * n_total * math.log2(n_total) / t / 1e9
    baseline_per_gpu = 16826.0 / 8.0
    return {"metric": f"{'x'.join(map(str, gdims))} c2c FFT "
                      f"single-direction (jnp.fft, gate-checked err "
                      f"{err:.1e}, 1 device)",
            "value": round(gflops, 2), "unit": "GFLOPS",
            "vs_baseline": round(gflops / baseline_per_gpu, 4)}


def transpose_headline_large(N, n_trials=3, iters=32):
    """Chained round trip at large N on one device with in-jit field
    generation (the benchmark argument would double the footprint).  The
    chained cycle ends in a full reduction of its output, and the scan
    carry feeds each round trip into the next."""
    import time as _time
    import cudecomp_tpu as cd
    from cudecomp_tpu.config import GridConfig

    grid = cd.make_grid(
        GridConfig(gdims=(N, N, N), pdims=(1, 1),
                   transpose_axis_contiguous=(True, True, True)),
        devices=jax.devices()[:1])

    def roundtrip(a):
        b = cd.transpose_x_to_y(grid, a)
        b = cd.transpose_y_to_z(grid, b)
        b = cd.transpose_z_to_y(grid, b)
        return cd.transpose_y_to_x(grid, b)

    @jax.jit
    def run(key):
        x = jax.random.normal(key, (N, N, N), jnp.float32)
        out = jax.lax.scan(lambda c, _: (roundtrip(c), ()), x, None,
                           length=iters)[0]
        return jnp.sum(out)

    key = jax.random.PRNGKey(0)
    float(run(key))  # compile + first run
    float(run(key))
    ts = []
    for _ in range(n_trials):
        t0 = _time.perf_counter()
        float(run(key))
        ts.append((_time.perf_counter() - t0) / iters)
    t = min(ts)
    nbytes = 2 * 4 * N ** 3 * 4  # 4 ops, 1R+1W each, f32
    return {"metric": f"{N}^3 f32 transpose round-trip (X2Y;Y2Z;Z2Y;Y2X, "
                      f"1 device, axis-contiguous, in-jit gen)",
            "value": round(t * 1e3, 3), "unit": "ms",
            "a2a_ms": 0.0, "local_ms": round(t * 1e3, 3),
            "a2a_gbps_per_chip": None,
            "local_gbps_per_chip": round(nbytes / t / 1e9, 2)}


def stencil_headline(N=512, ITERS=192, n_trials=3, dt=0.1):
    """Fused ghost-plane diffusion step (ops/stencil.py) — the halo
    engine's consumer path."""
    import cudecomp_tpu as cd
    from cudecomp_tpu.config import GridConfig

    devices = jax.devices()
    n_dev = len(devices)
    cfg = GridConfig(gdims=(N, N, N), pdims=default_pdims(n_dev))
    grid = cd.make_grid(cfg, devices=devices)
    x = jax.jit(lambda k: jax.random.normal(k, grid.global_shape(0),
                                            jnp.float32),
                out_shardings=grid.sharding(0))(jax.random.PRNGKey(2))

    def step(v):
        return cd.diffusion_step(grid, v, dt, 0, (True, True, True))

    t = _time_scanned_local(step, x, ITERS, n_trials)
    return {"metric": f"{N}^3 f32 fused diffusion step (ghost-plane "
                      f"stencil pipeline, {_devices_label(n_dev)})",
            "value": round(t * 1e3, 3), "unit": "ms"}


def cg_headline(N=256, tol=1e-5, maxiter=2000):
    """Matrix-free CG Poisson solve on the ghost-plane stencil matvec
    (host-driven chunked loop)."""
    import time
    import cudecomp_tpu as cd
    from cudecomp_tpu.config import GridConfig
    from cudecomp_tpu.models import PoissonSolver

    devices = jax.devices()
    n_dev = len(devices)
    grid = cd.make_grid(GridConfig(gdims=(N, N, N),
                                   pdims=default_pdims(n_dev)),
                        devices=devices)
    solver = PoissonSolver(grid=grid)
    f = jax.jit(lambda k: jax.random.normal(k, grid.global_shape(0),
                                            jnp.float32),
                out_shardings=grid.sharding(0))(jax.random.PRNGKey(3))
    solver.solve_cg(f, tol=tol, maxiter=maxiter)  # compile chunk
    t0 = time.perf_counter()
    u, iters, rel = solver.solve_cg(f, tol=tol, maxiter=maxiter)
    wall = time.perf_counter() - t0
    return {"metric": f"{N}^3 f32 Poisson CG solve (ghost-plane stencil "
                      f"matvec, tol {tol:g}, {_devices_label(n_dev)})",
            "value": round(wall * 1e3, 1), "unit": "ms",
            "iters": int(iters), "rel_residual": float(rel),
            "ms_per_iter": round(wall / max(int(iters), 1) * 1e3, 3)}


def halo_headline(N=512, width=1, ITERS=96, n_trials=3):
    """Halo-update cost on the x-pencil with ±``width`` halos in all
    distributed dims, periodic — the autotuneHaloBackend trial payload
    (autotune.cc:771-1124; BASELINE.md row '64^3 halo autotune')."""
    import cudecomp_tpu as cd
    from cudecomp_tpu.config import GridConfig

    devices = jax.devices()
    n_dev = len(devices)
    cfg = GridConfig(gdims=(N, N, N), pdims=default_pdims(n_dev))
    grid = cd.make_grid(cfg, devices=devices)
    he = (width, width, width)
    periodic = (True, True, True)

    def step(v):
        return cd.update_halos(grid, v, 0, he, periodic)

    x = jax.device_put(
        np.zeros(grid.global_shape(0, halo_extents=he), np.float32),
        grid.sharding(0))
    t = _time_scanned_local(step, x, ITERS, n_trials)
    return {"metric": f"{N}^3 f32 halo update (x-pencil, width {width}, "
                      f"periodic, {_devices_label(n_dev)})",
            "value": round(t * 1e3, 3), "unit": "ms"}


def main():
    import bench
    bench.main(N=256)
    bench.main(N=512)
    for fn in (lambda: fft_r2c(N=512, ITERS=32), transpose_headline,
               halo_headline, stencil_headline, cg_headline):
        print(json.dumps(fn()))
    # large single-device cells (the per-card share of the reference's
    # 2048^3-over-8 headline is 1024^3)
    if len(jax.devices()) == 1 and jax.devices()[0].platform != "cpu":
        print(json.dumps(fft_headline_large((1024, 1024, 1024))))
        for N in (768, 1024):
            print(json.dumps(transpose_headline_large(N)))


if __name__ == "__main__":
    from cudecomp_tpu.utils.env import use_compile_cache
    use_compile_cache()
    main()
