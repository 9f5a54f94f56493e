"""3D heat-equation stencil on a pencil decomposition — the halo engine
inside a REAL consumer pipeline.

An isolated ``update_halos`` call pays full-buffer materializations a
real stencil pipeline never sees: when the halo write feeds a fused
consumer, XLA schedules the slab exchange inside the step program.  This
example runs
explicit 7-point Laplacian diffusion on a periodic box,

    u_{t+1} = u_t + dt * lap(u_t),

two ways — the halo'd-buffer pipeline (``update_halos`` + shifted-slice
stencil, the reference's architecture) and the library's fused
ghost-plane pipeline (``cd.diffusion_step``; see
``cudecomp_tpu/ops/stencil.py``) — verifies both against a numpy
reference, and (on a single accelerator) times them side by side.

Reference analog: cuDecomp validates its halo machinery with halo_tests
(``tests/ctest/halo_tests.cc``) and documents halo exchange for stencil
apps (``docs/basic_usage.rst``); it ships no stencil example app, so this
exceeds the reference's L7 inventory.

    python examples/heat3d_stencil.py [N] [steps]
"""

import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

import cudecomp_tpu as cd
from cudecomp_tpu import geometry
from cudecomp_tpu.config import GridConfig
from cudecomp_tpu.parallel.collectives import shard_map_fn

HE = (1, 1, 1)                      # width-1 halos, all dims
PERIODS = (True, True, True)


def make_step(grid, dt, with_halo=True, donate=False):
    """One diffusion step on the halo'd X-pencil buffer."""
    cfg = grid.config
    assert cfg.mem_order(0) == (0, 1, 2), "example assumes natural layout"

    def local_step(ul):
        # per-shard buffer layout along each dim: [low halo | interior (max
        # split) | high halo]; width-1, no padding -> interior == [1:-1]
        core = ul[1:-1, 1:-1, 1:-1]
        lap = (ul[:-2, 1:-1, 1:-1] + ul[2:, 1:-1, 1:-1]
               + ul[1:-1, :-2, 1:-1] + ul[1:-1, 2:, 1:-1]
               + ul[1:-1, 1:-1, :-2] + ul[1:-1, 1:-1, 2:]
               - 6.0 * core)
        return lax.dynamic_update_slice(ul, core + dt * lap, (1, 1, 1))

    spec = grid.spec(0)
    stencil = shard_map_fn(local_step, grid.mesh, in_specs=(spec,),
                           out_specs=spec)

    def step(u):
        if with_halo:
            u = cd.update_halos(grid, u, 0, HE, PERIODS, donate=donate)
        return stencil(u)

    return step


def init_field(grid, N):
    """Gaussian blob, scattered into the halo'd X-pencil buffer."""
    ax = np.arange(N) - N / 2.0
    r2 = (ax[:, None, None] ** 2 + ax[None, :, None] ** 2
          + ax[None, None, :] ** 2)
    blob = np.exp(-r2 / (2.0 * (N / 16.0) ** 2)).astype(np.float32)
    return blob, cd.scatter_global(grid, blob, 0, halo_extents=HE)


def numpy_steps(u0, dt, steps):
    u = u0.astype(np.float64)
    for _ in range(steps):
        lap = sum(np.roll(u, s, axis=d) for d in range(3) for s in (-1, 1)
                  ) - 6.0 * u
        u = u + dt * lap
    return u


def main(N=64, steps=10, dt=0.1):
    devices = jax.devices()
    n_dev = len(devices)
    pr = int(math.isqrt(n_dev))
    while n_dev % pr:
        pr -= 1
    cfg = GridConfig(gdims=(N, N, N), pdims=(pr, n_dev // pr))
    grid = cd.make_grid(cfg, devices=devices)
    print(f"heat3d: {N}^3 on pdims {cfg.pdims}, dt={dt}")

    blob, u = init_field(grid, N)
    step = make_step(grid, dt)

    @jax.jit
    def run(v):
        return lax.scan(lambda c, _: (step(c), ()), v, None, length=steps)[0]

    out = run(u)
    got = np.asarray(cd.gather_global(grid, out, 0, halo_extents=HE))
    want = numpy_steps(blob, dt, steps)
    err = float(np.max(np.abs(got - want)))
    e0, e1 = float(np.sum(blob ** 2)), float(np.sum(got ** 2))
    print(f"  halo'd-buffer pipeline: max err vs numpy after {steps} "
          f"steps: {err:.3g}")
    print(f"  energy {e0:.6f} -> {e1:.6f} (diffusion decays energy)")
    assert err < 1e-4, err
    assert e1 < e0

    # the ghost-plane pipeline (ops/stencil.py): interior layout, no
    # halo buffer
    ui = cd.scatter_global(grid, blob, 0)

    @jax.jit
    def run_ghost(v):
        return lax.scan(
            lambda c, _: (cd.diffusion_step(grid, c, dt, 0, PERIODS), ()),
            v, None, length=steps)[0]

    got_g = np.asarray(cd.gather_global(grid, run_ghost(ui), 0))
    err_g = float(np.max(np.abs(got_g - want)))
    print(f"  ghost-plane pipeline:   max err vs numpy: {err_g:.3g}")
    assert err_g < 1e-4, err_g

    # single-device marginal halo cost: (halo + stencil) vs stencil-only,
    # forced-completion scanned timing
    if n_dev == 1 and jax.devices()[0].platform != "cpu":
        iters = 32
        cases = (
            ("halo+stencil (concat form)", step, u),
            ("halo+stencil (DUS form)", make_step(grid, dt, donate=True), u),
            ("stencil-only", make_step(grid, dt, with_halo=False), u),
            ("ghost-plane diffusion_step",
             lambda v: cd.diffusion_step(grid, v, dt, 0, PERIODS), ui),
        )
        for label, fn, x0 in cases:
            @jax.jit
            def bench(v, fn=fn):
                out = lax.scan(lambda c, _: (fn(c), ()), v, None,
                               length=iters)[0]
                return jnp.sum(out)

            float(bench(x0)); float(bench(x0))
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                float(bench(x0))
                ts.append((time.perf_counter() - t0) / iters)
            print(f"  {label}: {min(ts)*1e3:.3f} ms/step")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64,
         int(sys.argv[2]) if len(sys.argv) > 2 else 10)
