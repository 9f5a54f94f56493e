"""AOT-compile the reference-headline-scale programs on a multichip mesh.

The reference's headline table is a 2048^3 benchmark on 8 GPUs.  This
script checks, without any accelerator, that the production programs —
the r2c FFT round trip and the 4-op transpose cycle — lower and compile
through XLA at 1024^3 (and optionally 2048^3) over a multi-device mesh,
with every exchange riding real collectives, and reports XLA's memory
analysis per device.

Compile-only (jit(...).lower(shapes).compile()): no 4 GiB buffers are
materialized and nothing executes, so this runs on the CPU virtual mesh.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/compile_1024_mesh.py [N] [pr] [pc]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp


def main(N=1024, pr=2, pc=4):
    import cudecomp_tpu as cd
    from cudecomp_tpu.ops.fft import DistributedFFT

    devices = jax.devices("cpu")[: pr * pc]
    assert len(devices) == pr * pc, devices
    cfg = cd.GridConfig(gdims=(N, N, N), pdims=(pr, pc))
    grid = cd.make_grid(cfg, devices=devices)
    rplan = DistributedFFT(grid=grid, real=True)

    shape = grid.global_shape(0)
    xspec = jax.ShapeDtypeStruct(shape, jnp.float32,
                                 sharding=grid.sharding(0))

    @jax.jit
    def fft_cycle(v):
        return rplan.inverse(rplan.forward(v))

    @jax.jit
    def transpose_cycle(v):
        y = cd.transpose_x_to_y(grid, v)
        z = cd.transpose_y_to_z(grid, y)
        y2 = cd.transpose_z_to_y(grid, z)
        return cd.transpose_y_to_x(grid, y2)

    out = {"N": N, "pdims": [pr, pc], "n_devices": pr * pc}
    for name, fn in (("transpose_cycle", transpose_cycle),
                     ("r2c_fft_cycle", fft_cycle)):
        t0 = time.time()
        compiled = fn.lower(xspec).compile()
        mem = compiled.memory_analysis()
        out[name] = {
            "compile_s": round(time.time() - t0, 1),
            "per_device_output_gib": round(
                sum(np.prod(s.shape) * s.dtype.itemsize
                    for s in jax.tree_util.tree_leaves(
                        jax.eval_shape(fn, xspec))) / (pr * pc) / 2**30, 3),
            "xla_temp_gib": round(
                getattr(mem, "temp_size_in_bytes", 0) / 2**30, 3),
            "xla_argument_gib": round(
                getattr(mem, "argument_size_in_bytes", 0) / 2**30, 3),
        }
        print(json.dumps({name: out[name]}), flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)
