"""Bring-up measurements on GPUs: FFT engines, dot precisions, local
permutes against a plain copy, the stencil kernel against XLA's form and
the memory roofline, and a four-GPU mesh trace (``--only mesh_trace``).

    python scripts/bringup_measure.py [--out chiprun_out/bringup]

Prints one ``MEASURE {...}`` JSON line per measurement and writes them,
plus the trace-lane summary, under ``--out``.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import cudecomp_tpu as cd  # noqa: E402
from cudecomp_tpu import performance as perf  # noqa: E402
from cudecomp_tpu.config import GridConfig  # noqa: E402

RESULTS = []


def emit(**rec):
    RESULTS.append(rec)
    print("MEASURE " + json.dumps(rec), flush=True)


def _grid(n, ac=False):
    return cd.make_grid(GridConfig(gdims=(n, n, n), pdims=(1, 1),
                                   transpose_axis_contiguous=(ac,) * 3),
                        devices=jax.devices()[:1])


def _trace_files(d):
    return glob.glob(os.path.join(d, "**", "*.trace.json.gz"),
                     recursive=True)


def _spans(d):
    out = []
    for p in _trace_files(d):
        with gzip.open(p, "rt") as f:
            out += perf._device_op_spans(json.load(f))
    return out


def lanes(d, outdir):
    """Process / thread names of a GPU trace with event counts and the arg
    keys their events carry: the facts the lane rule is written from."""
    summary = {}
    for p in _trace_files(d):
        with gzip.open(p, "rt") as f:
            data = json.load(f)
        pn, tn = {}, {}
        for e in data["traceEvents"]:
            if e.get("ph") == "M" and e.get("name") == "process_name":
                pn[e["pid"]] = e["args"].get("name")
            if e.get("ph") == "M" and e.get("name") == "thread_name":
                tn[(e["pid"], e["tid"])] = e["args"].get("name")
        for e in data["traceEvents"]:
            if e.get("ph") != "X":
                continue
            k = f"{pn.get(e['pid'])} | {tn.get((e['pid'], e.get('tid')))}"
            s = summary.setdefault(k, {"n": 0, "ms": 0.0, "args": set(),
                                       "names": set()})
            s["n"] += 1
            s["ms"] += e.get("dur", 0) / 1e3
            s["args"] |= set((e.get("args") or {}).keys())
            if len(s["names"]) < 6:
                s["names"].add(e.get("name"))
    summary = {k: {"n": v["n"], "ms": round(v["ms"], 3),
                   "args": sorted(v["args"]), "names": sorted(v["names"])}
               for k, v in summary.items()}
    with open(os.path.join(outdir, "trace_lanes.json"), "w") as f:
        json.dump(summary, f, indent=1)
    emit(what="trace lanes", lanes={k: (v["n"], v["ms"])
                                    for k, v in summary.items()})


def traced(fn, args, outdir, tag, reps=3):
    """Device op spans (name -> ms per call) of ``reps`` calls of a
    compiled ``fn``."""
    compiled = jax.jit(fn).lower(*args).compile()
    jax.block_until_ready(compiled(*args))
    d = os.path.join(outdir, "trace_" + tag)
    n_old = len(glob.glob(os.path.join(d, "*")))
    d = os.path.join(d, str(n_old))
    with jax.profiler.trace(d):
        for _ in range(reps):
            jax.block_until_ready(compiled(*args))
    ops = {}
    for name, ms in _spans(d):
        ops[name] = ops.get(name, 0.0) + ms / reps
    return ops, d


def scanned_ms(fn, x, iters):
    return 1e3 * min(perf.time_scanned(fn, x, iters=iters, n_warmup=1,
                                       n_trials=3))


def fft_engines(n):
    """c2c round trip: cuFFT (jnp.fft) vs the matmul FFT at three dot
    precisions, each gated at 5e-4 max abs after one round trip."""
    grid = _grid(n)
    shape = grid.global_shape(0)
    key = jax.random.PRNGKey(0)
    iters = 4 if n >= 1024 else 10
    flops = 5.0 * n ** 3 * math.log2(n ** 3)
    x = jax.jit(lambda k: jax.random.normal(k, shape, jnp.complex64))(key)
    plan = cd.DistributedFFT(grid=grid)
    cyc = lambda v: plan.inverse(plan.forward(v))  # noqa: E731
    err = float(jax.jit(lambda v: jnp.max(jnp.abs(cyc(v) - v)))(x))
    ms = scanned_ms(cyc, x, iters)
    emit(what=f"c2c round trip {n}^3", engine="cuFFT (jnp.fft)",
         ms=ms, gflops_per_dir=flops / (ms / 2e3) / 1e9, err=err,
         gate_ok=bool(err < 5e-4))
    planes = (jnp.real(x), jnp.imag(x))
    del x
    for prec in ("highest", "high", "default"):
        sp = cd.DistributedFFT(grid=grid, split_complex=True, precision=prec)
        cyc = lambda v, sp=sp: sp.inverse_planes(sp.forward_planes(v))  # noqa
        try:
            err = float(jax.jit(lambda v, c=cyc: jnp.maximum(
                jnp.max(jnp.abs(c(v)[0] - v[0])),
                jnp.max(jnp.abs(c(v)[1] - v[1]))))(planes))
            ms = (scanned_ms(cyc, planes, iters) if err < 5e-4 else None)
            emit(what=f"c2c round trip {n}^3", engine=f"matmul FFT {prec}",
                 ms=ms, gflops_per_dir=(flops / (ms / 2e3) / 1e9
                                        if ms else None),
                 err=err, gate_ok=bool(err < 5e-4))
        except Exception as e:  # an OOM or compile refusal is a finding
            emit(what=f"c2c round trip {n}^3", engine=f"matmul FFT {prec}",
                 error=f"{type(e).__name__}: {str(e)[:300]}")


def dot_precisions():
    """What an f32 dot computes at each lax.Precision on this card: error
    vs float64, rate, and the algorithm XLA chose (from the HLO)."""
    m = 4096
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, m), dtype=np.float32)
    b = rng.standard_normal((m, m), dtype=np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    da, db = jax.device_put(a), jax.device_put(b)
    for prec in ("default", "high", "highest"):
        fn = jax.jit(lambda x, y, p=prec: jnp.dot(x, y, precision=p))
        compiled = fn.lower(da, db).compile()
        txt = compiled.as_text()
        lines = [ln.strip()[:400] for ln in txt.splitlines()
                 if "custom-call" in ln or "algorithm" in ln
                 or "dot(" in ln]
        got = np.asarray(compiled(da, db))
        rel = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(da, db))
            t.append(time.perf_counter() - t0)
        emit(what="f32 dot 4096^2", precision=prec, max_rel_err=rel,
             tflops=2 * m ** 3 / min(t) / 1e12, hlo=lines[:4])


def permutes(n, outdir):
    """Each op of the 4-op round trip at n^3 f32 on one device: device time
    of its local permute from the trace, bytes/s (1 read + 1 write), and a
    plain elementwise copy of the same bytes in the same process."""
    nbytes = 2 * 4 * n ** 3
    x = jax.jit(lambda k: jax.random.normal(k, (n, n, n), jnp.float32))(
        jax.random.PRNGKey(1))
    ops, _ = traced(lambda v: v * 2.0, (x,), outdir, f"copy{n}")
    copy_ms = sum(ops.values())
    emit(what=f"copy {n}^3 f32 (x*2)", device_ms=copy_ms,
         gbps=nbytes / (copy_ms / 1e3) / 1e9, ops=ops)
    for ac in (False, True):
        grid = _grid(n, ac)
        cur = x
        for op in (cd.transpose_x_to_y, cd.transpose_y_to_z,
                   cd.transpose_z_to_y, cd.transpose_y_to_x):
            ops, _ = traced(lambda v, op=op, g=grid: op(g, v), (cur,), outdir,
                            f"{op.__name__}{n}{'ac' if ac else ''}")
            ms = sum(ops.values())
            emit(what=f"{op.__name__} {n}^3 f32",
                 layout="axis-contiguous" if ac else "natural",
                 device_ms=ms, gbps=(nbytes / (ms / 1e3) / 1e9 if ms else
                                     None),
                 share_of_copy=(copy_ms / ms if ms else None), ops=ops)
            cur = jax.block_until_ready(op(grid, cur))
        seg = perf.segment_roundtrip(grid, np.float32, iters=8, n_warmup=1,
                                     n_trials=3, record=False)
        emit(what=f"transpose round trip {n}^3 f32 (host-timed, per op "
                  f"scanned)", layout="axis-contiguous" if ac else "natural",
             ms=seg["total_ms"])
        del cur


def stencil_kernel_vs_xla(n, outdir):
    """The GPU stencil kernel (Pallas, Triton route) against XLA's
    shifted-slice form, end to end through the public ops, in turns
    (kernel, XLA, XLA, kernel); the rows of one pair come from one
    process and one card."""
    from cudecomp_tpu.ops import stencil as st
    grid = _grid(n)
    roof_ms = 2 * 4 * n ** 3 / 3.35e12 * 1e3
    x = jax.jit(lambda k: jax.random.normal(k, (n, n, n), jnp.float32))(
        jax.random.PRNGKey(2))
    w = np.random.default_rng(3).uniform(-1, 1, (3, 3, 3))
    per = (True, True, True)
    use_kernel = st._use_stencil_kernel
    outs = {}
    for impl in ("kernel", "xla", "xla", "kernel"):
        st._use_stencil_kernel = (use_kernel if impl == "kernel"
                                  else (lambda *a: False))
        st._stencil_apply_fn.cache_clear()
        st._diff_apply_fn.cache_clear()
        for name, fn in (
                ("diffusion_step", lambda v: cd.diffusion_step(
                    grid, v, 0.1, 0, per)),
                ("stencil_apply 27-tap", lambda v: cd.stencil_apply(
                    grid, v, w, 0, per))):
            ms = scanned_ms(fn, x, 20)
            ops, _ = traced(fn, (x,), outdir, f"{impl}_{name.split()[0]}")
            out = jax.jit(fn)(x)
            if name in outs:
                diff = float(jnp.max(jnp.abs(out - outs[name])))
            else:
                outs[name], diff = out, 0.0
            emit(what=f"{name} {n}^3 f32", impl=impl, ms=ms,
                 device_ms=sum(ops.values()), roofline_ms=roof_ms,
                 x_roofline=ms / roof_ms, max_diff_vs_first=diff, ops=ops)
    st._use_stencil_kernel = use_kernel


def mesh_trace(n, outdir):
    """Trace of a c2c forward over a 2x2 mesh of four GPUs: the lanes the
    collectives land on and the comm/local split of device time."""
    devices = jax.devices()[:4]
    grid = cd.make_grid(GridConfig(gdims=(n, n, n), pdims=(2, 2)),
                        devices=devices)
    plan = cd.DistributedFFT(grid=grid)
    x = jax.jit(lambda k: jax.random.normal(k, grid.global_shape(0),
                                            jnp.complex64),
                out_shardings=grid.sharding(0))(jax.random.PRNGKey(6))
    ops, d = traced(plan.forward, (x,), outdir, f"mesh{n}")
    attr = perf.device_op_attribution(d)
    emit(what=f"c2c forward {n}^3 over 2x2 GPUs (device time per call, "
              f"summed over the 4 devices)", comm_ms=attr["comm_ms"] / 3,
         local_ms=attr["local_ms"] / 3, ops=ops)
    lanes(d, outdir)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/bringup")
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        print("bringup_measure: needs a GPU", file=sys.stderr)
        return 2
    from cudecomp_tpu.utils.env import use_compile_cache
    use_compile_cache()
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    emit(what="card", card=card, jax=jax.__version__,
         kind=jax.devices()[0].device_kind)
    steps = {
        "precision": dot_precisions,
        "fft512": lambda: fft_engines(512),
        "fft1024": lambda: fft_engines(1024),
        "permute": lambda: permutes(1024, args.out),
        "stencil_kernel": lambda: stencil_kernel_vs_xla(512, args.out),
        "mesh_trace": lambda: mesh_trace(1024, args.out),
    }
    only = set(filter(None, args.only.split(",")))
    for name, fn in steps.items():
        if (only and name not in only) or (not only and name == "mesh_trace"):
            continue
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # keep the other measurements
            emit(what=name, error=f"{type(e).__name__}: {str(e)[:500]}")
        emit(what=f"{name} wall", s=time.perf_counter() - t0)
    lane_dirs = sorted(glob.glob(os.path.join(args.out, "trace_*")))
    if lane_dirs and "mesh_trace" not in only:
        lanes(lane_dirs[0], args.out)
    with open(os.path.join(args.out, "measure.json"), "w") as f:
        json.dump(RESULTS, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
