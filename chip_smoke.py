"""Smoke test of the pencil-decomposition main path on GPUs.

    python chip_smoke.py           # one GPU: every single-card phase
    python chip_smoke.py --four    # four GPUs of one host: the mesh phase

Drives the public API (``make_grid``, the four transposes,
``DistributedFFT``, ``update_halos``, ``diffusion_step``, ``stencil_apply``,
``PoissonSolver``, ``TaylorGreenSolver``) at the per-card share of the
reference's headline (2048^3 over 8 GPUs = 1024^3 per card) and compares
every phase with a plain numpy / scipy / ``jnp.fft`` reference that does
not use this package.  Each phase prints one ``PHASE {...}`` line with its
errors, tolerances, matmul precision, compile and run seconds and the
compiled program's memory estimate.  The last line is
``{"ok": true, "device": {...}}`` only when every phase passed; any
failure, or a process without a GPU, exits non-zero without it.

``jax_enable_x64`` is on for the whole process (the c128 phase), so every
other phase passes float32 / complex64 explicitly.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import jax
import jax.numpy as jnp
import scipy.fft

import cudecomp_tpu as cd
from cudecomp_tpu.config import GridConfig, TransposeMethod
from cudecomp_tpu.models import PoissonSolver, TaylorGreenSolver

GIB = float(1 << 30)


# -- helpers ------------------------------------------------------------------


def _grid(gdims, pdims=(1, 1), devices=None, ac=False, **kw):
    devices = list(devices if devices is not None else jax.devices())
    cfg = GridConfig(gdims=tuple(gdims), pdims=pdims,
                     transpose_axis_contiguous=(ac, ac, ac), **kw)
    return cd.make_grid(cfg, devices=devices[: pdims[0] * pdims[1]])


def _device_random(grid, axis, dtype, seed):
    """Standard-normal pencil generated on the grid's own devices."""
    shape = grid.global_shape(axis)
    key = jax.random.PRNGKey(seed)
    return jax.jit(lambda k: jax.random.normal(k, shape, dtype),
                   out_shardings=grid.sharding(axis))(key)


def _host_random(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        x = x + 1j * rng.standard_normal(shape, dtype=np.float32)
    return x.astype(dtype)


def _mem(compiled):
    """Peak device bytes of one compiled program, from XLA's estimate."""
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return float(ma.argument_size_in_bytes + ma.output_size_in_bytes
                 + ma.temp_size_in_bytes - ma.alias_size_in_bytes)


def _run(fn, *args):
    """Compile ``fn`` for ``args``, run it once to completion.
    Returns (output, {compile_s, run_s, peak_gib})."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t1 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    t2 = time.perf_counter()
    peak = _mem(compiled)
    return out, {"compile_s": round(t1 - t0, 3), "run_s": round(t2 - t1, 4),
                 "peak_gib": None if peak is None else round(peak / GIB, 3)}


def _check(what, err, tol, **extra):
    err = float(err)
    return dict(what=what, err=err, tol=tol, ok=bool(err <= tol), **extra)


def _rel_l2(got, ref):
    got = np.asarray(got, np.complex128) if np.iscomplexobj(got) else \
        np.asarray(got, np.float64)
    return float(np.linalg.norm((got - ref).ravel())
                 / np.linalg.norm(np.asarray(ref).ravel()))


def _to_xyz(arr, grid, axis):
    """Pencil array of a one-device (unpadded) grid in natural [x, y, z]
    order: array dim i holds global axis mem_order(axis)[i]."""
    return np.transpose(np.asarray(arr), grid.config.inv_mem_order(axis))


def _from_xyz(f, grid, axis):
    """Natural-order host array laid out as pencil ``axis`` of a
    one-device grid (the inverse of :func:`_to_xyz`)."""
    return np.transpose(f, grid.config.mem_order(axis))


def _precision():
    return str(jax.config.jax_default_matmul_precision or "default")


def _phase(name, size, checks, stats, **extra):
    ok = all(c["ok"] for c in checks)
    return dict(phase=name, size=size, ok=ok, checks=checks,
                matmul_precision=_precision(), **stats, **extra)


def _spans_all(arr, devices):
    return {s.device for s in arr.addressable_shards} == set(devices)


# -- single-card phases -------------------------------------------------------


def phase_c2c(n=1024, n_ref=512, ac=False, dtype=np.complex64, tol=5e-4,
              ref_tol=1e-5, devices=None):
    """c2c round trip at n^3 (max abs vs the input) and, when ``n_ref``,
    the forward transform at n_ref^3 vs ``scipy.fft.fftn`` in float64."""
    grid = _grid((n, n, n), devices=devices, ac=ac)
    plan = cd.DistributedFFT(grid=grid)
    x = _device_random(grid, 0, dtype, seed=1)
    err, stats = _run(
        lambda v: jnp.max(jnp.abs(plan.inverse(plan.forward(v)) - v)), x)
    del x
    checks = [_check(f"round trip {n}^3 max abs", err, tol)]
    if n_ref:
        g = _grid((n_ref,) * 3, devices=devices, ac=ac)
        p = cd.DistributedFFT(grid=g)
        f = _host_random((n_ref,) * 3, dtype, seed=2)
        got = jax.jit(p.forward)(jax.device_put(_from_xyz(f, g, 0),
                                                g.sharding(0)))
        got = _to_xyz(got, g, 2)
        ref = scipy.fft.fftn(f.astype(np.complex128), workers=-1)
        checks.append(_check(f"forward {n_ref}^3 rel L2 vs scipy",
                             _rel_l2(got, ref), ref_tol))
    return _phase(f"c2c {np.dtype(dtype).name} "
                  f"{'axis-contiguous' if ac else 'natural'}",
                  n, checks, stats)


def phase_r2c(n=1024, n_ref=512, tol=5e-4, ref_tol=1e-5, devices=None):
    """r2c/c2r round trip at n^3 and the r2c forward at n_ref^3 vs
    ``fftn(rfft(f, axis=0), axes=(1, 2))`` in float64."""
    grid = _grid((n, n, n), devices=devices)
    plan = cd.DistributedFFT(grid=grid, real=True)
    x = _device_random(grid, 0, np.float32, seed=3)
    err, stats = _run(
        lambda v: jnp.max(jnp.abs(plan.inverse(plan.forward(v)) - v)), x)
    del x
    checks = [_check(f"round trip {n}^3 max abs", err, tol)]
    if n_ref:
        g = _grid((n_ref,) * 3, devices=devices)
        p = cd.DistributedFFT(grid=g, real=True)
        f = _host_random((n_ref,) * 3, np.float32, seed=4)
        got = jax.jit(p.forward)(jax.device_put(f, g.sharding(0)))
        got = _to_xyz(got, p.complex_grid, 2)
        ref = scipy.fft.fftn(scipy.fft.rfft(f.astype(np.float64), axis=0,
                                            workers=-1),
                             axes=(1, 2), workers=-1)
        checks.append(_check(f"forward {n_ref}^3 rel L2 vs numpy rfft+fftn",
                             _rel_l2(got, ref), ref_tol))
    return _phase("r2c float32", n, checks, stats)


def phase_transpose(n=1024, n_ref=512, ac=False, devices=None):
    """4-op round trip X->Y->Z->Y->X at n^3 f32, bit-exact; each pencil at
    n_ref^3 equal to ``np.transpose`` of the host array."""
    grid = _grid((n, n, n), devices=devices, ac=ac)

    def roundtrip(v):
        y = cd.transpose_x_to_y(grid, v)
        z = cd.transpose_y_to_z(grid, y)
        return cd.transpose_y_to_x(grid, cd.transpose_z_to_y(grid, z))

    x = _device_random(grid, 0, np.float32, seed=5)
    bad, stats = _run(lambda v: jnp.sum(roundtrip(v) != v), x)
    del x
    checks = [_check(f"round trip {n}^3 mismatches", bad, 0)]
    if n_ref:
        g = _grid((n_ref,) * 3, devices=devices, ac=ac)
        f = _host_random((n_ref,) * 3, np.float32, seed=6)
        y = cd.transpose_x_to_y(g, jax.device_put(_from_xyz(f, g, 0),
                                                  g.sharding(0)))
        z = cd.transpose_y_to_z(g, y)
        for name, arr, axis in (("y pencil", y, 1), ("z pencil", z, 2)):
            want = _from_xyz(f, g, axis)
            checks.append(_check(f"{name} {n_ref}^3 mismatches vs "
                                 f"np.transpose",
                                 np.sum(np.asarray(arr) != want), 0))
    return _phase(f"transpose float32 "
                  f"{'axis-contiguous' if ac else 'natural'}",
                  n, checks, stats)


def _np_stencil(f64, w):
    """out[i,j,k] = sum w[1+dx,1+dy,1+dz] * f[i+dx, j+dy, k+dz], periodic,
    from shifted views of one wrap-padded copy."""
    n = f64.shape
    p = np.pad(f64, 1, mode="wrap")
    out = np.zeros_like(f64)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                wv = w[1 + dx, 1 + dy, 1 + dz]
                if wv:
                    out += wv * p[1 + dx:1 + dx + n[0], 1 + dy:1 + dy + n[1],
                                  1 + dz:1 + dz + n[2]]
    return out


def _lap7_weights(alpha=0.0, beta=1.0):
    w = np.zeros((3, 3, 3))
    for d in range(3):
        lo, hi = [1, 1, 1], [1, 1, 1]
        lo[d], hi[d] = 0, 2
        w[tuple(lo)] = w[tuple(hi)] = beta
    w[1, 1, 1] = alpha - 6.0 * beta
    return w


def _halo_shard_checks(grid, out, f, he):
    """Every shard's halo'd block against the wrap-padded host array: a
    shard covering interior [lo, lo+m) holds padded[lo : lo+m+2h]."""
    padded = np.pad(f, [(h, h) for h in he], mode="wrap")
    ms = [grid.config.gdims[d] // p for d, p in
          zip(range(3), (1,) + tuple(grid.config.pdims))]
    bad = 0
    for s in out.addressable_shards:
        sl = []
        for d in range(3):
            start = s.index[d].start or 0
            block = ms[d] + 2 * he[d]
            lo = (start // block) * ms[d]
            sl.append(slice(lo, lo + block))
        bad += int(np.sum(np.asarray(s.data) != padded[tuple(sl)]))
    return bad


def phase_halo_stencil(n=512, pdims=(1, 1), dt=0.1, tol=1e-6,
                       devices=None):
    """Periodic ``update_halos`` (exact), ``diffusion_step`` and a 27-tap
    ``stencil_apply`` (max abs error / max |ref|) vs numpy in float64, on
    the natural X pencil."""
    devices = list(devices if devices is not None else jax.devices())
    grid = _grid((n, n, n), pdims, devices)
    f = _host_random((n, n, n), np.float32, seed=7)
    he = (1, 1, 1)
    per = (True, True, True)
    hbuf = cd.scatter_global(grid, f, 0, halo_extents=he)
    out, stats = _run(lambda b: cd.update_halos(grid, b, 0, he, per), hbuf)
    checks = [_check("update_halos periodic mismatches",
                     _halo_shard_checks(grid, out, f, he), 0)]
    placed = _spans_all(out, devices[: pdims[0] * pdims[1]])
    del out, hbuf
    x = jax.device_put(f, grid.sharding(0))
    f64 = f.astype(np.float64)
    got = jax.jit(lambda v: cd.diffusion_step(grid, v, dt, 0, per))(x)
    ref = _np_stencil(f64, _lap7_weights(1.0, dt))
    checks.append(_check("diffusion_step max err / max|ref|",
                         np.max(np.abs(np.asarray(got) - ref))
                         / np.max(np.abs(ref)), tol))
    placed = placed and _spans_all(got, devices[: pdims[0] * pdims[1]])
    w = np.random.default_rng(8).uniform(-1.0, 1.0, (3, 3, 3))
    got = jax.jit(lambda v: cd.stencil_apply(grid, v, w, 0, per))(x)
    ref = _np_stencil(f64, w)
    checks.append(_check("stencil_apply 27-tap max err / max|ref|",
                         np.max(np.abs(np.asarray(got) - ref))
                         / np.max(np.abs(ref)), tol))
    return _phase(f"halo+stencil float32 pdims {pdims[0]}x{pdims[1]}", n,
                  checks, stats, placed_on_all_devices=bool(placed))


def phase_poisson(n=512, tol=1e-4, cg_tol=1e-5, maxiter=20000,
                  devices=None):
    """``PoissonSolver.solve(discrete=True)``: lap7(u)/h^2 (numpy float64)
    reproduces f; ``solve_cg`` reaches ``cg_tol`` and its u does too."""
    grid = _grid((n, n, n), devices=devices)
    solver = PoissonSolver(grid=grid)
    f64 = np.random.default_rng(9).standard_normal((n, n, n))
    f64 -= f64.mean()
    f = f64.astype(np.float32)
    fd = jax.device_put(f, grid.sharding(0))
    h = 2 * np.pi / n
    lap = _lap7_weights()
    u, stats = _run(lambda v: solver.solve(v, discrete=True), fd)
    resid = _np_stencil(np.asarray(u, np.float64), lap) / h ** 2
    checks = [_check("solve(discrete) rel L2 of lap7(u)/h^2 - f",
                     _rel_l2(resid, f64), tol)]
    t0 = time.perf_counter()
    ucg, iters, rel = solver.solve_cg(fd, tol=cg_tol, maxiter=maxiter)
    cg_s = time.perf_counter() - t0
    checks.append(_check("solve_cg recursive rel residual", rel, cg_tol,
                         iters=int(iters)))
    resid = _np_stencil(np.asarray(ucg, np.float64), lap) / h ** 2
    checks.append(_check("solve_cg rel L2 of lap7(u)/h^2 - f",
                         _rel_l2(resid, f64), tol))
    return _phase("poisson float32", n, checks, stats,
                  cg_s=round(cg_s, 3))


def _tg_reference(n, nu, dt, n_steps):
    """Float64 energy history of the explicit-RK4 Taylor-Green scheme
    (the independent reference of tests/test_models.py), on scipy.fft."""
    fftn = lambda a: scipy.fft.fftn(a, workers=-1)  # noqa: E731
    ifftn = lambda a: scipy.fft.ifftn(a, workers=-1).real  # noqa: E731
    xs = np.arange(n) * 2 * np.pi / n
    x, y, z = np.meshgrid(xs, xs, xs, indexing="ij")
    u0 = np.stack([np.cos(x) * np.sin(y) * np.sin(z),
                   -np.sin(x) * np.cos(y) * np.sin(z),
                   np.zeros_like(x)], axis=-1)
    del x, y, z
    k = np.fft.fftfreq(n, d=1.0 / n)
    kx, ky, kz = np.meshgrid(k, k, k, indexing="ij", sparse=True)
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    inv_k2 = np.where(k2 > 0, 1.0 / np.where(k2 > 0, k2, 1), 0.0)
    keep = np.abs(k) < (n // 2) * (2.0 / 3.0)
    mask = (keep[:, None, None] & keep[None, :, None] & keep[None, None, :]
            & (k2 > 0)).astype(float)

    def fftv(u):
        return np.stack([fftn(u[..., c]) for c in range(3)], axis=-1)

    def ifftv(uh):
        return np.stack([ifftn(uh[..., c]) for c in range(3)], axis=-1)

    def rhs(uh):
        u = ifftv(uh)
        w = ifftv(np.stack([
            1j * (ky * uh[..., 2] - kz * uh[..., 1]),
            1j * (kz * uh[..., 0] - kx * uh[..., 2]),
            1j * (kx * uh[..., 1] - ky * uh[..., 0])], axis=-1))
        nl = np.stack([u[..., 1] * w[..., 2] - u[..., 2] * w[..., 1],
                       u[..., 2] * w[..., 0] - u[..., 0] * w[..., 2],
                       u[..., 0] * w[..., 1] - u[..., 1] * w[..., 0]],
                      axis=-1)
        nh = fftv(nl) * mask[..., None]
        s = (kx * nh[..., 0] + ky * nh[..., 1] + kz * nh[..., 2]) * inv_k2
        nh = nh - np.stack([kx * s, ky * s, kz * s], axis=-1)
        return nh - nu * k2[..., None] * uh

    uh = fftv(u0)
    energies = [0.5 * np.mean(np.sum(u0 * u0, axis=-1))]
    for _ in range(n_steps):
        k1 = rhs(uh)
        k2_ = rhs(uh + 0.5 * dt * k1)
        k3 = rhs(uh + 0.5 * dt * k2_)
        k4 = rhs(uh + dt * k3)
        uh = uh + dt / 6 * (k1 + 2 * k2_ + 2 * k3 + k4)
        u = ifftv(uh)
        energies.append(0.5 * np.mean(np.sum(u * u, axis=-1)))
    return energies


def phase_taylor_green(n=128, n_steps=2, nu=0.01, dt=0.01, tol=1e-4,
                       devices=None):
    """Two explicit RK4 steps of the Taylor-Green solver (float64 state);
    the kinetic-energy history vs the float64 reference, relative.  128^3:
    the host reference alone takes over a minute at 256^3."""
    grid = _grid((n, n, n), devices=devices)
    solver = TaylorGreenSolver(grid=grid, nu=nu, integrating_factor=False)
    uh, fields = solver.setup()
    t0 = time.perf_counter()
    step = jax.jit(lambda s: solver.step(s, fields, dt)).lower(uh).compile()
    t1 = time.perf_counter()
    energy = jax.jit(lambda s: solver.energy(s, fields))
    history = [float(energy(uh))]
    for _ in range(n_steps):
        uh = step(uh)
        history.append(float(energy(uh)))
    t2 = time.perf_counter()
    ref = _tg_reference(n, nu, dt, n_steps)
    t3 = time.perf_counter()
    err = max(abs(a - b) / abs(b) for a, b in zip(history, ref))
    checks = [_check(f"energy history ({n_steps} RK4 steps) max rel err",
                     err, tol)]
    peak = _mem(step)
    stats = {"compile_s": round(t1 - t0, 3), "run_s": round(t2 - t1, 3),
             "peak_gib": None if peak is None else round(peak / GIB, 3),
             "reference_s": round(t3 - t2, 3)}
    return _phase("taylor-green float64", n, checks, stats)


# -- four-card phase ----------------------------------------------------------


def phase_four_c2c(gdims=(2048, 2048, 1024), pdims=(2, 2),
                   method=TransposeMethod.ALL_TO_ALL, tol=5e-4,
                   devices=None):
    """c2c f32 round trip over a pdims mesh; every output shard placed."""
    devices = list(devices if devices is not None else jax.devices())
    grid = _grid(gdims, pdims, devices, transpose_method=method)
    plan = cd.DistributedFFT(grid=grid)
    x = _device_random(grid, 0, np.complex64, seed=10)
    spec, stats = _run(plan.forward, x)
    placed = _spans_all(spec, devices[: pdims[0] * pdims[1]])
    err = float(jax.jit(lambda s, v: jnp.max(jnp.abs(plan.inverse(s) - v)))(
        spec, x))
    del spec, x
    checks = [_check("round trip max abs", err, tol)]
    return _phase(f"4-card c2c float32 pdims {pdims[0]}x{pdims[1]} "
                  f"{method.value}", "x".join(map(str, gdims)), checks,
                  stats, placed_on_all_devices=bool(placed))


def phase_four_forward_vs_one(n=1024, pdims=(2, 2), tol=1e-5,
                              devices=None):
    """Forward c2c at n^3 on the mesh vs ``jnp.fft.fftn`` of the same array
    on the first device alone: rel L2."""
    devices = list(devices if devices is not None else jax.devices())
    grid = _grid((n, n, n), pdims, devices)
    plan = cd.DistributedFFT(grid=grid)
    x = _device_random(grid, 0, np.complex64, seed=11)
    spec, stats = _run(plan.forward, x)
    placed = _spans_all(spec, devices[: pdims[0] * pdims[1]])
    one = jax.sharding.SingleDeviceSharding(devices[0])
    x1 = jax.device_put(x, one)
    del x
    got = jnp.transpose(jax.device_put(spec, one),
                        grid.config.inv_mem_order(2))
    del spec
    ref = jax.jit(jnp.fft.fftn)(x1)
    del x1
    rel = float(jax.jit(lambda a, b: jnp.linalg.norm((a - b).ravel())
                        / jnp.linalg.norm(b.ravel()))(got, ref))
    checks = [_check(f"forward {n}^3 rel L2 vs one-device jnp.fft.fftn",
                     rel, tol)]
    return _phase(f"4-card forward vs 1 card pdims {pdims[0]}x{pdims[1]}",
                  n, checks, stats, placed_on_all_devices=bool(placed))


def phase_four_transpose(gdims=(2048, 2048, 1024), pdims=(2, 2),
                         devices=None):
    """4-op transpose round trip over the mesh, bit-exact."""
    devices = list(devices if devices is not None else jax.devices())
    grid = _grid(gdims, pdims, devices)

    def roundtrip(v):
        y = cd.transpose_x_to_y(grid, v)
        z = cd.transpose_y_to_z(grid, y)
        return cd.transpose_y_to_x(grid, cd.transpose_z_to_y(grid, z))

    x = _device_random(grid, 0, np.float32, seed=12)
    out, stats = _run(roundtrip, x)
    placed = _spans_all(out, devices[: pdims[0] * pdims[1]])
    bad = int(jax.jit(lambda a, b: jnp.sum(a != b))(out, x))
    checks = [_check("round trip mismatches", bad, 0)]
    return _phase(f"4-card transpose float32 pdims {pdims[0]}x{pdims[1]}",
                  "x".join(map(str, gdims)), checks, stats,
                  placed_on_all_devices=bool(placed))


def phase_four_uneven(gdims=(513, 514, 515), pdims=(2, 2), tol=1e-5,
                      devices=None):
    """c2c forward on a grid pdims does not divide vs scipy (rel L2)."""
    devices = list(devices if devices is not None else jax.devices())
    grid = _grid(gdims, pdims, devices)
    plan = cd.DistributedFFT(grid=grid)
    f = _host_random(gdims, np.complex64, seed=13)
    x = cd.scatter_global(grid, f, 0)
    spec, stats = _run(plan.forward, x)
    placed = _spans_all(spec, devices[: pdims[0] * pdims[1]])
    got = cd.gather_global(grid, spec, 2)
    ref = scipy.fft.fftn(f.astype(np.complex128), workers=-1)
    checks = [_check("forward rel L2 vs scipy", _rel_l2(got, ref), tol)]
    return _phase(f"4-card uneven c2c pdims {pdims[0]}x{pdims[1]}",
                  "x".join(map(str, gdims)), checks, stats,
                  placed_on_all_devices=bool(placed))


# -- driver -------------------------------------------------------------------


def single_card_phases():
    return [
        ("c2c-natural", lambda: phase_c2c(ac=False)),
        ("c2c-contiguous", lambda: phase_c2c(ac=True)),
        ("r2c", phase_r2c),
        ("c2c-c128", lambda: phase_c2c(n=512, n_ref=0, dtype=np.complex128,
                                       tol=1e-10)),
        ("transpose-natural", lambda: phase_transpose(ac=False)),
        ("transpose-contiguous", lambda: phase_transpose(ac=True)),
        ("halo-stencil", phase_halo_stencil),
        ("poisson", phase_poisson),
        ("taylor-green", phase_taylor_green),
    ]


def four_card_phases():
    a2a, ring = TransposeMethod.ALL_TO_ALL, TransposeMethod.RING
    pipe = TransposeMethod.RING_PIPELINED
    return [
        ("4-c2c-1x4", lambda: phase_four_c2c(pdims=(1, 4), method=a2a)),
        ("4-c2c-2x2", lambda: phase_four_c2c(pdims=(2, 2), method=a2a)),
        ("4-c2c-4x1", lambda: phase_four_c2c(pdims=(4, 1), method=a2a)),
        ("4-c2c-2x2-ring", lambda: phase_four_c2c(method=ring)),
        ("4-c2c-2x2-pipelined", lambda: phase_four_c2c(method=pipe)),
        ("4-forward-vs-one", phase_four_forward_vs_one),
        ("4-transpose", phase_four_transpose),
        ("4-halo-stencil", lambda: phase_halo_stencil(pdims=(2, 2))),
        ("4-uneven", phase_four_uneven),
    ]


def _live_gib(devices):
    """Largest device-memory footprint left over any device."""
    used = [(d.memory_stats() or {}).get("bytes_in_use", 0) for d in devices]
    return round(max(used) / GIB, 3)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    ap.add_argument("--only", default="",
                    help="comma list of phase names to run (default all)")
    args = ap.parse_args(argv)

    jax.config.update("jax_enable_x64", True)
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    from cudecomp_tpu.utils.env import use_compile_cache
    use_compile_cache()
    print(_card_line(), flush=True)
    print(f"jax {jax.__version__}, {len(devices)} x "
          f"{devices[0].device_kind}", flush=True)

    phases = four_card_phases() if args.four else single_card_phases()
    if args.only:
        wanted = set(args.only.split(","))
        phases = [(n, f) for n, f in phases if n in wanted]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            rec = fn()
        except Exception:  # recorded as a failed phase; the run exits 1
            traceback.print_exc()
            rec = {"phase": name, "ok": False, "error": "exception"}
        rec["wall_s"] = round(time.perf_counter() - t0, 3)
        gc.collect()  # this phase's arrays are freed before the next
        rec["live_gib_after"] = _live_gib(devices)
        print("PHASE " + json.dumps(rec), flush=True)
        if not rec["ok"]:
            failed.append(name)
    if failed or not phases:
        print(f"chip_smoke: FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
