"""Distributed 3D FFT layered on the transpose engine.

Rebuild of the reference FFT benchmark skeleton
(``benchmark/benchmark.cu:294-412,501-611``): per-axis 1D FFTs along each
pencil's full axis interleaved with global transposes,

    FFT_x -> X2Y -> FFT_y -> Y2Z -> FFT_z      (forward)
    iFFT_z -> Z2Y -> iFFT_y -> Y2X -> iFFT_x   (inverse)

with the reference's slab optimizations (``benchmark.cu:294-356``): when a
transpose is communication-free (process-grid factor of 1) and the memory
orders agree, adjacent FFT stages fuse into one multi-axis local FFT and the
no-op transpose is skipped entirely.

R2C/C2R uses twin real/complex grid descriptors exactly like the benchmark's
twin-descriptor trick (``benchmark.cu:238-252``): the complex grid has
X extent ``X//2 + 1``; Y/Z decompositions coincide since pdims match.

Two FFT kernels:
  * ``split_complex=False`` — complex dtypes + ``jnp.fft`` (the XLA FFT op,
    which XLA hands to cuFFT on GPUs) — the main path;
  * ``split_complex=True`` — the matmul FFT (``ops.mxu_fft``) on
    split-complex buffers (trailing component dim 2): DFT stages as dense
    real contractions, for runtimes without complex dtypes.  Transposes
    carry the component dim through.

Normalization follows jnp.fft (inverse scales by 1/N), so
``ifft3d(fft3d(x)) == x`` to rounding.
"""

from __future__ import annotations

import dataclasses
import functools
import jax
import jax.numpy as jnp

from cudecomp_tpu.config import GridConfig
from cudecomp_tpu.grid import GridDescriptor
from cudecomp_tpu.ops import transpose as tr
from cudecomp_tpu.parallel.collectives import shard_map_fn
from cudecomp_tpu.utils.tracing import trace_range


def _fft_axes(grid, axis, global_axes):
    """Array dims (in the pencil's memory order) holding the given global axes."""
    inv = grid.config.inv_mem_order(axis)
    return tuple(inv[a] for a in global_axes)


def _use_matmul_complex(mesh) -> bool:
    """XLA:CPU's FFT thunk RET_CHECKs on non-default operand layouts, which
    layout assignment can produce when elementwise ops sit between FFT
    stages inside one jit (e.g. a spectral scale in a Poisson solve).  On
    a CPU mesh we therefore run complex FFT stages through the matmul FFT
    core (ops.mxu_fft, machine-precision accurate) instead of the XLA FFT
    op; GPU meshes use the XLA FFT op (cuFFT).  Keyed on the platform of
    the mesh the plan runs on, not the process default backend."""
    return mesh.devices.flat[0].platform == "cpu"


def _complex_fft_1d(x, axis, kind, n=None, matmul=False):
    """One complex/real FFT along ``axis``: kind in fft|ifft|rfft|irfft;
    ``matmul`` selects the matmul FFT core (see _use_matmul_complex)."""
    from cudecomp_tpu.ops import mxu_fft
    if matmul:
        if kind == "rfft":
            s = mxu_fft.rfft_split(x, axis)
            return mxu_fft.from_split(s)
        if kind == "irfft":
            return mxu_fft.irfft_split(mxu_fft.to_split(x), axis, n=n)
        s = mxu_fft.fft_split(mxu_fft.to_split(x), axis,
                              inverse=(kind == "ifft"))
        return mxu_fft.from_split(s)
    if kind == "rfft":
        return jnp.fft.rfft(x, axis=axis)
    if kind == "irfft":
        return jnp.fft.irfft(x, n=n, axis=axis)
    op = jnp.fft.ifft if kind == "ifft" else jnp.fft.fft
    return op(x, axis=axis)


def _xla_fftn(x, axes, inverse, matmul=False):
    if matmul:
        for a in axes:
            x = _complex_fft_1d(x, a, "ifft" if inverse else "fft",
                                matmul=True)
        return x
    # one multi-axis XLA FFT op (one cuFFT plan over the fused axes, the
    # reference benchmark's slab-mode multi-dimensional plans)
    op = jnp.fft.ifftn if inverse else jnp.fft.fftn
    return op(x, axes=tuple(axes))


@functools.lru_cache(maxsize=512)
def _build_local_fft(grid, axis, kind, axes, n, matmul, n_comp_dims):
    """Jitted per-shard FFT stage on pencil-``axis`` buffers (trailing
    component dims pass through unsharded), cached per configuration like
    the transpose programs.

    The local FFT stages run per shard: the FFT axes of a pencil are never
    sharded, so each device transforms its own block.  Left to the SPMD
    partitioner, XLA's FFT op is replicated instead — an all-gather of
    the whole array onto every device."""
    from jax.sharding import PartitionSpec

    def fn(b):
        if kind in ("fft", "ifft"):
            return _xla_fftn(b, axes, kind == "ifft", matmul)
        return _complex_fft_1d(b, axes[0], kind, n=n, matmul=matmul)

    spec = PartitionSpec(*grid.spec(axis), *([None] * n_comp_dims))
    return jax.jit(shard_map_fn(fn, grid.mesh, in_specs=(spec,),
                                out_specs=spec))


def _local_fft(grid, axis, x, kind, axes, n=None):
    """FFT stage ``kind`` (fft|ifft|rfft|irfft) along array dims ``axes``
    of a pencil-``axis`` buffer, run per shard (see _build_local_fft)."""
    return _build_local_fft(grid, axis, kind, tuple(axes), n,
                            _use_matmul_complex(grid.mesh), x.ndim - 3)(x)


def complex_grid_config(cfg: GridConfig) -> GridConfig:
    """Twin complex-grid config for R2C: X extent becomes X//2 + 1."""
    gx = cfg.gdims[0] // 2 + 1
    gd = None
    if cfg.gdims_dist is not None:
        gd = (min(cfg.gdims_dist[0], gx), cfg.gdims_dist[1], cfg.gdims_dist[2])
    return dataclasses.replace(cfg, gdims=(gx, cfg.gdims[1], cfg.gdims[2]),
                               gdims_dist=gd)


@dataclasses.dataclass(frozen=True)
class DistributedFFT:
    """A planned distributed 3D FFT over a grid descriptor.

    ``forward`` maps an X-pencil physical-space buffer to a Z-pencil spectral
    buffer; ``inverse`` maps back.  Both are jittable and differentiable.

    For ``real=True``, forward input is a real X-pencil on ``grid`` and the
    spectral output lives on ``complex_grid`` (X extent X//2+1).

    ``precision`` / ``gauss`` pin a per-plan matmul-FFT policy (the
    planner analog of cuFFT plan attributes); ``None`` defers to the env
    knobs (``CUDECOMP_TPU_FFT_PRECISION`` / ``_GAUSS``).
    :func:`autotune_fft` returns a plan with the fastest gate-passing
    policy pinned.
    """

    grid: GridDescriptor
    real: bool = False
    split_complex: bool = False
    precision: str = None
    gauss: bool = None

    def _policy(self):
        if self.precision is None and self.gauss is None:
            import contextlib
            return contextlib.nullcontext()
        from cudecomp_tpu.ops import mxu_fft
        return mxu_fft.policy(self.precision, self.gauss)

    @property
    def complex_grid(self) -> GridDescriptor:
        if not self.real:
            return self.grid
        return GridDescriptor(config=complex_grid_config(self.grid.config),
                              mesh=self.grid.mesh,
                              axis_names=self.grid.axis_names)

    # -- planning ------------------------------------------------------------------

    def _stages(self):
        """Forward plan: list of ('fft', grid, pencil_axis, global_axes) and
        ('transpose', ax, dir) steps, with slab fusions applied."""
        cgrid = self.complex_grid
        cfg = cgrid.config
        pr, pc = cfg.pdims
        # local-transpose detection: communication-free when the comm factor
        # is 1 AND the memory orders agree (otherwise a local permute remains,
        # which the transpose op handles without collectives anyway).
        xy_local = pr == 1 and cfg.mem_order(0) == cfg.mem_order(1)
        yz_local = pc == 1 and cfg.mem_order(1) == cfg.mem_order(2)

        stages = []
        if xy_local and yz_local:
            stages.append(("fft", 0, (0, 1, 2)))        # single local 3D FFT
        elif xy_local:
            stages.append(("fft", 0, (0, 1)))           # 2D FFT over (x, y)
            stages.append(("transpose", 1, +1))
            stages.append(("fft", 2, (2,)))
        elif yz_local:
            stages.append(("fft", 0, (0,)))
            stages.append(("transpose", 0, +1))
            stages.append(("fft", 1, (1, 2)))           # 2D FFT over (y, z)
        else:
            stages.append(("fft", 0, (0,)))
            stages.append(("transpose", 0, +1))
            stages.append(("fft", 1, (1,)))
            stages.append(("transpose", 1, +1))
            stages.append(("fft", 2, (2,)))
        return stages

    # -- execution -----------------------------------------------------------------

    def _fftn(self, x, axis, axes, inverse):
        """FFT along array dims ``axes`` of a pencil-``axis`` buffer."""
        if self.split_complex:
            from cudecomp_tpu.ops import mxu_fft
            return mxu_fft.fft_split_axes(x, axes, inverse=inverse)
        return _local_fft(self.complex_grid, axis, x,
                          "ifft" if inverse else "fft", axes)

    def forward(self, x):
        """Physical X-pencil -> spectral Z-pencil."""
        cgrid = self.complex_grid
        stages = self._stages()
        with self._policy(), trace_range("cudecomp_tpu.fft3d_forward"):
            first_fft = True
            for kind, a, *rest in stages:
                if kind == "fft":
                    if self.real and first_fft:
                        x = _rfft_stage(self, cgrid, x, rest[0])
                    else:
                        x = self._fftn(x, a, _fft_axes(cgrid, a, rest[0]),
                                       inverse=False)
                    first_fft = False
                else:
                    op = tr.transpose_x_to_y if a == 0 else tr.transpose_y_to_z
                    x = op(cgrid, x)
            return x

    def inverse(self, xh):
        """Spectral Z-pencil -> physical X-pencil."""
        cgrid = self.complex_grid
        stages = self._stages()
        with self._policy(), trace_range("cudecomp_tpu.fft3d_inverse"):
            x = xh
            rev = list(reversed(stages))
            last_fft_idx = max(i for i, s in enumerate(rev) if s[0] == "fft")
            for i, (kind, a, *rest) in enumerate(rev):
                if kind == "fft":
                    if self.real and i == last_fft_idx:
                        x = _irfft_stage(self, cgrid, x, rest[0])
                    else:
                        x = self._fftn(x, a, _fft_axes(cgrid, a, rest[0]),
                                       inverse=True)
                else:
                    op = tr.transpose_y_to_x if a == 0 else tr.transpose_z_to_y
                    x = op(cgrid, x)
            return x

    # -- plane form (split_complex only) --------------------------------------------
    #
    # The matmul FFT's spectral format is a PAIR of real planes (re, im):
    # it contracts them directly, so chaining transforms through the
    # interleaved (..., 2) form pays a re-interleave (a concatenate fusion
    # + a layout copy).  Solvers that apply many transforms should carry
    # (r, i) between calls; transposes run per plane, so the pair never
    # materializes interleaved.

    def _require_planes(self):
        if not self.split_complex:
            raise ValueError("plane-form FFT requires split_complex=True")

    def forward_planes(self, x):
        """Plane-form forward.  c2c: ``x = (r, i)`` planes; r2c
        (``real=True``): ``x`` is the real X-pencil array.  Returns spectral
        Z-pencil planes ``(r, i)``."""
        self._require_planes()
        from cudecomp_tpu.ops import mxu_fft
        cgrid = self.complex_grid
        with self._policy(), trace_range("cudecomp_tpu.fft3d_forward"):
            first_fft = True
            planes = x if not self.real else None
            for kind, a, *rest in self._stages():
                if kind == "fft":
                    axes = _fft_axes(cgrid, a, rest[0])
                    if self.real and first_fft:
                        inv = self.grid.config.inv_mem_order(0)
                        planes = mxu_fft.rfft_planes(x, axis=inv[0])
                        other = [g for g in rest[0] if g != 0]
                        if other:
                            planes = mxu_fft.fft_planes(
                                *planes, _fft_axes(cgrid, 0, other),
                                inverse=False)
                    else:
                        planes = mxu_fft.fft_planes(*planes, axes,
                                                    inverse=False)
                    first_fft = False
                else:
                    op = tr.transpose_x_to_y if a == 0 else tr.transpose_y_to_z
                    planes = tuple(op(cgrid, p) for p in planes)
            return planes

    def inverse_planes(self, planes):
        """Plane-form inverse of :meth:`forward_planes`.  Takes spectral
        Z-pencil planes ``(r, i)``; returns ``(r, i)`` planes (c2c) or the
        real X-pencil array (``real=True``)."""
        self._require_planes()
        from cudecomp_tpu.ops import mxu_fft
        cgrid = self.complex_grid
        with self._policy(), trace_range("cudecomp_tpu.fft3d_inverse"):
            rev = list(reversed(self._stages()))
            last_fft_idx = max(i for i, s in enumerate(rev) if s[0] == "fft")
            for i, (kind, a, *rest) in enumerate(rev):
                if kind == "fft":
                    if self.real and i == last_fft_idx:
                        other = [g for g in rest[0] if g != 0]
                        if other:
                            planes = mxu_fft.fft_planes(
                                *planes, _fft_axes(cgrid, 0, other),
                                inverse=True)
                        inv = self.grid.config.inv_mem_order(0)
                        return mxu_fft.irfft_planes(
                            *planes, axis=inv[0], n=self.grid.config.gdims[0])
                    planes = mxu_fft.fft_planes(
                        *planes, _fft_axes(cgrid, a, rest[0]), inverse=True)
                else:
                    op = tr.transpose_y_to_x if a == 0 else tr.transpose_z_to_y
                    planes = tuple(op(cgrid, p) for p in planes)
            return planes


def _rfft_stage(plan, cgrid, x, global_axes):
    """First forward stage for R2C: rfft along X plus ffts over any other
    fused axes, mapping the real X-pencil buffer onto the complex grid's
    X-pencil buffer (padded-pencil format preserved)."""
    assert 0 in global_axes
    inv = plan.grid.config.inv_mem_order(0)
    x_dim = inv[0]
    if plan.split_complex:
        from cudecomp_tpu.ops import mxu_fft
        xh = mxu_fft.rfft_split(x, axis=x_dim)
    else:
        # the real and complex X-pencils share their Y/Z sharding
        xh = _local_fft(plan.grid, 0, x, "rfft", (x_dim,))
    # complex X-pencil buffer has X extent X//2+1 (same Y/Z decomposition)
    other = [a for a in global_axes if a != 0]
    if other:
        xh = plan._fftn(xh, 0, _fft_axes(cgrid, 0, other), inverse=False)
    return xh


def _irfft_stage(plan, cgrid, xh, global_axes):
    """Last inverse stage for C2R: inverse of :func:`_rfft_stage`."""
    assert 0 in global_axes
    other = [a for a in global_axes if a != 0]
    if other:
        xh = plan._fftn(xh, 0, _fft_axes(cgrid, 0, other), inverse=True)
    inv = plan.grid.config.inv_mem_order(0)
    x_dim = inv[0]
    n = plan.grid.config.gdims[0]
    if plan.split_complex:
        from cudecomp_tpu.ops import mxu_fft
        return mxu_fft.irfft_split(xh, axis=x_dim, n=n)
    return _local_fft(plan.grid, 0, xh, "irfft", (x_dim,), n=n)


def fft3d(grid, x, real: bool = False, split_complex: bool = False):
    """One-shot forward distributed FFT (see :class:`DistributedFFT`)."""
    return DistributedFFT(grid=grid, real=real,
                          split_complex=split_complex).forward(x)


def ifft3d(grid, xh, real: bool = False, split_complex: bool = False):
    """One-shot inverse distributed FFT."""
    return DistributedFFT(grid=grid, real=real,
                          split_complex=split_complex).inverse(xh)


# -- FFT plan autotuning ------------------------------------------------------


@dataclasses.dataclass
class FFTTrialRecord:
    precision: str
    gauss: bool
    err: float
    gate_passed: bool
    times_s: tuple
    avg_s: float


@dataclasses.dataclass
class FFTAutotuneResult:
    plan: "DistributedFFT"
    trials: list
    best_time_s: float

    def report(self) -> str:
        lines = ["CUDECOMP_TPU: FFT plan autotune (avg s | gate):"]
        for t in self.trials:
            status = (f"{t.avg_s:.6f} | err {t.err:.2e} "
                      f"{'PASS' if t.gate_passed else 'FAIL'}")
            lines.append(f"  precision={t.precision:8s} "
                         f"gauss={int(t.gauss)} {status}")
        lines.append(f"  -> selected precision={self.plan.precision} "
                     f"gauss={self.plan.gauss} ({self.best_time_s:.6f} s)")
        return "\n".join(lines)


def autotune_fft(grid, real: bool = False, *, candidates=None,
                 gate: float = 5e-4, n_warmup: int = 2, n_trials: int = 3,
                 iters: int = 8, seed: int = 0) -> FFTAutotuneResult:
    """Plan-time FFT policy search — the planner analog of the grid
    autotuner, productizing the gate-then-pick protocol ``bench.py`` runs
    by hand.

    For each candidate ``(precision, gauss)`` policy the plane-carried
    forward+inverse cycle is (a) gate-checked: one round trip on
    standard-normal data must return within ``gate`` max abs error — the
    reference benchmark's single-precision tolerance
    (``benchmark.cu:23-27``); (b) timed with the forced-completion scanned
    protocol.  The fastest gate-passing policy is pinned into the returned
    plan.  Trial times are cross-host reduced, so every process of a
    multi-controller deployment selects the same policy.

    Default candidates: ``("high", True)`` (reduced-precision f32 dots +
    Gauss — the fast policy wherever its error fits the gate) and
    ``("highest", True)`` (full-f32 — always gate-safe for f32 data).
    """
    import numpy as np
    from cudecomp_tpu import performance as perf
    from cudecomp_tpu.autotune import _allreduce_trials

    if candidates is None:
        candidates = (("high", True), ("highest", True))

    shape = grid.global_shape(0)
    # the raw threefry key (what PRNGKey(seed) holds) is built on the host
    # and placed on the grid's own devices: a plan for one mesh never
    # dispatches on the process default backend
    key = jax.device_put(np.asarray([0, seed], np.uint32),
                         jax.sharding.NamedSharding(
                             grid.mesh, jax.sharding.PartitionSpec()))
    # uneven decompositions carry padding slots the transpose pipeline
    # zeroes at repack; random data there would make every candidate
    # spuriously fail the gate, so the gate field is zero outside the
    # valid interior (the round trip then preserves those zeros)
    from cudecomp_tpu.utils.arrays import valid_interior_mask
    mask = None
    if shape != grid.config.gdims:
        mask = jax.device_put(
            valid_interior_mask(grid, 0).astype(np.float32),
            grid.sharding(0))

    def _masked(v):
        return v if mask is None else v * mask

    if real:
        x = jax.jit(lambda k: jax.random.normal(k, shape, jnp.float32),
                    out_shardings=grid.sharding(0))(key)
        data = _masked(x)
    else:
        ks = jax.random.split(key)
        mk = jax.jit(lambda k: jax.random.normal(k, shape, jnp.float32),
                     out_shardings=grid.sharding(0))
        data = (_masked(mk(ks[0])), _masked(mk(ks[1])))

    trials = []
    best = None  # (avg, plan)
    for prec, gauss in candidates:
        plan = DistributedFFT(grid=grid, real=real, split_complex=True,
                              precision=prec, gauss=gauss)

        def cycle(v, plan=plan):
            return plan.inverse_planes(plan.forward_planes(v))

        def gate_fn(v, plan=plan):
            out = cycle(v, plan)
            if real:
                return jnp.max(jnp.abs(out - v))
            return jnp.maximum(jnp.max(jnp.abs(out[0] - v[0])),
                               jnp.max(jnp.abs(out[1] - v[1])))

        try:
            err = float(jax.jit(gate_fn)(data))
            passed = bool(err < gate)
            if passed:
                times = _allreduce_trials(perf.time_scanned(
                    cycle, data, iters=iters, n_warmup=n_warmup,
                    n_trials=n_trials))
            else:
                times = ()
        except Exception:
            # a candidate that fails to compile/run must not abort the
            # search (the grid autotuner's candidate-skip rule)
            trials.append(FFTTrialRecord(prec, gauss, float("inf"), False,
                                         (), float("inf")))
            continue
        avg = float(np.mean(times)) if times else float("inf")
        trials.append(FFTTrialRecord(prec, gauss, err, passed,
                                     tuple(times), avg))
        if passed and (best is None or avg < best[0]):
            best = (avg, plan)

    if best is None:
        raise RuntimeError(
            "autotune_fft: no candidate policy passed the "
            f"{gate:g} round-trip gate: "
            + "; ".join(f"({t.precision},gauss={int(t.gauss)}) err={t.err:g}"
                        for t in trials))
    return FFTAutotuneResult(plan=best[1], trials=trials,
                             best_time_s=best[0])
