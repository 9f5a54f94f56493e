"""Spectral operator library on the distributed FFT's Z-pencil layout.

The reference ships its spectral machinery inline in the example solvers
(curl / projection / wavenumber setup hand-rolled per app,
``examples/cc/taylor_green/tg.cu``, ``examples/fortran/poisson/
poisson.f90``); every pseudo-spectral cuDecomp user rebuilds the same
operators on top of cuFFT.  Here they are a first-class, tested surface:
wavenumber fields, per-axis derivatives, gradient / divergence / curl /
Laplacian, and 2/3-rule dealiasing — all operating directly on a
:class:`~cudecomp_tpu.ops.fft.DistributedFFT` plan's spectral state in
either convention:

- complex arrays (``split_complex=False``), or
- plane-carried ``(re, im)`` pairs of real arrays — the matmul FFT's
  format (no complex dtype support needed; no interleave passes).

Vector fields stack components on the LAST axis (``(..., 3)``), matching
the Taylor–Green solver's state convention.

All operators are elementwise multiplies by precomputed wavenumber fields
in the spectral Z-pencil layout — they jit, differentiate, and fuse into
surrounding spectral pipelines (XLA folds the ``i k`` multiply into
adjacent contractions).  The wavenumber construction itself is host-side
numpy, built once per :class:`SpectralOperators` and cached.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from cudecomp_tpu.ops.fft import DistributedFFT
from cudecomp_tpu.utils.arrays import scatter_global


def _axis_wavenumbers(plan: DistributedFFT, lengths):
    """Host-side per-axis wavenumber vectors of the plan's spectral grid
    (r2c halving applied to axis 0 when the plan is real)."""
    gd = plan.grid.config.gdims
    ks = []
    for d in range(3):
        n = gd[d]
        k = np.fft.fftfreq(n, d=1.0 / n) * (2.0 * np.pi / lengths[d])
        if plan.real and d == 0:
            k = k[: n // 2 + 1]
        ks.append(k)
    return ks


def wavenumber_fields(plan: DistributedFFT,
                      lengths=(2 * math.pi,) * 3,
                      dtype=None) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Device ``(kx, ky, kz)`` fields in the plan's spectral Z-pencil
    layout (sharded over the plan's mesh; broadcast against spectral
    state).  ``lengths`` are the physical domain lengths per axis
    (``2*pi`` gives unit wavenumber spacing)."""
    cgrid = plan.complex_grid
    ks = _axis_wavenumbers(plan, lengths)
    kx, ky, kz = np.meshgrid(*ks, indexing="ij")
    dt = np.dtype(dtype) if dtype is not None else np.float64
    return tuple(scatter_global(cgrid, a.astype(dt), 2)
                 for a in (kx, ky, kz))


def _padded_axis_vector(cgrid, values: np.ndarray, g: int) -> np.ndarray:
    """Lay a per-global-index vector out along global axis ``g`` of the
    spectral Z-pencil's padded SPMD format: per-shard ``[valid | zero
    tail]`` blocks concatenated in shard order — the 1D twin of what
    :func:`~cudecomp_tpu.utils.arrays.scatter_global` does per shard, so
    a broadcast against padded-pencil state lines k values up with the
    valid region of every shard (padding rows multiply the state's zero
    tails, which stay zero)."""
    from cudecomp_tpu import geometry
    cfg = cgrid.config
    order = cfg.mem_order(2)
    i = order.index(g)
    local = geometry.pencil_buffer_shape(cfg, 2, None, None)[i]
    pd = geometry.shard_pdim_of_dim(2, g)
    nshards = cfg.pdims[pd] if pd is not None else 1
    out = np.zeros(local * nshards, dtype=values.dtype)
    for s in range(nshards):
        pidx = (s, 0) if pd == 0 else ((0, s) if pd == 1 else (0, 0))
        pinfo = geometry.get_pencil_info(cfg, 2, pidx, None, None)
        lo, hi = pinfo.lo_g[g], pinfo.hi_g[g]
        out[s * local: s * local + (hi - lo + 1)] = values[lo: hi + 1]
    return out


def _replicated(grid, host_array):
    """Place a small host array replicated over every device of the grid's
    mesh (eager operators then run on the mesh, not the default device)."""
    return jax.device_put(host_array, jax.sharding.NamedSharding(
        grid.mesh, jax.sharding.PartitionSpec()))


def wavenumber_broadcasts(plan: DistributedFFT,
                          lengths=(2 * math.pi,) * 3,
                          dtype=None) -> Tuple[jax.Array, jax.Array,
                                               jax.Array]:
    """``(kx, ky, kz)`` as BROADCAST-SHAPED arrays: each has its padded
    extent along the Z-pencil array dim of its global axis and 1
    elsewhere.

    The compact form of the wavenumber fields: a few KB of per-axis
    vectors instead of three materialized 3D fields, so (a) traced
    programs that close over them embed kilobytes of constants, not
    hundreds of MB, and (b) XLA fuses the broadcast into the consumer
    instead of streaming full |k|-field reads from device memory.
    The vectors are replicated over the plan's mesh, never left on the
    process default device.
    Broadcasting against spectral state reproduces
    :func:`wavenumber_fields` semantics exactly (padded layout
    included)."""
    cgrid = plan.complex_grid
    ks = _axis_wavenumbers(plan, lengths)
    order = cgrid.config.mem_order(2)
    dt = np.dtype(dtype) if dtype is not None else np.float64
    out = []
    for g in range(3):
        vec = _padded_axis_vector(cgrid, ks[g].astype(dt), g)
        shape = [1, 1, 1]
        shape[order.index(g)] = len(vec)
        out.append(_replicated(cgrid, vec.reshape(shape)))
    return tuple(out)


def dealias_axis_broadcasts(plan: DistributedFFT,
                            fraction: float = 2.0 / 3.0,
                            lengths=(2 * math.pi,) * 3,
                            dtype=None):
    """Per-axis dealias indicator vectors in broadcast form; their
    product is the sharp 2/3-rule mask of :func:`dealias_mask`."""
    cgrid = plan.complex_grid
    gd = plan.grid.config.gdims
    ks = _axis_wavenumbers(plan, lengths)
    order = cgrid.config.mem_order(2)
    dt = np.dtype(dtype) if dtype is not None else np.float64
    out = []
    for g in range(3):
        cut = fraction * (gd[g] // 2) * (2.0 * np.pi / lengths[g])
        ind = (np.abs(ks[g]) < cut).astype(dt)
        vec = _padded_axis_vector(cgrid, ind, g)
        shape = [1, 1, 1]
        shape[order.index(g)] = len(vec)
        out.append(_replicated(cgrid, vec.reshape(shape)))
    return tuple(out)


def dealias_mask(plan: DistributedFFT, fraction: float = 2.0 / 3.0,
                 lengths=(2 * math.pi,) * 3, dtype=None) -> jax.Array:
    """Sharp spherical-by-axis cutoff mask (the 2/3 rule by default): 1
    where ``|k_d| < fraction * (N_d/2) * (2*pi/L_d)`` on every axis, 0
    outside — the classic pseudo-spectral antialiasing filter
    (``tg.cu`` applies the same rule inline)."""
    cgrid = plan.complex_grid
    gd = plan.grid.config.gdims
    ks = _axis_wavenumbers(plan, lengths)
    kx, ky, kz = np.meshgrid(*ks, indexing="ij")
    mask = np.ones(kx.shape, dtype=bool)
    for k, n, L in zip((kx, ky, kz), gd, lengths):
        mask &= np.abs(k) < fraction * (n // 2) * (2.0 * np.pi / L)
    dt = np.dtype(dtype) if dtype is not None else np.float64
    return scatter_global(cgrid, mask.astype(dt), 2)


@dataclasses.dataclass(frozen=True)
class SpectralOperators:
    """Planned spectral calculus over a :class:`DistributedFFT`.

    Operators take and return SPECTRAL state in the plan's convention —
    complex arrays, or ``(re, im)`` plane pairs when the plan is
    ``split_complex`` — with vector components stacked on the last axis.

    The wavenumber fields are tiny per-axis BROADCAST vectors (padded
    Z-pencil layout, cached on the instance); |k|^2-style combinations
    are built per call so traced consumers fuse them instead of
    streaming materialized 3D fields from HBM — and traced programs
    that close over an instance serialize kilobytes, not fields.
    ``dtype`` defaults to float32 for split-complex plans (the matmul
    FFT's native precision) and float64 otherwise.
    """

    plan: DistributedFFT
    lengths: Tuple[float, float, float] = (2 * math.pi,) * 3
    dtype: object = None
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False, init=False)

    # -- cached fields -----------------------------------------------------------

    def _dtype(self):
        if self.dtype is not None:
            return np.dtype(self.dtype)
        return np.dtype(np.float32 if self.plan.split_complex
                        else np.float64)

    def wavenumbers(self):
        """``(kx, ky, kz)`` in broadcast form: each has its padded extent
        along its own Z-pencil array dim and 1 elsewhere (a few KB, not
        three 3D fields).  Broadcasting against spectral state reproduces
        the materialized-field semantics exactly; inside traced code XLA
        fuses the broadcast into the consumer, and programs that close
        over these embed kilobytes instead of hundreds of MB."""
        got = self._cache.get("k")
        if got is None:
            got = wavenumber_broadcasts(self.plan, self.lengths,
                                        dtype=self._dtype())
            self._cache["k"] = got
        return got

    def k_squared(self):
        """``|k|^2``, built per call from the broadcast wavenumbers so
        traced consumers fuse it (evaluating it eagerly materializes the
        full field, the pre-r5 behavior)."""
        kx, ky, kz = self.wavenumbers()
        return kx * kx + ky * ky + kz * kz

    def inv_k_squared(self):
        """``1/|k|^2`` with the zero mode pinned to 0 (the Leray /
        Poisson scaling field), built per call from the broadcast
        wavenumbers (fused in traced pipelines)."""
        k2 = self.k_squared()
        return jnp.where(k2 > 0, 1.0 / jnp.where(k2 > 0, k2, 1.0), 0.0)

    def mask(self, fraction: float = 2.0 / 3.0):
        """Dealias mask for ``fraction``: the product of cached per-axis
        broadcast indicator vectors (fused in traced pipelines)."""
        got = self._cache.get(("mask_axes", fraction))
        if got is None:
            got = dealias_axis_broadcasts(self.plan, fraction, self.lengths,
                                          dtype=self._dtype())
            self._cache[("mask_axes", fraction)] = got
        mx, my, mz = got
        return mx * my * mz

    # -- state algebra -----------------------------------------------------------
    # spectral scalar state: complex array, or (re, im) pair of real arrays

    def _split(self) -> bool:
        return self.plan.split_complex

    def _t(self, fn, *xs):
        return jax.tree_util.tree_map(fn, *xs)

    def _mul_i(self, s):
        """``i * s`` on spectral state."""
        if self._split():
            return (-s[1], s[0])
        return 1j * s

    def _kmul(self, k, s, comp: bool = False):
        """Real field ``k`` times state ``s`` (``comp=True`` when ``s``
        carries a trailing component axis the ``k`` field must broadcast
        over)."""
        kk = k[..., None] if comp else k
        return self._t(lambda a: kk * a, s)

    def _comp(self, vh, c: int):
        return self._t(lambda a: a[..., c], vh)

    def _stack(self, comps):
        if self._split():
            return tuple(jnp.stack([c[j] for c in comps], axis=-1)
                         for j in (0, 1))
        return jnp.stack(comps, axis=-1)

    # -- operators ---------------------------------------------------------------

    def derivative(self, sh, axis: int, order: int = 1):
        """``(d/dx_axis)^order`` of scalar spectral state: multiply by
        ``(i k_axis)^order``."""
        k = self.wavenumbers()[axis]
        out = self._kmul(jnp.asarray(k) ** order, sh)
        for _ in range(order % 4):
            out = self._mul_i(out)
        return out

    def gradient(self, sh):
        """Scalar spectral state -> ``(..., 3)`` vector spectral state."""
        ks = self.wavenumbers()
        return self._stack([self._mul_i(self._kmul(ks[d], sh))
                            for d in range(3)])

    def divergence(self, vh):
        """``(..., 3)`` vector spectral state -> scalar spectral state."""
        ks = self.wavenumbers()
        add = lambda a, b: self._t(jnp.add, a, b)
        acc = None
        for d in range(3):
            term = self._kmul(ks[d], self._comp(vh, d))
            acc = term if acc is None else add(acc, term)
        return self._mul_i(acc)

    def curl(self, vh):
        """``(..., 3)`` vector spectral state -> ``(..., 3)`` curl."""
        kx, ky, kz = self.wavenumbers()
        sub = lambda a, b: self._t(jnp.subtract, a, b)
        v0, v1, v2 = (self._comp(vh, c) for c in range(3))
        wx = sub(self._kmul(ky, v2), self._kmul(kz, v1))
        wy = sub(self._kmul(kz, v0), self._kmul(kx, v2))
        wz = sub(self._kmul(kx, v1), self._kmul(ky, v0))
        return self._stack([self._mul_i(w) for w in (wx, wy, wz)])

    def laplacian(self, sh, comp: bool = False):
        """``lap = -|k|^2`` on scalar (or, with ``comp=True``, per-component
        vector) spectral state."""
        return self._kmul(-self.k_squared(), sh, comp=comp)

    def dealias(self, sh, fraction: float = 2.0 / 3.0, comp: bool = False):
        """Apply the sharp 2/3-rule mask to spectral state."""
        return self._kmul(self.mask(fraction), sh, comp=comp)

    def shell_spectrum(self, sh, nbins: int = None, comp: bool = False):
        """Shell-summed power spectrum ``E(k)`` of spectral state.

        Bins ``0.5 |sh|^2 / N^2`` (Parseval density for the unnormalized
        forward transform) into integer shells of ``|k| / k_min`` where
        ``k_min`` is the smallest axis fundamental — for the default
        ``2*pi`` cubes that is integer-``|k|`` shells.  Real (r2c) plans
        apply the half-spectrum multiplicity (2 for interior ``k_x``
        planes, 1 for the ``k_x = 0`` and Nyquist planes), so
        ``sum(E) == 0.5 * mean(|u|^2)`` to roundoff.  With ``comp=True``
        the trailing component axis is summed first (vector fields).
        The standard turbulence diagnostic the reference's Taylor-Green
        example reports alongside energy/dissipation (``tg.cu`` outputs).
        """
        gd = self.plan.grid.config.gdims
        k_min = min(2.0 * np.pi / L for L in self.lengths)
        if nbins is None:
            # largest shell index: |k_max| / k_min, with per-axis
            # fundamentals — on anisotropic domains the max shell exceeds
            # the isotropic sqrt(sum((g//2)^2)) estimate and segment_sum
            # would silently drop those modes
            kmax2 = sum(((g // 2) * 2.0 * np.pi / L) ** 2
                        for g, L in zip(gd, self.lengths))
            nbins = int(np.ceil(np.sqrt(kmax2) / k_min)) + 2
        kx = self.wavenumbers()[0]
        k2 = self.k_squared()
        shell = jnp.round(jnp.sqrt(k2) / k_min).astype(jnp.int32)
        if self.plan.real:
            # half-spectrum multiplicity: every retained interior k_x
            # plane stands for its conjugate partner (mult 2) except the
            # self-conjugate k_x = 0 plane and — only when gdims[0] is
            # even — the Nyquist plane
            mult = jnp.where(kx == 0, 1.0, 2.0)
            if gd[0] % 2 == 0:
                nyq = (gd[0] // 2) * (2.0 * np.pi / self.lengths[0])
                mult = jnp.where(jnp.abs(kx) == nyq, 1.0, mult)
        else:
            mult = jnp.ones_like(k2)
        if self._split():
            e = sh[0] * sh[0] + sh[1] * sh[1]
        else:
            e = jnp.abs(sh) ** 2
        if comp:
            e = jnp.sum(e, axis=-1)
        n3 = float(np.prod(gd))
        dens = 0.5 * mult * e / (n3 * n3)
        return jax.ops.segment_sum(dens.ravel(), shell.ravel(),
                                   num_segments=nbins)

    def project_solenoidal(self, vh):
        """Leray projection ``v - k (k . v)/|k|^2``: removes the
        compressible part of a ``(..., 3)`` vector spectral state (the
        pressure projection of incompressible pseudo-spectral solvers;
        ``tg.cu`` inlines the same operator)."""
        kx, ky, kz = self.wavenumbers()
        inv_k2 = self.inv_k_squared()
        add = lambda a, b: self._t(jnp.add, a, b)
        sub = lambda a, b: self._t(jnp.subtract, a, b)
        v0, v1, v2 = (self._comp(vh, c) for c in range(3))
        div = add(add(self._kmul(kx, v0), self._kmul(ky, v1)),
                  self._kmul(kz, v2))
        s = self._kmul(inv_k2, div)
        return self._stack([sub(v0, self._kmul(kx, s)),
                            sub(v1, self._kmul(ky, s)),
                            sub(v2, self._kmul(kz, s))])
