"""Spectral Poisson solver on the pencil decomposition.

Analog of the reference Fortran example (``examples/fortran/poisson/
poisson.f90``): solve lap(u) = f with periodic boundaries by forward 3D FFT,
division by -(kx^2 + ky^2 + kz^2) (zero mode pinned to 0), and inverse FFT.

The wavenumber-squared field is materialized once at plan time in the
spectral Z-pencil's padded layout (including the r2c halving of the X axis),
so the solve itself is a pure jittable pipeline:
forward -> scale -> inverse.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from cudecomp_tpu.grid import GridDescriptor
from cudecomp_tpu.ops.fft import DistributedFFT
from cudecomp_tpu.utils.tracing import trace_range


@dataclasses.dataclass(frozen=True)
class PoissonSolver:
    """Periodic Poisson solver: ``solve(f)`` returns u with lap(u) = f and
    zero mean.  Works in complex (default) or split-complex mode."""

    grid: GridDescriptor
    lengths: Tuple[float, float, float] = (2 * np.pi, 2 * np.pi, 2 * np.pi)
    real: bool = True
    split_complex: bool = False
    # init=False: dataclasses.replace() must NOT carry a populated cache
    # into a solver with different parameters (stale inverse-k^2 field)
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False, init=False)

    @property
    def plan(self) -> DistributedFFT:
        return DistributedFFT(grid=self.grid, real=self.real,
                              split_complex=self.split_complex)

    def _inv_k2(self):
        # built once per solver via the shared spectral operator library
        # (device-side; no host gather/scatter round trip); sign flipped:
        # solve() divides by -(|k|^2)
        cached = self._cache.get("inv_k2")
        if cached is not None:
            return cached
        from cudecomp_tpu.ops.spectral import SpectralOperators
        sops = SpectralOperators(plan=self.plan, lengths=self.lengths,
                                 dtype=np.float64)
        out = -sops.inv_k_squared()
        self._cache["inv_k2"] = out
        return out

    def _inv_symbol_fd(self):
        # spectral inverse of the DISCRETE 7-point Laplacian: the DFT
        # diagonalizes lap_h with per-axis eigenvalues
        # -(4/h_d^2) sin^2(k_d h_d / 2) (zero mode pinned), so one
        # forward/inverse pair solves the FD system EXACTLY — the target
        # solve_cg iterates toward, at FFT cost
        cached = self._cache.get("inv_fd")
        if cached is not None:
            return cached
        from cudecomp_tpu.ops.spectral import SpectralOperators
        import jax.numpy as _jnp
        sops = SpectralOperators(plan=self.plan, lengths=self.lengths,
                                 dtype=np.float64)
        kx, ky, kz = sops.wavenumbers()
        sym = None
        for k, (n, L) in zip((kx, ky, kz),
                             zip(self.grid.config.gdims, self.lengths)):
            h = L / n
            term = (4.0 / (h * h)) * _jnp.sin(k * h / 2.0) ** 2
            sym = term if sym is None else sym + term
        out = _jnp.where(sym > 0, -1.0 / _jnp.where(sym > 0, sym, 1.0), 0.0)
        self._cache["inv_fd"] = out
        return out

    def solve(self, f, discrete: bool = False):
        """f: X-pencil buffer on ``grid`` (real if ``real=True``).

        With ``discrete=True`` the spectral scale is the inverse symbol
        of the DISCRETE 7-point Laplacian instead of ``-1/|k|^2``: the
        result solves ``lap_h(u) = f`` exactly (what :meth:`solve_cg`
        iterates toward) in one forward/inverse FFT pair."""
        plan = self.plan
        inv_k2 = self._inv_symbol_fd() if discrete else self._inv_k2()
        # the scale field is built in float64; a float32 rhs keeps its
        # precision (no silent promotion of the spectral state)
        inv_k2 = inv_k2.astype(jnp.result_type(f.dtype, jnp.float32))
        with trace_range("cudecomp_tpu.poisson_solve"):
            if self.split_complex and self.real:
                # plane-carried: the spectral scale applies per plane, so
                # the (re, im) pair never interleaves
                rh, ih = plan.forward_planes(f)
                return plan.inverse_planes((rh * inv_k2, ih * inv_k2))
            fh = plan.forward(f)
            if self.split_complex:
                uh = fh * inv_k2[..., None]
            else:
                uh = fh * inv_k2
            return plan.inverse(uh)

    def solve_cg(self, f, tol: float = 1e-8, maxiter: int = 1000,
                 check_every: int = 64):
        """Matrix-free conjugate-gradient solve of the DISCRETE 7-point
        Poisson equation ``lap_h(u) = f`` (periodic, zero mean).

        For fully periodic grids ``solve(f, discrete=True)`` reaches the
        same discrete solution in ONE FFT pair (the DFT diagonalizes
        lap_h); CG remains the matvec-only path — the pattern for
        operators with no spectral diagonalization (varying
        coefficients, masked domains).

        The matvec is one fused ghost-plane stencil pass per iteration
        (:func:`cudecomp_tpu.laplacian7`) — the
        finite-difference counterpart of the spectral :meth:`solve`
        (their solutions differ by the FD truncation error O(h^2); on
        the discrete operator's own rhs the CG solution is exact to
        ``tol``).  CG is valid because the operator is symmetric (the
        same self-adjointness the stencil VJP relies on) and PSD on the
        mean-zero subspace.  Anisotropic spacings use a weighted 7-tap
        ``stencil_apply`` matvec (``1/h_d^2`` per dim); uniform spacings
        use ``laplacian7``.

        The convergence test runs once per ``check_every`` iterations.
        Eagerly-called solves drive the loop from the HOST over a jitted
        donated ``fori_loop`` chunk: one dispatch + one scalar fetch per
        ``check_every`` iterations with the state resident on device,
        and no data-dependent loop in the compiled program (whether an
        on-device ``lax.while_loop`` is faster on the GPU is an open
        measurement).
        Inside an enclosing ``jit`` the data-dependent loop must stay
        on-device, so the traced path keeps the chunked
        ``while_loop``.  Either way the solve may overshoot convergence
        by up to ``check_every - 1`` cheap iterations, and division
        guards keep a mid-chunk-converged state stationary (0/0 would
        otherwise NaN it).

        Returns ``(u, iters, rel_residual)`` (Python scalars when called
        eagerly).
        """
        from cudecomp_tpu.ops.stencil import laplacian7, stencil_apply
        cfg = self.grid.config
        hs = [self.lengths[d] / cfg.gdims[d] for d in range(3)]
        periods = (True, True, True)
        check_every = max(1, min(int(check_every), int(maxiter)))

        if np.allclose(hs, hs[0]):
            inv_h2 = 1.0 / (hs[0] * hs[0])

            def matvec(v):
                return (-inv_h2) * laplacian7(self.grid, v, 0, periods)
        else:
            # anisotropic 7-point weights, laid out in MEMORY order
            # (stencil offsets are memory-dim offsets)
            order = cfg.mem_order(0)
            w = np.zeros((3, 3, 3))
            for d in range(3):
                inv = 1.0 / (hs[order[d]] ** 2)
                idx_lo = [1, 1, 1]
                idx_hi = [1, 1, 1]
                idx_lo[d], idx_hi[d] = 0, 2
                w[tuple(idx_lo)] = w[tuple(idx_hi)] = inv
                w[1, 1, 1] -= 2.0 * inv
            w = -w  # matvec is -lap (PSD)

            def matvec(v):
                return stencil_apply(self.grid, v, w, 0, periods)

        def step(_, st):
            u, r, p, rs = st
            ap = matvec(p)
            denom = jnp.sum(p * ap)
            alpha = jnp.where(denom > 0, rs / jnp.where(denom > 0,
                                                        denom, 1.0), 0.0)
            u = u + alpha * p
            r = r - alpha * ap
            rs_new = jnp.sum(r * r)
            beta = jnp.where(rs > 0, rs_new / jnp.where(rs > 0, rs, 1.0),
                             0.0)
            return u, r, r + beta * p, rs_new

        with trace_range("cudecomp_tpu.poisson_solve_cg"):
            if isinstance(f, jax.core.Tracer):
                # on-device data-dependent loop (enclosing jit)
                b = -(f - jnp.mean(f))
                bnorm = jnp.sqrt(jnp.sum(b * b))

                def cond(state):
                    _, _, _, rs, it = state
                    return jnp.logical_and(it < maxiter,
                                           jnp.sqrt(rs) > tol * bnorm)

                def body(state):
                    u, r, p, rs, it = state
                    u, r, p, rs = jax.lax.fori_loop(0, check_every, step,
                                                    (u, r, p, rs))
                    return u, r, p, rs, it + check_every

                u0 = jnp.zeros_like(b)
                rs0 = jnp.sum(b * b)
                u, r, _, rs, it = jax.lax.while_loop(
                    cond, body, (u0, b, b, rs0, jnp.int32(0)))
                return u - jnp.mean(u), it, jnp.sqrt(rs) / bnorm

            # host-driven loop: cached jitted chunk with donated state
            key = ("cg", tuple(f.shape), str(f.dtype), check_every)
            fns = self._cache.get(key)
            if fns is None:
                @jax.jit
                def init(v):
                    b = -(v - jnp.mean(v))
                    rs0 = jnp.sum(b * b)
                    return (jnp.zeros_like(b), b, b, rs0), jnp.sqrt(rs0)

                import functools
                @functools.partial(jax.jit, donate_argnums=(0,))
                def chunk(state):
                    return jax.lax.fori_loop(0, check_every, step, state)

                @jax.jit
                def finish(u):
                    return u - jnp.mean(u)

                fns = (init, chunk, finish)
                self._cache[key] = fns
            init, chunk, finish = fns
            state, bnorm = init(f)
            bnorm_h = float(bnorm)
            it = 0
            rs_h = bnorm_h * bnorm_h  # rs0: reported when maxiter < 1
            while it < maxiter:
                state = chunk(state)
                it += check_every
                rs_h = float(state[3])
                if np.sqrt(rs_h) <= tol * bnorm_h:
                    break
            return (finish(state[0]), it,
                    float(np.sqrt(rs_h)) / max(bnorm_h, 1e-300))

    def jitted(self):
        """Return a jitted solve function with the spectral scale baked in."""
        plan = self.plan
        inv_k2 = self._inv_k2()

        @jax.jit
        def solve(f):
            inv_k2_f = inv_k2.astype(jnp.result_type(f.dtype, jnp.float32))
            if self.split_complex and self.real:
                rh, ih = plan.forward_planes(f)
                return plan.inverse_planes((rh * inv_k2_f, ih * inv_k2_f))
            fh = plan.forward(f)
            uh = fh * (inv_k2_f[..., None] if self.split_complex
                       else inv_k2_f)
            return plan.inverse(uh)

        return solve
