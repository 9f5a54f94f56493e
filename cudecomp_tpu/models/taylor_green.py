"""Taylor-Green vortex — pseudo-spectral incompressible Navier-Stokes solver.

Analog of the reference's flagship example (``examples/cc/taylor_green/
tg.cu``, 985 LoC, validated against van Rees et al. reference curves): a
Fourier pseudo-spectral solver for the incompressible NS equations in
rotational form on the pencil decomposition,

    du/dt = P(k) F[u x w] - nu k^2 u_hat        (spectral space)

with 2/3-rule dealiasing, RK4 time stepping, and the distributed r2c FFT
doing all the global data movement (every FFT hides the full
X->Y->Z transpose pipeline).  Velocity components ride the transpose
engine's trailing component dim, so one pipeline moves all three fields.

Diagnostics: kinetic energy and enstrophy-based dissipation, the quantities
the reference validates (``examples/cc/taylor_green/README.md:17-21``).
"""

from __future__ import annotations

import dataclasses
import numpy as np
import jax
import jax.numpy as jnp

from cudecomp_tpu.grid import GridDescriptor
from cudecomp_tpu.ops.fft import DistributedFFT
from cudecomp_tpu.ops.spectral import SpectralOperators
from cudecomp_tpu.utils.arrays import scatter_global
from cudecomp_tpu.utils.tracing import trace_range




def taylor_green_velocity(gdims):
    """Initial TG vortex on [0, 2*pi)^3 (tg.cu initialization)."""
    xs = [np.arange(n) * 2 * np.pi / n for n in gdims]
    x, y, z = np.meshgrid(*xs, indexing="ij")
    u = np.cos(x) * np.sin(y) * np.sin(z)
    v = -np.sin(x) * np.cos(y) * np.sin(z)
    w = np.zeros_like(u)
    return u, v, w


@dataclasses.dataclass(frozen=True)
class TaylorGreenSolver:
    """Set ``split_complex=True`` to run the whole solver on the matmul
    FFT with PLANE-FORM spectral state — a ``(re, im)`` tuple of real
    ``(..., 3)`` arrays — so no complex dtype support is needed and no
    interleave pass is paid anywhere in the RK4 loop (the
    (..., 2)-interleaved carry costs a concatenate + layout copy per
    transform chain)."""

    grid: GridDescriptor
    nu: float = 1.0 / 100.0  # 1/Re
    dealias: bool = True
    split_complex: bool = False
    #: integrate the viscous term exactly with exponential integrating
    #: factors (Rogallo-style IF-RK4) instead of carrying -nu k^2 u in the
    #: explicit RK4 right-hand side.  The explicit form (the reference
    #: solver's scheme, tg.cu:224-226) has a viscous stability limit
    #: nu |k|^2 dt <~ 2.8 that shrinks with N^2 — at 256^3, dt=0.01
    #: diverges in ~10 steps while 192^3 is stable; the IF form removes
    #: that limit entirely for the cost of two fused elementwise exp
    #: fields per step, leaving only the advective CFL (see cfl_dt).
    integrating_factor: bool = True

    # -- state helpers -----------------------------------------------------------
    # spectral state: complex array (..., 3), or ((..., 3), (..., 3)) planes

    def _t(self, fn, *xs):
        """Elementwise op over the state pytree (plain array or plane pair)."""
        return jax.tree_util.tree_map(fn, *xs)

    def setup(self):
        """Returns (spectral state uh, static fields dict).  uh has shape
        (..., 3) complex, or is a ((..., 3), (..., 3)) (re, im) plane pair
        in split-complex mode."""
        plan = DistributedFFT(grid=self.grid, real=True,
                              split_complex=self.split_complex)
        gd = self.grid.config.gdims
        u0 = taylor_green_velocity(gd)
        u = jnp.stack([scatter_global(self.grid, c, 0) for c in u0], axis=-1)
        if self.split_complex:
            u = u.astype(jnp.float32) if jax.default_backend() not in (
                "cpu",) else u
        uh = plan.forward_planes(u) if self.split_complex else plan.forward(u)
        # spectral calculus comes from the shared operator library; f64
        # host construction downcasts to f32 on runtimes without x64
        # (device_put), matching the velocity state's precision there
        sops = SpectralOperators(plan=plan, dtype=np.float64)
        # broadcast-form wavenumbers: a few KB each, so traced programs
        # that close over the fields dict embed kilobytes, not 3D fields;
        # k2 / inv_k2 / the dealias mask are derived IN-TRACE by the
        # solver methods (XLA fuses the broadcasts into their consumers)
        kx, ky, kz = sops.wavenumbers()
        fields = dict(kx=kx, ky=ky, kz=kz, plan=plan, sops=sops)
        return uh, fields

    def _mask(self, f):
        """Nonlinear-term spectral mask, built in-trace: the 2/3-rule
        dealias product (when enabled) with the k=0 mode zeroed (mean
        velocity is conserved)."""
        sops = f["sops"]
        k2 = sops.k_squared()
        live = k2 > 0
        if self.dealias:
            live = live & (sops.mask() > 0)
        return live.astype(k2.dtype)

    # -- spectral operators ----------------------------------------------------
    # velocity components live at index -1 of each plane / complex array;
    # curl / projection / dealiasing come from ops.spectral (the shared
    # operator library this solver's inline versions were promoted into)

    def _inverse(self, plan, xh):
        return (plan.inverse_planes(xh) if self.split_complex
                else plan.inverse(xh))

    def _curl_hat(self, uh, f):
        return f["sops"].curl(uh)

    def _project(self, nh, f):
        """Leray projection: nh - k (k . nh) / k^2."""
        return f["sops"].project_solenoidal(nh)

    def _nonlinear(self, uh, f):
        """Projected, dealiased nonlinear term u x omega (rotational form)."""
        plan: DistributedFFT = f["plan"]
        with trace_range("cudecomp_tpu.tg_nonlinear"):
            u = self._inverse(plan, uh)               # physical velocity
            wh = self._curl_hat(uh, f)
            w = self._inverse(plan, wh)               # physical vorticity
            nl = jnp.stack([
                u[..., 1] * w[..., 2] - u[..., 2] * w[..., 1],
                u[..., 2] * w[..., 0] - u[..., 0] * w[..., 2],
                u[..., 0] * w[..., 1] - u[..., 1] * w[..., 0],
            ], axis=-1)                               # u x w
            nh = (plan.forward_planes(nl) if self.split_complex
                  else plan.forward(nl))
            mask = self._mask(f)
            nh = self._t(lambda a: a * mask[..., None], nh)
            return self._project(nh, f)

    def _rhs(self, uh, f):
        """Full explicit right-hand side: nonlinear term + viscous term."""
        visc = f["sops"].k_squared()
        return self._t(lambda nn, uu: nn - self.nu * visc[..., None] * uu,
                       self._nonlinear(uh, f), uh)

    def step(self, uh, f, dt):
        """One RK4 step in spectral space.

        With ``integrating_factor`` (the default) the viscous term is
        integrated exactly by exponential factors (Rogallo IF-RK4) and
        only the nonlinear term enters the Runge-Kutta stages; otherwise
        the classic explicit RK4 on the full right-hand side (the
        reference solver's scheme, tg.cu:224-247)."""
        t = self._t
        if not self.integrating_factor:
            k1 = self._rhs(uh, f)
            k2_ = self._rhs(t(lambda u, k: u + 0.5 * dt * k, uh, k1), f)
            k3 = self._rhs(t(lambda u, k: u + 0.5 * dt * k, uh, k2_), f)
            k4 = self._rhs(t(lambda u, k: u + dt * k, uh, k3), f)
            return t(lambda u, a, b, c, d:
                     u + (dt / 6.0) * (a + 2 * b + 2 * c + d),
                     uh, k1, k2_, k3, k4)

        # IF-RK4: v = e^{nu k^2 t} u integrates dv/dt = e^{nu k^2 t} N(u);
        # E = half-step factor, E2 = E^2 the full step (constant fields of
        # the traced program; two fused elementwise exps)
        e = jnp.exp(-self.nu * f["sops"].k_squared()
                    * (0.5 * dt))[..., None]
        e2 = e * e
        n = lambda v: self._nonlinear(v, f)
        k1 = n(uh)
        k2_ = n(t(lambda u, k: e * (u + 0.5 * dt * k), uh, k1))
        k3 = n(t(lambda u, k: e * u + 0.5 * dt * k, uh, k2_))
        k4 = n(t(lambda u, k: e2 * u + dt * e * k, uh, k3))
        return t(lambda u, a, b, c, d:
                 e2 * u + (dt / 6.0) * (e2 * a + 2 * e * (b + c) + d),
                 uh, k1, k2_, k3, k4)

    def cfl_dt(self, uh, f, cfl: float = 0.4):
        """Advective CFL timestep: ``cfl * dx / max|u_i|`` — the reference
        solver's adaptive-dt rule (``tg.cu:759-772``; its CLI ``--cfl``).
        With ``integrating_factor`` this is the ONLY stability constraint;
        the explicit scheme additionally needs ``nu |k|^2_max dt <~ 2.8``."""
        u = self._inverse(f["plan"], uh)
        velmax = jnp.max(jnp.abs(u))
        dx = 2.0 * np.pi / max(self.grid.config.gdims)
        return cfl * dx / jnp.maximum(velmax, 1e-30)

    # -- diagnostics -------------------------------------------------------------

    def energy(self, uh, f):
        """Kinetic energy 0.5 <|u|^2> (padding is zero, so plain sums work)."""
        u = self._inverse(f["plan"], uh)
        n = float(np.prod(self.grid.config.gdims))
        return 0.5 * jnp.sum(u * u) / n

    def enstrophy(self, uh, f):
        w = self._inverse(f["plan"], self._curl_hat(uh, f))
        n = float(np.prod(self.grid.config.gdims))
        return 0.5 * jnp.sum(w * w) / n

    def dissipation(self, uh, f):
        """Energy dissipation rate 2 nu * enstrophy (validated curve in the
        reference's data files)."""
        return 2.0 * self.nu * self.enstrophy(uh, f)

    def spectrum(self, uh, f, nbins: int = None):
        """Shell-averaged kinetic-energy spectrum ``E(k)``.

        Bins spectral KE density into integer-``|k|`` shells
        (``k`` in units of the fundamental, domain ``(2*pi)^3``), with
        the r2c half-spectrum multiplicity (2 for interior ``kx``
        planes, 1 for the ``kx=0`` and Nyquist planes).  Parseval-
        consistent: ``sum(E) == energy(uh)`` to roundoff (padded layout
        zones hold zero energy so their shell indices are harmless).
        The standard turbulence diagnostic alongside the reference's
        energy/dissipation curves (``tg.cu`` outputs;
        ``docs/tg_validation.md``)."""
        return f["sops"].shell_spectrum(uh, nbins=nbins, comp=True)

    def run(self, n_steps: int, dt: float):
        """Convenience driver returning (final uh, energy history)."""
        uh, f = self.setup()

        step = jax.jit(lambda s: self.step(s, f, dt))
        energy = jax.jit(lambda s: self.energy(s, f))

        history = [float(energy(uh))]
        for _ in range(n_steps):
            uh = step(uh)
            history.append(float(energy(uh)))
        return uh, history
