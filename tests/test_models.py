"""Example applications: Poisson solver vs analytic solution; Taylor-Green
solver vs an independent single-process numpy implementation of the same
scheme (the analog of the reference's solver validation,
examples/cc/taylor_green/README.md:17-21)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import cudecomp_tpu as cd
from cudecomp_tpu.config import GridConfig
from cudecomp_tpu.models import PoissonSolver, TaylorGreenSolver
from cudecomp_tpu.models.taylor_green import taylor_green_velocity


def make_grid_for(gdims, pdims, **kw):
    cfg = GridConfig(gdims=gdims, pdims=pdims, **kw)
    return cd.make_grid(cfg, devices=jax.devices()[: pdims[0] * pdims[1]])


@pytest.mark.parametrize("pdims", [(2, 2), (1, 4)])
def test_poisson_analytic(pdims):
    # u = sin(x) cos(2y) sin(3z)  =>  lap(u) = -(1+4+9) u
    n = 16
    grid = make_grid_for((n, n, n), pdims)
    xs = [np.arange(n) * 2 * np.pi / n] * 3
    x, y, z = np.meshgrid(*xs, indexing="ij")
    u_exact = np.sin(x) * np.cos(2 * y) * np.sin(3 * z)
    f = -14.0 * u_exact
    solver = PoissonSolver(grid=grid)
    fb = cd.scatter_global(grid, f, 0)
    u = solver.solve(fb)
    np.testing.assert_allclose(cd.gather_global(grid, u, 0), u_exact,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("pdims", [(2, 4), (1, 1)])
def test_poisson_cg_exact_on_discrete_rhs(pdims):
    # build the rhs FROM the discrete operator: the CG solve is then exact
    # to its tolerance (no FD truncation in the oracle)
    n = 16
    grid = make_grid_for((n, n, n), pdims)
    rng = np.random.default_rng(11)
    u_true = rng.standard_normal((n, n, n))
    u_true -= u_true.mean()
    ub = cd.scatter_global(grid, u_true, 0)
    solver = PoissonSolver(grid=grid)
    h2 = (2 * np.pi / n) ** 2
    fb = cd.laplacian7(grid, ub, 0, (True, True, True)) / h2
    u, iters, rel = jax.jit(
        lambda v: solver.solve_cg(v, tol=1e-10, maxiter=2000))(fb)
    assert float(rel) < 1e-9
    assert 0 < int(iters) < 2000
    np.testing.assert_allclose(np.asarray(cd.gather_global(grid, u, 0)),
                               u_true, rtol=0, atol=1e-7)


def test_poisson_cg_matches_spectral_to_truncation():
    # on a smooth analytic rhs the CG (FD) and spectral solutions agree to
    # O(h^2) truncation
    n = 32
    grid = make_grid_for((n, n, n), (2, 2))
    xs = [np.arange(n) * 2 * np.pi / n] * 3
    x, y, z = np.meshgrid(*xs, indexing="ij")
    u_exact = np.sin(x) * np.cos(2 * y) * np.sin(3 * z)
    f = -14.0 * u_exact
    solver = PoissonSolver(grid=grid)
    fb = cd.scatter_global(grid, f, 0)
    u, iters, rel = solver.solve_cg(fb, tol=1e-10, maxiter=4000)
    err = float(np.max(np.abs(np.asarray(
        cd.gather_global(grid, u, 0)) - u_exact)))
    # second-order FD at n=32: relative error ~ (k_max h)^2 / 12 ~ 3e-2
    assert err < 5e-2, err
    assert float(rel) < 1e-9


def test_poisson_cg_anisotropic():
    # anisotropic spacings: build the rhs from the anisotropic discrete
    # operator so the CG solve is exact to tolerance
    n = 16
    lengths = (2 * np.pi, np.pi, 4 * np.pi)
    grid = make_grid_for((n, n, n), (2, 2))
    solver = PoissonSolver(grid=grid, lengths=lengths)
    rng = np.random.default_rng(12)
    u_true = rng.standard_normal((n, n, n))
    u_true -= u_true.mean()
    ub = cd.scatter_global(grid, u_true, 0)
    w = np.zeros((3, 3, 3))
    for d in range(3):
        inv = 1.0 / (lengths[d] / n) ** 2
        lo, hi = [1, 1, 1], [1, 1, 1]
        lo[d], hi[d] = 0, 2
        w[tuple(lo)] = w[tuple(hi)] = inv
        w[1, 1, 1] -= 2.0 * inv
    fb = cd.stencil_apply(grid, ub, w, 0, (True, True, True))
    u, iters, rel = solver.solve_cg(fb, tol=1e-10, maxiter=4000)
    assert float(rel) < 1e-9
    np.testing.assert_allclose(np.asarray(cd.gather_global(grid, u, 0)),
                               u_true, rtol=0, atol=1e-6)


def test_poisson_split_complex_plane_path():
    # split_complex + real takes the plane-carried spectral path; it must
    # match the complex-mode solution and the analytic field
    n = 16
    grid = make_grid_for((n, n, n), (2, 2))
    xs = [np.arange(n) * 2 * np.pi / n] * 3
    x, y, z = np.meshgrid(*xs, indexing="ij")
    u_exact = np.sin(x) * np.cos(2 * y) * np.sin(3 * z)
    f = -14.0 * u_exact
    fb = cd.scatter_global(grid, f, 0)
    u_sc = PoissonSolver(grid=grid, split_complex=True).solve(fb)
    np.testing.assert_allclose(np.asarray(cd.gather_global(grid, u_sc, 0)),
                               u_exact, rtol=0, atol=1e-10)
    u_c = PoissonSolver(grid=grid).jitted()(fb)
    u_sc_j = PoissonSolver(grid=grid, split_complex=True).jitted()(fb)
    np.testing.assert_allclose(np.asarray(u_sc_j), np.asarray(u_c),
                               rtol=0, atol=1e-10)


def test_poisson_jitted_and_uneven():
    n = (12, 10, 14)
    grid = make_grid_for(n, (2, 2))
    rng = np.random.default_rng(3)
    f = rng.standard_normal(n)
    f -= f.mean()  # solvability
    solver = PoissonSolver(grid=grid)
    u = np.asarray(cd.gather_global(grid, solver.jitted()(
        cd.scatter_global(grid, f, 0)), 0))
    # residual check: lap(u) == f (spectrally, via numpy)
    ks = [np.fft.fftfreq(m, d=1.0 / m) for m in n]
    kx, ky, kz = np.meshgrid(*ks, indexing="ij")
    lap = np.fft.ifftn(-(kx**2 + ky**2 + kz**2) * np.fft.fftn(u)).real
    np.testing.assert_allclose(lap, f, rtol=0, atol=1e-10)


def _numpy_tg_reference(gdims, nu, dt, n_steps):
    """Independent single-process implementation of the identical scheme."""
    u0 = np.stack(taylor_green_velocity(gdims), axis=-1)
    ks = [np.fft.fftfreq(m, d=1.0 / m) for m in gdims]
    kx, ky, kz = np.meshgrid(*ks, indexing="ij")
    k2 = kx**2 + ky**2 + kz**2
    inv_k2 = np.where(k2 > 0, 1.0 / np.where(k2 > 0, k2, 1), 0.0)
    mask = np.ones(gdims, dtype=bool)
    for k, m in ((kx, gdims[0]), (ky, gdims[1]), (kz, gdims[2])):
        mask &= np.abs(k) < (m // 2) * (2.0 / 3.0)
    mask = (mask & (k2 > 0)).astype(float)

    def fftv(u):
        return np.stack([np.fft.fftn(u[..., c]) for c in range(3)], axis=-1)

    def ifftv(uh):
        return np.stack([np.fft.ifftn(uh[..., c]).real for c in range(3)],
                        axis=-1)

    def curl(uh):
        return np.stack([
            1j * (ky * uh[..., 2] - kz * uh[..., 1]),
            1j * (kz * uh[..., 0] - kx * uh[..., 2]),
            1j * (kx * uh[..., 1] - ky * uh[..., 0])], axis=-1)

    def rhs(uh):
        u = ifftv(uh)
        w = ifftv(curl(uh))
        nl = np.stack([
            u[..., 1] * w[..., 2] - u[..., 2] * w[..., 1],
            u[..., 2] * w[..., 0] - u[..., 0] * w[..., 2],
            u[..., 0] * w[..., 1] - u[..., 1] * w[..., 0]], axis=-1)
        nh = fftv(nl) * mask[..., None]
        div = kx * nh[..., 0] + ky * nh[..., 1] + kz * nh[..., 2]
        s = div * inv_k2
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


@pytest.mark.parametrize("pdims", [(2, 2), (1, 4)])
def test_taylor_green_matches_numpy_reference(pdims):
    gd = (16, 16, 16)
    nu, dt, n_steps = 0.01, 0.01, 3
    grid = make_grid_for(gd, pdims)
    # explicit RK4: the scheme the numpy reference implements
    solver = TaylorGreenSolver(grid=grid, nu=nu, integrating_factor=False)
    _, history = solver.run(n_steps, dt)
    ref = _numpy_tg_reference(gd, nu, dt, n_steps)
    np.testing.assert_allclose(history, ref, rtol=1e-10)
    # TG energy must decay monotonically at these parameters
    assert all(b < a for a, b in zip(history, history[1:]))


def test_taylor_green_divergence_free():
    gd = (16, 16, 16)
    grid = make_grid_for(gd, (2, 2))
    solver = TaylorGreenSolver(grid=grid, nu=0.01)
    uh, f = solver.setup()
    for _ in range(2):
        uh = solver.step(uh, f, 0.01)
    div = (f["kx"] * uh[..., 0] + f["ky"] * uh[..., 1]
           + f["kz"] * uh[..., 2])
    assert float(jnp.max(jnp.abs(div))) < 1e-10

@pytest.mark.parametrize("split_complex", [False, True])
def test_taylor_green_spectrum(split_complex):
    gd = (16, 16, 16)
    grid = make_grid_for(gd, (2, 2))
    solver = TaylorGreenSolver(grid=grid, nu=0.01,
                               split_complex=split_complex)
    uh, f = solver.setup()
    ek = np.asarray(solver.spectrum(uh, f))
    # Parseval: the shells sum to the total kinetic energy
    e_tot = float(solver.energy(uh, f))
    np.testing.assert_allclose(float(ek.sum()), e_tot, rtol=1e-6)
    # the TG initial condition is a single |k|^2 = 3 mode family:
    # all energy sits in the round(sqrt(3)) = 2 shell
    assert ek[2] > 0.999 * e_tot
    others = ek.sum() - ek[2]
    assert others < 1e-3 * e_tot
    # after a few steps the cascade populates higher shells, energy
    # stays Parseval-consistent
    for _ in range(3):
        uh = solver.step(uh, f, 0.01)
    ek2 = np.asarray(solver.spectrum(uh, f))
    np.testing.assert_allclose(float(ek2.sum()),
                               float(solver.energy(uh, f)), rtol=1e-6)
    assert ek2[2] < ek2.sum()  # some energy left the initial shell


def test_taylor_green_split_complex_matches_complex():
    gd = (16, 16, 16)
    grid = make_grid_for(gd, (2, 2))
    nu, dt, n_steps = 0.01, 0.01, 2
    _, hist_c = TaylorGreenSolver(grid=grid, nu=nu).run(n_steps, dt)
    _, hist_sc = TaylorGreenSolver(grid=grid, nu=nu,
                                   split_complex=True).run(n_steps, dt)
    np.testing.assert_allclose(hist_sc, hist_c, rtol=1e-10)


def test_poisson_cache_not_shared_across_replace():
    # dataclasses.replace must not carry a populated inv_k2 cache into a
    # solver with different parameters (stale wavenumbers)
    import dataclasses
    import numpy as np
    from cudecomp_tpu.models.poisson import PoissonSolver
    import cudecomp_tpu as cd
    import jax

    grid = cd.make_grid(cd.GridConfig(gdims=(8, 8, 8), pdims=(2, 2)),
                        devices=jax.devices()[:4])
    s1 = PoissonSolver(grid=grid)
    k1 = np.asarray(jax.device_get(s1._inv_k2()))
    s2 = dataclasses.replace(s1, lengths=(4 * np.pi,) * 3)
    assert s2._cache is not s1._cache
    k2 = np.asarray(jax.device_get(s2._inv_k2()))
    assert not np.allclose(k1, k2)
    # cache hit on repeat
    assert s2._inv_k2() is s2._cache["inv_k2"]


def test_taylor_green_checkpoint_restart_cross_grid(tmp_path):
    # production workflow: run, checkpoint shard-wise, restore onto a
    # DIFFERENT process grid, continue — trajectories must agree with an
    # uninterrupted run on the original grid
    import jax
    import numpy as np
    import cudecomp_tpu as cd
    from cudecomp_tpu.models.taylor_green import TaylorGreenSolver
    from cudecomp_tpu.utils import checkpoint as ckpt

    n, dt = 16, 0.01

    def make(pdims, ndev):
        grid = cd.make_grid(cd.GridConfig(gdims=(n, n, n), pdims=pdims),
                            devices=jax.devices()[:ndev])
        s = TaylorGreenSolver(grid=grid, split_complex=False)
        uh, f = s.setup()
        return grid, s, uh, f

    # uninterrupted 4 steps on (2, 2)
    g1, s1, uh, f1 = make((2, 2), 4)
    for _ in range(4):
        uh = s1.step(uh, f1, dt)
    want = float(s1.energy(uh, f1))

    # 2 steps, checkpoint the spectral state, restore on (1, 8), 2 more
    g1b, s1b, uh2, f1b = make((2, 2), 4)
    for _ in range(2):
        uh2 = s1b.step(uh2, f1b, dt)
    cgrid = f1b["plan"].complex_grid
    ckpt.save_pencil(str(tmp_path / "tg"), cgrid, uh2, 2)

    g2, s2, _, f2 = make((1, 8), 8)
    cgrid2 = f2["plan"].complex_grid
    uh3 = ckpt.load_pencil(str(tmp_path / "tg"), cgrid2, axis=2)
    for _ in range(2):
        uh3 = s2.step(uh3, f2, dt)
    got = float(s2.energy(uh3, f2))
    assert abs(got - want) / want < 1e-10


def test_taylor_green_integrating_factor_matches_explicit():
    # IF-RK4 integrates the viscous term exactly; at small dt it must agree
    # with the explicit scheme to high order, while at the viscous
    # stability limit only IF survives (chip evidence: 256^3 dt=0.01
    # diverges explicit, decays with IF)
    gd = (16, 16, 16)
    grid = make_grid_for(gd, (2, 2))
    nu, dt, n_steps = 0.01, 0.002, 4
    _, h_exp = TaylorGreenSolver(grid=grid, nu=nu,
                                 integrating_factor=False).run(n_steps, dt)
    _, h_if = TaylorGreenSolver(grid=grid, nu=nu).run(n_steps, dt)
    np.testing.assert_allclose(h_if, h_exp, rtol=1e-8)
    assert all(b < a for a, b in zip(h_if, h_if[1:]))


def test_taylor_green_cfl_dt():
    # reference get_dt analog (tg.cu:759-772): cfl * dx / velmax; the TG
    # initial field has max |u| = 1
    gd = (16, 16, 16)
    grid = make_grid_for(gd, (1, 4))
    solver = TaylorGreenSolver(grid=grid, nu=0.01)
    uh, f = solver.setup()
    dt = float(solver.cfl_dt(uh, f, cfl=0.5))
    dx = 2.0 * np.pi / 16
    np.testing.assert_allclose(dt, 0.5 * dx, rtol=1e-5)


@pytest.mark.parametrize("pdims", [(1, 1), (2, 4)])
def test_poisson_solve_discrete_exact(pdims):
    # solve(discrete=True) inverts the 7-point operator EXACTLY in one
    # FFT pair: reconstruct u from lap_h(u) to roundoff (the direct
    # counterpart of the CG solve, same oracle construction)
    n = 16
    grid = make_grid_for((n, n, n), pdims)
    rng = np.random.default_rng(13)
    u_true = rng.standard_normal((n, n, n))
    u_true -= u_true.mean()
    ub = cd.scatter_global(grid, u_true, 0)
    solver = PoissonSolver(grid=grid)
    h2 = (2 * np.pi / n) ** 2
    fb = cd.laplacian7(grid, ub, 0, (True, True, True)) / h2
    u = solver.solve(fb, discrete=True)
    np.testing.assert_allclose(np.asarray(cd.gather_global(grid, u, 0)),
                               u_true, rtol=0, atol=1e-10)


def test_poisson_solve_discrete_anisotropic_lengths():
    # non-2pi anisotropic domain: the FD symbol uses each axis' own h
    n = (16, 8, 8)
    grid = make_grid_for(n, (2, 4))
    L = (2 * np.pi, np.pi, 4.0)
    rng = np.random.default_rng(14)
    u_true = rng.standard_normal(n)
    u_true -= u_true.mean()
    ub = cd.scatter_global(grid, u_true, 0)
    solver = PoissonSolver(grid=grid, lengths=L)
    # anisotropic weighted 7-point matvec (same weights solve_cg uses)
    hs = [L[d] / n[d] for d in range(3)]
    w = np.zeros((3, 3, 3))
    for d in range(3):
        inv = 1.0 / hs[d] ** 2
        lo, hi = [1, 1, 1], [1, 1, 1]
        lo[d], hi[d] = 0, 2
        w[tuple(lo)] = w[tuple(hi)] = inv
        w[1, 1, 1] -= 2.0 * inv
    fb = cd.stencil_apply(grid, ub, w, 0, (True, True, True))
    u = solver.solve(fb, discrete=True)
    np.testing.assert_allclose(np.asarray(cd.gather_global(grid, u, 0)),
                               u_true, rtol=0, atol=1e-10)
