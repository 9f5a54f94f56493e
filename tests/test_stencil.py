"""Ghost-plane stencil pipeline (ops/stencil.py) — numpy-oracle tests on
the virtual CPU mesh, periodic + non-periodic, pencil axes, layouts, and
the 27-point weighted form."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import cudecomp_tpu as cd
from cudecomp_tpu.config import GridConfig


def np_lap7(u, periods):
    """Numpy 7-point Laplacian; non-periodic edges see zero ghosts."""
    u = u.astype(np.float64)
    lap = -6.0 * u
    for d in range(3):
        for s in (-1, 1):
            sh = np.roll(u, s, axis=d)
            if not periods[d]:
                idx = [slice(None)] * 3
                idx[d] = 0 if s == 1 else -1
                sh[tuple(idx)] = 0.0
            lap += sh
    return lap


def run_case(gdims, pdims, axis, periods, dtype=np.float64, steps=1,
             dt=None, **cfg_kw):
    cfg = GridConfig(gdims=gdims, pdims=pdims, **cfg_kw)
    grid = cd.make_grid(cfg, devices=jax.devices()[: pdims[0] * pdims[1]])
    rng = np.random.default_rng(0)
    x = rng.standard_normal(gdims).astype(dtype)
    u = cd.scatter_global(grid, x, axis)
    if dt is None:
        out = jax.jit(lambda v: cd.laplacian7(grid, v, axis, periods))(u)
        want = np_lap7(x, periods)
    else:
        fn = jax.jit(lambda v: cd.diffusion_step(grid, v, dt, axis, periods))
        out = u
        for _ in range(steps):
            out = fn(out)
        want = x.astype(np.float64)
        for _ in range(steps):
            want = want + dt * np_lap7(want, periods)
    got = np.asarray(cd.gather_global(grid, out, axis))
    tol = 1e-12 if np.dtype(dtype) == np.float64 else 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(
        1.0, float(np.max(np.abs(want)))))


@pytest.mark.parametrize("pdims", [(1, 1), (2, 4), (1, 4), (4, 1)])
def test_periodic_laplacian(pdims):
    run_case((16, 16, 16), pdims, 0, (True, True, True))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_pencil_axes(axis):
    run_case((8, 16, 32), (2, 2), axis, (True, True, True))


@pytest.mark.parametrize("periods", [(False, False, False),
                                     (True, False, True)])
def test_nonperiodic(periods):
    run_case((16, 16, 16), (2, 4), 0, periods)


def test_diffusion_step_multistep():
    run_case((16, 16, 16), (2, 4), 0, (True, True, True), steps=3, dt=0.05)


def test_axis_contiguous_layout():
    run_case((16, 16, 16), (2, 2), 1, (True, True, True),
             transpose_axis_contiguous=(True, True, True))


def test_uneven_extents_rejected():
    cfg = GridConfig(gdims=(9, 16, 16), pdims=(2, 2))
    grid = cd.make_grid(cfg, devices=jax.devices()[:4])
    u = jnp.zeros(grid.global_shape(1))
    # axis 1 shards dim 0 (9 over 2): must raise
    with pytest.raises(ValueError, match="divisible"):
        cd.laplacian7(grid, u, 1, (True, True, True))


def test_shape_mismatch_rejected():
    cfg = GridConfig(gdims=(16, 16, 16), pdims=(2, 4))
    grid = cd.make_grid(cfg)
    with pytest.raises(ValueError, match="does not match"):
        cd.laplacian7(grid, jnp.zeros((8, 16, 16)), 0, (True,) * 3)


def np_extend(u, widths, periods):
    """Global ghost extension: wrap for periodic dims, zeros otherwise."""
    out = u
    for d in range(3):
        w = widths[d]
        if w == 0:
            continue
        pad = [(0, 0)] * 3
        pad[d] = (w, w)
        mode = "wrap" if periods[d] else "constant"
        out = np.pad(out, pad, mode=mode)
    return out


def crop(a, widths):
    sl = tuple(slice(w, a.shape[d] - w) for d, w in enumerate(widths))
    return a[sl]


@pytest.mark.parametrize("pdims,widths,periods", [
    ((2, 4), (1, 1, 1), (True, True, True)),
    ((2, 4), (2, 2, 2), (True, False, True)),
    ((1, 1), (2, 1, 0), (False, True, True)),
    ((4, 1), (0, 2, 2), (True, True, False)),
])
def test_halo_map_box_mean(pdims, widths, periods):
    # box-sum stencil of the given widths: exercises corner ghosts too
    gdims = (16, 16, 16)
    cfg = GridConfig(gdims=gdims, pdims=pdims)
    grid = cd.make_grid(cfg, devices=jax.devices()[: pdims[0] * pdims[1]])
    x = np.random.default_rng(3).standard_normal(gdims)
    u = cd.scatter_global(grid, x, 0)

    def box_sum(ue):
        out = 0.0
        for ox in range(2 * widths[0] + 1):
            for oy in range(2 * widths[1] + 1):
                for oz in range(2 * widths[2] + 1):
                    out = out + ue[ox:ox + ue.shape[0] - 2 * widths[0],
                                   oy:oy + ue.shape[1] - 2 * widths[1],
                                   oz:oz + ue.shape[2] - 2 * widths[2]]
        return out

    got = np.asarray(cd.gather_global(
        grid, jax.jit(lambda v: cd.halo_map(grid, v, box_sum, 0, widths,
                                            periods))(u), 0))
    want = box_sum(np_extend(x, widths, periods))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)


def test_halo_map_scalar_width_and_errors():
    cfg = GridConfig(gdims=(16, 16, 16), pdims=(2, 4))
    grid = cd.make_grid(cfg)
    x = np.random.default_rng(4).standard_normal((16, 16, 16))
    u = cd.scatter_global(grid, x, 0)
    got = np.asarray(cd.gather_global(
        grid, cd.halo_map(grid, u, lambda ue: ue[1:-1, 1:-1, 1:-1], 0, 1),
        0))
    np.testing.assert_allclose(got, x, rtol=0, atol=0)
    # width exceeding the local extent of a sharded dim (16/4 = 4)
    with pytest.raises(ValueError, match="exceeds the local extent"):
        cd.halo_map(grid, u, lambda ue: ue, 0, (0, 0, 5))
    with pytest.raises(ValueError, match="expected the interior"):
        cd.halo_map(grid, u, lambda ue: ue, 0, 1)
    with pytest.raises(ValueError, match="invalid width"):
        cd.halo_map(grid, u, lambda ue: ue, 0, (1, -1, 0))


def test_halo_map_component_dims():
    # vector field (..., 3): components pass through unextended; each
    # component sees the same ghost extension as a scalar call
    cfg = GridConfig(gdims=(16, 16, 16), pdims=(2, 4))
    grid = cd.make_grid(cfg)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((16, 16, 16, 3))
    u = jnp.stack([cd.scatter_global(grid, x[..., c], 0)
                   for c in range(3)], axis=-1)
    periods = (True, False, True)

    def box(ue):
        return (ue[:-2, 1:-1, 1:-1] + ue[2:, 1:-1, 1:-1]
                + ue[1:-1, :-2, 1:-1] + ue[1:-1, 2:, 1:-1]
                + ue[1:-1, 1:-1, :-2] + ue[1:-1, 1:-1, 2:])

    out = cd.halo_map(grid, u, box, 0, 1, periods)
    for c in range(3):
        got_c = np.asarray(cd.gather_global(grid, out[..., c], 0))
        uc = cd.scatter_global(grid, x[..., c], 0)
        want_c = np.asarray(cd.gather_global(
            grid, cd.halo_map(grid, uc, box, 0, 1, periods), 0))
        np.testing.assert_allclose(got_c, want_c, rtol=0, atol=0)


def test_halo_map_matches_laplacian7():
    cfg = GridConfig(gdims=(16, 16, 16), pdims=(2, 2))
    grid = cd.make_grid(cfg, devices=jax.devices()[:4])
    x = np.random.default_rng(5).standard_normal((16, 16, 16))
    u = cd.scatter_global(grid, x, 0)

    def lap(ue):
        c = ue[1:-1, 1:-1, 1:-1]
        return (ue[:-2, 1:-1, 1:-1] + ue[2:, 1:-1, 1:-1]
                + ue[1:-1, :-2, 1:-1] + ue[1:-1, 2:, 1:-1]
                + ue[1:-1, 1:-1, :-2] + ue[1:-1, 1:-1, 2:] - 6.0 * c)

    periods = (True, False, True)
    a = np.asarray(cd.gather_global(
        grid, cd.halo_map(grid, u, lap, 0, 1, periods), 0))
    b = np.asarray(cd.gather_global(
        grid, cd.laplacian7(grid, u, 0, periods), 0))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("periods", [(True, True, True),
                                     (True, False, True)])
def test_gradients_self_adjoint(periods):
    # the stencil operator A = I + dt*L is symmetric for periodic AND
    # Dirichlet ghost modes, so grad(sum(A u * w)) == A w
    cfg = GridConfig(gdims=(16, 16, 16), pdims=(2, 4))
    grid = cd.make_grid(cfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((16, 16, 16))
    w = rng.standard_normal((16, 16, 16))
    u = cd.scatter_global(grid, x, 0)
    wv = cd.scatter_global(grid, w, 0)
    dt = 0.05

    def loss(v):
        return jnp.sum(cd.diffusion_step(grid, v, dt, 0, periods) * wv)

    g = jax.grad(loss)(u)
    want = cd.diffusion_step(grid, wv, dt, 0, periods)
    np.testing.assert_allclose(np.asarray(cd.gather_global(grid, g, 0)),
                               np.asarray(cd.gather_global(grid, want, 0)),
                               rtol=0, atol=1e-11)
    # laplacian7 too, and traced-dt composition
    g2 = jax.grad(lambda v: jnp.sum(cd.laplacian7(grid, v, 0, periods)
                                    * wv))(u)
    want2 = cd.laplacian7(grid, wv, 0, periods)
    np.testing.assert_allclose(np.asarray(cd.gather_global(grid, g2, 0)),
                               np.asarray(cd.gather_global(grid, want2, 0)),
                               rtol=0, atol=1e-11)
    out_traced = jax.jit(
        lambda v, d: cd.diffusion_step(grid, v, d, 0, periods))(u, dt)
    out_static = cd.diffusion_step(grid, u, dt, 0, periods)
    np.testing.assert_allclose(
        np.asarray(cd.gather_global(grid, out_traced, 0)),
        np.asarray(cd.gather_global(grid, out_static, 0)),
        rtol=0, atol=1e-12)


def np_stencil27(u, w, periods):
    ue = np_extend(u, (1, 1, 1), periods)
    out = np.zeros_like(u, dtype=np.float64)
    n = u.shape
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                wv = w[1 + dx, 1 + dy, 1 + dz]
                if wv:
                    out += wv * ue[1 + dx:1 + dx + n[0],
                                   1 + dy:1 + dy + n[1],
                                   1 + dz:1 + dz + n[2]]
    return out


@pytest.mark.parametrize("pdims,periods", [
    ((2, 4), (True, True, True)),       # fallback (sharded y/z)
    ((2, 4), (True, False, True)),
    ((1, 1), (True, True, True)),       # single-shard XLA path on CPU
])
def test_stencil_apply_dense_weights(pdims, periods):
    gdims = (16, 16, 16)
    grid = cd.make_grid(GridConfig(gdims=gdims, pdims=pdims),
                        devices=jax.devices()[: pdims[0] * pdims[1]])
    rng = np.random.default_rng(8)
    x = rng.standard_normal(gdims)
    w = rng.standard_normal((3, 3, 3))
    u = cd.scatter_global(grid, x, 0)
    got = np.asarray(cd.gather_global(
        grid, cd.stencil_apply(grid, u, w, 0, periods), 0))
    np.testing.assert_allclose(got, np_stencil27(x, w, periods),
                               rtol=0, atol=1e-11)


def test_stencil_apply_matches_laplacian7():
    grid = cd.make_grid(GridConfig(gdims=(16, 16, 16), pdims=(2, 2)),
                        devices=jax.devices()[:4])
    w = np.zeros((3, 3, 3))
    w[1, 1, 1] = -6.0
    for o in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
              (1, 1, 2)):
        w[o] = 1.0
    x = np.random.default_rng(10).standard_normal((16, 16, 16))
    u = cd.scatter_global(grid, x, 0)
    periods = (True, False, True)
    a = np.asarray(cd.gather_global(
        grid, cd.stencil_apply(grid, u, w, 0, periods), 0))
    b = np.asarray(cd.gather_global(
        grid, cd.laplacian7(grid, u, 0, periods), 0))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("periods", [(True, True, True),
                                     (True, False, True)])
def test_stencil_apply_gradient_reflected_adjoint(periods):
    # VJP of a linear stencil = stencil with reflected offsets
    grid = cd.make_grid(GridConfig(gdims=(16, 16, 16), pdims=(2, 4)))
    rng = np.random.default_rng(13)
    x = rng.standard_normal((16, 16, 16))
    cw = rng.standard_normal((16, 16, 16))
    w = rng.standard_normal((3, 3, 3))
    u = cd.scatter_global(grid, x, 0)
    cv = cd.scatter_global(grid, cw, 0)
    g = jax.grad(lambda v: jnp.sum(
        cd.stencil_apply(grid, v, w, 0, periods) * cv))(u)
    want = cd.stencil_apply(grid, cv, w[::-1, ::-1, ::-1], 0, periods)
    np.testing.assert_allclose(np.asarray(cd.gather_global(grid, g, 0)),
                               np.asarray(cd.gather_global(grid, want, 0)),
                               rtol=0, atol=1e-11)


def test_stencil_apply_rejects_bad_weights():
    grid = cd.make_grid(GridConfig(gdims=(16, 16, 16), pdims=(2, 4)))
    u = jnp.zeros((16, 16, 16))
    with pytest.raises(ValueError, match="3, 3, 3"):
        cd.stencil_apply(grid, u, np.zeros((3, 3)), 0)


def _taps(w):
    return tuple(((dx, dy, dz), float(w[1 + dx, 1 + dy, 1 + dz]))
                 for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                 for dz in (-1, 0, 1) if w[1 + dx, 1 + dy, 1 + dz] != 0.0)


@pytest.mark.parametrize("wrap", [(True, True, True), (False, False, False),
                                  (False, True, False), (True, False, True)])
@pytest.mark.parametrize("dense", [False, True])
def test_stencil_kernel_interpret(wrap, dense):
    # the GPU kernel (Triton route) in interpret mode: wrap dims index the
    # block modulo its extent, the others read one ghost plane per side
    from cudecomp_tpu.ops import stencil as st
    ext = (6, 8, 64)
    rng = np.random.default_rng(21)
    x = rng.standard_normal(ext).astype(np.float32)
    if dense:
        w = rng.uniform(-1.0, 1.0, (3, 3, 3))
    else:
        w = np.zeros((3, 3, 3))
        w[1, 1, 1] = 0.4
        for o in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                  (1, 1, 2)):
            w[o] = 0.1
    ue = np.pad(x, [(0, 0) if wr else (1, 1) for wr in wrap], mode="wrap")
    got = st._stencil_kernel_call(jnp.asarray(ue), _taps(w), ext, wrap,
                                  interpret=True)
    np.testing.assert_allclose(np.asarray(got),
                               np_stencil27(x, w, (True,) * 3),
                               rtol=1e-5, atol=1e-5)


def test_stencil_kernel_tiles():
    from cudecomp_tpu.ops import stencil as st
    assert st._kernel_tiles((512, 512, 512)) == (8, 512)
    assert st._kernel_tiles((256, 256, 1024)) == (8, 512)
    assert st._kernel_tiles((8, 12, 64)) == (4, 64)
    assert st._kernel_tiles((16, 16, 48)) is None    # no pow-2 tile >= 32
    assert st._kernel_tiles((16, 16, 16)) is None


def test_stencil_kernel_choice():
    # the kernel serves float32 on GPU meshes whose extents tile; CPU
    # meshes and other dtypes keep the XLA shifted-slice form
    from types import SimpleNamespace
    from cudecomp_tpu.ops import stencil as st

    def grid_on(platform):
        dev = SimpleNamespace(platform=platform)
        return SimpleNamespace(mesh=SimpleNamespace(
            devices=np.array([dev], dtype=object)))

    gpu, cpu = grid_on("gpu"), grid_on("cpu")
    assert st._use_stencil_kernel(gpu, (512, 512, 512), np.float32)
    assert not st._use_stencil_kernel(gpu, (512, 512, 512), np.float64)
    assert not st._use_stencil_kernel(gpu, (16, 16, 48), np.float32)
    assert not st._use_stencil_kernel(cpu, (512, 512, 512), np.float32)
