"""Matmul FFT (split-complex) — correctness vs numpy across sizes
(powers of two, composites, primes), plus the distributed split-complex
pipeline and component-dim transposes that carry it."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import cudecomp_tpu as cd
from cudecomp_tpu.config import GridConfig
from cudecomp_tpu.ops import mxu_fft as M
from cudecomp_tpu.ops.fft import DistributedFFT
from cudecomp_tpu.utils import testing as T

RNG = np.random.default_rng(42)


@pytest.mark.parametrize("n", [1, 2, 4, 7, 13, 32, 60, 64, 96, 128, 256, 1024])
def test_fft_split_vs_numpy(n):
    x = RNG.standard_normal((3, n)) + 1j * RNG.standard_normal((3, n))
    xs = M.to_split(jnp.asarray(x))
    f = np.asarray(M.from_split(M.fft_split(xs, axis=1)))
    ref = np.fft.fft(x, axis=1)
    np.testing.assert_allclose(f, ref, rtol=1e-11, atol=1e-9)
    b = np.asarray(M.from_split(
        M.fft_split(M.fft_split(xs, axis=1), axis=1, inverse=True)))
    np.testing.assert_allclose(b, x, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [2, 7, 8, 9, 60, 64, 256])
def test_rfft_irfft_split_vs_numpy(n):
    x = RNG.standard_normal((4, n))
    f = np.asarray(M.from_split(M.rfft_split(jnp.asarray(x), axis=1)))
    np.testing.assert_allclose(f, np.fft.rfft(x, axis=1), rtol=1e-11,
                               atol=1e-9)
    b = np.asarray(M.irfft_split(M.rfft_split(jnp.asarray(x), axis=1),
                                 axis=1, n=n))
    np.testing.assert_allclose(b, x, rtol=0, atol=1e-12)


def test_rfft_dense_path_large_n(monkeypatch):
    # half-spectrum dense matrices (opt-in) at production threshold
    monkeypatch.setenv("CUDECOMP_TPU_FFT_HALF_SPECTRUM", "1")
    monkeypatch.setattr(M, "DIRECT_THRESHOLD", 512)
    for n in (64, 255, 256):
        x = RNG.standard_normal((3, n))
        f = np.asarray(M.from_split(M.rfft_split(jnp.asarray(x), axis=1)))
        np.testing.assert_allclose(f, np.fft.rfft(x, axis=1), rtol=1e-10,
                                   atol=1e-8)
        b = np.asarray(M.irfft_split(M.rfft_split(jnp.asarray(x), axis=1),
                                     axis=1, n=n))
        np.testing.assert_allclose(b, x, rtol=0, atol=1e-11)


def test_fft_split_any_axis():
    x = RNG.standard_normal((6, 8, 10)) + 1j * RNG.standard_normal((6, 8, 10))
    xs = M.to_split(jnp.asarray(x))
    for ax in range(3):
        f = np.asarray(M.from_split(M.fft_split(xs, axis=ax)))
        np.testing.assert_allclose(f, np.fft.fft(x, axis=ax), rtol=1e-11,
                                   atol=1e-9)


def test_four_step_recursion(monkeypatch):
    # force the four-step path and its recursion (A > threshold) for sizes
    # the default CPU threshold would send to the dense DFT
    monkeypatch.setattr(M, "DIRECT_THRESHOLD", 8)
    for n, axis in [(256, 1), (729, 0), (1024, 2)]:
        shape = [3, 3, 3]
        shape[axis] = n
        x = RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)
        xs = M.to_split(jnp.asarray(x))
        f = np.asarray(M.from_split(M.fft_split(xs, axis=axis)))
        np.testing.assert_allclose(f, np.fft.fft(x, axis=axis), rtol=1e-10,
                                   atol=1e-7)
        b = np.asarray(M.from_split(
            M.fft_split(M.fft_split(xs, axis=axis), axis=axis, inverse=True)))
        np.testing.assert_allclose(b, x, rtol=0, atol=1e-10)


def test_factor_overrides_env(monkeypatch):
    monkeypatch.setenv("CUDECOMP_TPU_FFT_FACTORS", "64=16x4,junk,8=axb")
    assert M._best_factorization(64) == (16, 4)  # override applied
    assert M._best_factorization(8) == (4, 2)    # malformed entry ignored
    monkeypatch.setenv("CUDECOMP_TPU_FFT_FACTORS", "")
    assert M._best_factorization(64) == (8, 8)   # lazily re-read


def test_float32_accuracy():
    n = 256
    x = (RNG.standard_normal((2, n)) + 1j * RNG.standard_normal((2, n)))
    xs = M.to_split(jnp.asarray(x, dtype=jnp.complex64))
    assert xs.dtype == jnp.float32
    f = np.asarray(M.from_split(M.fft_split(xs, axis=1)))
    ref = np.fft.fft(x, axis=1)
    # reference single-precision tolerance (benchmark.cu:23-27)
    assert np.max(np.abs(f - ref)) / np.max(np.abs(ref)) < 5e-4


# -- component dims through the transpose/halo engines --------------------------


def make_grid_for(gdims, pdims, **kw):
    cfg = GridConfig(gdims=gdims, pdims=pdims, **kw)
    return cd.make_grid(cfg, devices=jax.devices()[: pdims[0] * pdims[1]])


@pytest.mark.parametrize("pdims", [(2, 2), (2, 4)])
def test_transpose_with_component_dim(pdims):
    grid = make_grid_for((8, 8, 8), pdims)
    f = T.global_index_field((8, 8, 8))
    x0 = cd.scatter_global(grid, f, 0)
    x1 = cd.scatter_global(grid, 2 * f, 0)
    x = jnp.stack([x0, x1], axis=-1)
    y = cd.transpose_x_to_y(grid, x)
    z = cd.transpose_y_to_z(grid, y)
    for c, scale in ((0, 1.0), (1, 2.0)):
        np.testing.assert_allclose(cd.gather_global(grid, z[..., c], 2),
                                   scale * f)


def test_transpose_component_dim_uneven():
    grid = make_grid_for((9, 10, 11), (2, 2),
                         transpose_axis_contiguous=(True, True, True))
    f = T.global_index_field((9, 10, 11))
    x = jnp.stack([cd.scatter_global(grid, f, 0),
                   cd.scatter_global(grid, -f, 0)], axis=-1)
    y = cd.transpose_x_to_y(grid, x)
    back = cd.transpose_y_to_x(grid, y)
    np.testing.assert_allclose(cd.gather_global(grid, back[..., 0], 0), f)
    np.testing.assert_allclose(cd.gather_global(grid, back[..., 1], 0), -f)


def test_halo_with_component_dim():
    grid = make_grid_for((8, 8, 8), (2, 2))
    f = T.global_index_field((8, 8, 8))
    he = (1, 1, 1)
    b = jnp.stack([cd.scatter_global(grid, f, 0, halo_extents=he),
                   cd.scatter_global(grid, 3 * f, 0, halo_extents=he)],
                  axis=-1)
    out = cd.update_halos(grid, b, 0, he, (True, True, True))
    exp = T.expected_halo_buffer(grid, 0, f, he, (True, True, True),
                                 dims=[0, 1, 2])
    np.testing.assert_allclose(np.asarray(jax.device_get(out[..., 0])), exp)
    np.testing.assert_allclose(np.asarray(jax.device_get(out[..., 1])), 3 * exp)


# -- distributed split-complex FFT ----------------------------------------------


def sc_c2c_case(gdims, pdims, **cfg_kw):
    grid = make_grid_for(gdims, pdims, **cfg_kw)
    x = (RNG.standard_normal(gdims) + 1j * RNG.standard_normal(gdims))
    plan = DistributedFFT(grid=grid, split_complex=True)
    buf = M.to_split(jnp.asarray(cd.scatter_global(grid, x, 0)))
    xh = plan.forward(buf)
    got_r = cd.gather_global(grid, xh[..., 0], 2)
    got_i = cd.gather_global(grid, xh[..., 1], 2)
    ref = np.fft.fftn(x)
    np.testing.assert_allclose(got_r + 1j * got_i, ref, rtol=1e-10, atol=1e-7)
    back = plan.inverse(xh)
    np.testing.assert_allclose(
        cd.gather_global(grid, back[..., 0], 0)
        + 1j * cd.gather_global(grid, back[..., 1], 0), x, rtol=0, atol=1e-10)


@pytest.mark.parametrize("pdims", [(2, 2), (1, 4), (4, 1)])
def test_split_complex_c2c(pdims):
    sc_c2c_case((8, 8, 8), pdims)


def test_split_complex_c2c_uneven():
    sc_c2c_case((12, 10, 14), (2, 2))


def test_split_complex_c2c_axis_contiguous():
    sc_c2c_case((8, 8, 8), (2, 2),
                transpose_axis_contiguous=(True, True, True))


def test_split_complex_r2c():
    grid = make_grid_for((8, 8, 8), (2, 2))
    x = RNG.standard_normal((8, 8, 8))
    plan = DistributedFFT(grid=grid, real=True, split_complex=True)
    buf = cd.scatter_global(grid, x, 0)
    xh = plan.forward(buf)
    cgrid = plan.complex_grid
    got = (cd.gather_global(cgrid, xh[..., 0], 2)
           + 1j * cd.gather_global(cgrid, xh[..., 1], 2))
    ref = np.fft.fftn(np.fft.rfft(x, axis=0), axes=(1, 2))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-8)
    back = plan.inverse(xh)
    np.testing.assert_allclose(cd.gather_global(grid, back, 0), x,
                               rtol=0, atol=1e-12)


def test_split_complex_jitted():
    grid = make_grid_for((8, 8, 8), (2, 2))
    plan = DistributedFFT(grid=grid, split_complex=True)
    x = RNG.standard_normal((8, 8, 8, 2))
    buf = jax.device_put(jnp.asarray(x), grid.sharding(0))
    rt = jax.jit(lambda b: plan.inverse(plan.forward(b)))(buf)
    np.testing.assert_allclose(np.asarray(jax.device_get(rt)),
                               np.asarray(jax.device_get(buf)), atol=1e-12)

def test_policy_contexts_compose():
    # nested policy() contexts merge with the enclosing context: an inner
    # override that leaves a field None must inherit the outer value, not
    # fall back to the env vars (advisor r3 finding)
    from jax import lax
    assert M._use_gauss() is True  # default
    with M.policy(gauss=False):
        assert M._use_gauss() is False
        with M.policy(precision="high"):
            assert M._use_gauss() is False  # inherited from outer context
            assert M._precision(64) == lax.Precision.HIGH
        # inner context popped: outer still in force
        assert M._use_gauss() is False
        assert M._precision(64) == lax.Precision.HIGHEST
    assert M._use_gauss() is True


def test_packed_r2c_matches_numpy(monkeypatch):
    # CUDECOMP_TPU_FFT_R2C_PACKED=1: rfft/irfft via ONE n/2-point complex
    # FFT (pack trick).  Exact vs numpy for forward, round trip, and the
    # c2r contract on arbitrary half-spectra (DC/Nyquist imag ignored,
    # like np.fft.irfft / cuFFT C2R)
    monkeypatch.setenv("CUDECOMP_TPU_FFT_R2C_PACKED", "1")
    rng = np.random.default_rng(3)
    for shape, axis in [((16, 6), 0), ((6, 16), 1), ((4, 8, 6), 1),
                        ((4, 4, 32), 2), ((10, 4), 0)]:
        x = rng.standard_normal(shape).astype(np.float32)
        r, i = M.rfft_planes(jnp.asarray(x), axis)
        got = np.asarray(r) + 1j * np.asarray(i)
        ref = np.fft.rfft(x, axis=axis)
        assert np.abs(got - ref).max() < 1e-4
        back = M.irfft_planes(r, i, axis, shape[axis])
        assert np.abs(np.asarray(back) - x).max() < 1e-5
        hr = rng.standard_normal(got.shape).astype(np.float32)
        hi = rng.standard_normal(got.shape).astype(np.float32)
        nref = np.fft.irfft(hr + 1j * hi, n=shape[axis], axis=axis)
        ngot = np.asarray(M.irfft_planes(jnp.asarray(hr), jnp.asarray(hi),
                                         axis, shape[axis]))
        assert np.abs(ngot - nref).max() < 1e-5


def test_packed_r2c_full_plan(monkeypatch):
    # the packed path rides the full distributed plan (interleaved AND
    # plane-carried forms) across a (2, 4) mesh
    monkeypatch.setenv("CUDECOMP_TPU_FFT_R2C_PACKED", "1")
    import cudecomp_tpu as cd
    rng = np.random.default_rng(4)
    grid = cd.make_grid(cd.GridConfig(gdims=(16, 12, 20), pdims=(2, 4)),
                        devices=jax.devices()[:8])
    plan = cd.DistributedFFT(grid=grid, real=True)
    f = rng.standard_normal((16, 12, 20))
    xs = cd.scatter_global(grid, f, 0)
    got = cd.gather_global(plan.complex_grid, plan.forward(xs), 2)
    ref = np.fft.fftn(np.fft.rfft(f, axis=0), axes=(1, 2))
    assert np.abs(got - ref).max() < 1e-10
    back = cd.gather_global(grid, plan.inverse(plan.forward(xs)), 0)
    assert np.abs(back - f).max() < 1e-12
    rplan = cd.DistributedFFT(grid=grid, real=True, split_complex=True)
    xs32 = cd.scatter_global(grid, f.astype(np.float32), 0)
    rt = cd.gather_global(
        grid, rplan.inverse_planes(rplan.forward_planes(xs32)), 0)
    assert np.abs(rt - f).max() < 1e-5


def test_packed_r2c_odd_n_falls_back(monkeypatch):
    monkeypatch.setenv("CUDECOMP_TPU_FFT_R2C_PACKED", "1")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((9, 4)).astype(np.float32)
    r, i = M.rfft_planes(jnp.asarray(x), 0)
    ref = np.fft.rfft(x, axis=0)
    assert np.abs((np.asarray(r) + 1j * np.asarray(i)) - ref).max() < 1e-4


def test_packed_r2c_default_on(monkeypatch):
    # packed real transforms are the DEFAULT for even N (half the
    # contraction length); the default is read with the knob unset
    monkeypatch.delenv("CUDECOMP_TPU_FFT_R2C_PACKED", raising=False)
    assert M._use_packed_r2c() is True
