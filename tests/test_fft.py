"""Distributed FFT correctness vs local numpy FFTs and round-trip identity —
the analog of the reference benchmark's correctness mode
(benchmark.cu:613-643, tolerances :23-27)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import cudecomp_tpu as cd
from cudecomp_tpu.config import GridConfig, TransposeMethod
from cudecomp_tpu.ops.fft import DistributedFFT, complex_grid_config

RNG = np.random.default_rng(1234)


def make_grid_for(gdims, pdims, **kw):
    cfg = GridConfig(gdims=gdims, pdims=pdims, **kw)
    return cd.make_grid(cfg, devices=jax.devices()[: pdims[0] * pdims[1]])


def c2c_case(gdims, pdims, method=None, **cfg_kw):
    if method is not None:
        cfg_kw["transpose_method"] = method
    grid = make_grid_for(gdims, pdims, **cfg_kw)
    x = (RNG.standard_normal(gdims) + 1j * RNG.standard_normal(gdims)
         ).astype(np.complex128)
    plan = DistributedFFT(grid=grid)
    buf = cd.scatter_global(grid, x, 0)
    xh = plan.forward(buf)
    got = cd.gather_global(grid, xh, 2)
    ref = np.fft.fftn(x)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-8)
    back = plan.inverse(xh)
    np.testing.assert_allclose(cd.gather_global(grid, back, 0), x,
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("pdims", [(2, 2), (1, 4), (4, 1), (2, 4)])
def test_c2c_even(pdims):
    c2c_case((8, 8, 8), pdims)


@pytest.mark.parametrize("pdims", [(2, 2), (1, 4), (4, 1)])
def test_c2c_uneven(pdims):
    c2c_case((9, 10, 11), pdims)


def test_c2c_axis_contiguous():
    c2c_case((8, 8, 8), (2, 2), transpose_axis_contiguous=(True, True, True))
    c2c_case((9, 10, 11), (2, 2), transpose_axis_contiguous=(True, True, True))


def test_c2c_ring_method():
    c2c_case((8, 8, 8), (2, 2), method=TransposeMethod.RING)


def test_c2c_single_rank():
    c2c_case((8, 9, 10), (1, 1))


def test_slab_plan_fusion():
    # slab grids fuse FFT stages and skip no-op transposes (benchmark.cu:294-356)
    grid = make_grid_for((8, 8, 8), (1, 4))
    plan = DistributedFFT(grid=grid)
    kinds = [s[0] for s in plan._stages()]
    assert kinds == ["fft", "transpose", "fft"]  # X-Y fused (Pr == 1)
    grid = make_grid_for((8, 8, 8), (4, 1))
    plan = DistributedFFT(grid=grid)
    kinds = [s[0] for s in plan._stages()]
    assert kinds == ["fft", "transpose", "fft"]  # Y-Z fused (Pc == 1)
    grid = make_grid_for((8, 8, 8), (1, 1))
    assert [s[0] for s in DistributedFFT(grid=grid)._stages()] == ["fft"]


def r2c_case(gdims, pdims, **cfg_kw):
    grid = make_grid_for(gdims, pdims, **cfg_kw)
    x = RNG.standard_normal(gdims).astype(np.float64)
    plan = DistributedFFT(grid=grid, real=True)
    cgrid = plan.complex_grid
    assert cgrid.gdims == (gdims[0] // 2 + 1, gdims[1], gdims[2])
    buf = cd.scatter_global(grid, x, 0)
    xh = plan.forward(buf)
    got = cd.gather_global(cgrid, xh, 2)
    ref = np.fft.rfftn(x, axes=(0, 1, 2))
    # numpy rfftn does the real transform along the LAST axis; ours is along
    # X (axis 0) like the reference benchmark, so compare against the
    # axis-0-real spectrum
    ref = np.fft.fftn(np.fft.rfft(x, axis=0), axes=(1, 2))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-8)
    back = plan.inverse(xh)
    np.testing.assert_allclose(cd.gather_global(grid, back, 0), x,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("pdims", [(2, 2), (1, 4), (4, 1)])
def test_r2c_even(pdims):
    r2c_case((8, 8, 8), pdims)


def test_r2c_uneven():
    r2c_case((10, 9, 11), (2, 2))


def test_r2c_odd_x():
    r2c_case((9, 8, 8), (2, 2))


def test_r2c_axis_contiguous():
    r2c_case((8, 8, 8), (2, 2), transpose_axis_contiguous=(True, True, True))


def test_fft_jitted():
    grid = make_grid_for((8, 8, 8), (2, 2))
    plan = DistributedFFT(grid=grid)
    x = (RNG.standard_normal((8, 8, 8))
         + 1j * RNG.standard_normal((8, 8, 8))).astype(np.complex128)
    buf = cd.scatter_global(grid, x, 0)
    roundtrip = jax.jit(lambda b: plan.inverse(plan.forward(b)))
    out = roundtrip(buf)
    np.testing.assert_allclose(cd.gather_global(grid, out, 0), x,
                               rtol=0, atol=1e-10)


def test_fft_adjoint_identity_split_complex():
    # plan.forward is linear: <F x, y> must equal <x, F^T y> (vjp), through
    # the full shard_map + collective pipeline — the differentiability
    # contract spectral solvers rely on
    import jax
    import jax.numpy as jnp
    import numpy as np
    import cudecomp_tpu as cd
    from cudecomp_tpu.config import GridConfig
    from cudecomp_tpu.ops.fft import DistributedFFT

    grid = cd.make_grid(GridConfig(gdims=(8, 8, 8), pdims=(2, 4)),
                        devices=jax.devices()[:8])
    plan = DistributedFFT(grid=grid, split_complex=True)
    rng = np.random.default_rng(5)
    x = jax.device_put(rng.standard_normal((8, 8, 8, 2)).astype(np.float32),
                       grid.sharding(0))
    y_np = rng.standard_normal((8, 8, 8, 2)).astype(np.float32)

    fx, vjp = jax.vjp(plan.forward, x)
    y = jax.device_put(y_np, fx.sharding)
    lhs = float(jnp.vdot(fx, y))
    (xbar,) = vjp(y)
    rhs = float(jnp.vdot(x, xbar))
    assert abs(lhs - rhs) / max(abs(lhs), 1e-6) < 1e-4


def test_grad_through_pipelined_transpose():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import cudecomp_tpu as cd
    from cudecomp_tpu.config import GridConfig, TransposeMethod

    grid = cd.make_grid(GridConfig(gdims=(8, 8, 8), pdims=(2, 2)),
                        devices=jax.devices()[:4])
    x = jax.device_put(np.random.default_rng(6).standard_normal(
        (8, 8, 8)).astype(np.float32), grid.sharding(0))

    def loss(b):
        y = cd.transpose_x_to_y(grid, b,
                                method=TransposeMethod.RING_PIPELINED)
        return jnp.sum(y ** 2)

    g = jax.grad(loss)(x)
    np.testing.assert_allclose(np.asarray(jax.device_get(g)),
                               2 * np.asarray(jax.device_get(x)), rtol=1e-5)


def test_precision_auto_per_n_policy(monkeypatch):
    # 'auto' selects HIGH for transform lengths <= the threshold, HIGHEST
    # above (per-N policy so large grids stay inside the 5e-4 gate)
    from jax import lax
    from cudecomp_tpu.ops.mxu_fft import _precision
    monkeypatch.setenv("CUDECOMP_TPU_FFT_PRECISION", "auto")
    monkeypatch.setenv("CUDECOMP_TPU_FFT_AUTO_N", "512")
    assert _precision(256) == lax.Precision.HIGH
    assert _precision(512) == lax.Precision.HIGH
    assert _precision(1024) == lax.Precision.HIGHEST
    assert _precision(None) == lax.Precision.HIGHEST  # unknown length: safe
    monkeypatch.setenv("CUDECOMP_TPU_FFT_PRECISION", "highest")
    assert _precision(256) == lax.Precision.HIGHEST


def test_bf16_carry_roundtrip(monkeypatch):
    # opt-in bf16 inter-stage storage: output dtype preserved, round trip
    # within bf16 carry tolerance (~2^-8 relative)
    from cudecomp_tpu.ops import mxu_fft
    x = RNG.standard_normal((8, 8, 8, 2)).astype(np.float32)
    ref = np.asarray(mxu_fft.fft_split_axes(jnp.asarray(x), [0, 1, 2]))
    monkeypatch.setenv("CUDECOMP_TPU_FFT_BF16_CARRY", "1")
    got = mxu_fft.fft_split_axes(jnp.asarray(x), [0, 1, 2])
    assert got.dtype == jnp.float32
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(np.asarray(got) - ref)) / scale < 3e-2
    back = mxu_fft.fft_split_axes(got, [0, 1, 2], inverse=True)
    assert np.max(np.abs(np.asarray(back) - x)) < 5e-2


@pytest.mark.parametrize("pdims", [(1, 1), (2, 4)])
def test_plane_form_matches_interleaved_c2c(pdims):
    # forward_planes/inverse_planes must produce bit-identical math to the
    # interleaved (..., 2) form — the plane form only removes the
    # stack/slice boundary
    grid = make_grid_for((8, 12, 16), pdims)
    plan = DistributedFFT(grid=grid, split_complex=True)
    x = RNG.standard_normal((8, 12, 16, 2)).astype(np.float64)
    buf = jax.device_put(x, grid.sharding(0))
    ref_h = plan.forward(buf)
    r, i = plan.forward_planes((buf[..., 0], buf[..., 1]))
    np.testing.assert_allclose(np.asarray(jnp.stack([r, i], -1)),
                               np.asarray(ref_h), rtol=0, atol=1e-12)
    back_r, back_i = plan.inverse_planes((r, i))
    ref_back = plan.inverse(ref_h)
    np.testing.assert_allclose(np.asarray(back_r),
                               np.asarray(ref_back[..., 0]),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(back_i),
                               np.asarray(ref_back[..., 1]),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(back_r), x[..., 0],
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("pdims", [(1, 1), (2, 2)])
def test_plane_form_r2c(pdims):
    grid = make_grid_for((8, 12, 16), pdims)
    plan = DistributedFFT(grid=grid, real=True, split_complex=True)
    x = RNG.standard_normal((8, 12, 16)).astype(np.float64)
    buf = cd.scatter_global(grid, x, 0)
    r, i = plan.forward_planes(buf)
    got = (np.asarray(cd.gather_global(plan.complex_grid, r, 2))
           + 1j * np.asarray(cd.gather_global(plan.complex_grid, i, 2)))
    ref = np.fft.fftn(np.fft.rfft(x, axis=0), axes=(1, 2))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-8)
    back = plan.inverse_planes((r, i))
    np.testing.assert_allclose(np.asarray(cd.gather_global(grid, back, 0)),
                               x, rtol=0, atol=1e-10)


def test_plane_form_requires_split_complex():
    grid = make_grid_for((8, 8, 8), (1, 1))
    plan = DistributedFFT(grid=grid)
    with pytest.raises(ValueError, match="split_complex"):
        plan.forward_planes((jnp.zeros((8, 8, 8)),) * 2)


def test_autotune_fft_planner():
    # the planner analog of the grid autotuner: gate-check + time each
    # (precision, gauss) policy, pin the fastest passing one into the plan
    import cudecomp_tpu as cd

    cfg = GridConfig(gdims=(16, 16, 16), pdims=(1, 1))
    grid = cd.make_grid(cfg, devices=jax.devices()[:1])
    res = cd.autotune_fft(grid, n_warmup=1, n_trials=1, iters=2)
    assert res.plan.precision in ("high", "highest")
    assert res.plan.split_complex
    assert any(t.gate_passed for t in res.trials)
    assert "selected" in res.report()
    # the pinned plan round-trips correctly
    import numpy as np
    f = np.random.default_rng(0).standard_normal((16, 16, 16)).astype(np.float32)
    r = cd.scatter_global(grid, f, 0)
    i = cd.scatter_global(grid, np.zeros_like(f), 0)
    rr, ii = res.plan.inverse_planes(res.plan.forward_planes((r, i)))
    np.testing.assert_allclose(np.asarray(cd.gather_global(grid, rr, 0)), f,
                               atol=5e-4)

    # r2c variant
    res2 = cd.autotune_fft(grid, real=True, n_warmup=1, n_trials=1, iters=2)
    out = res2.plan.inverse_planes(res2.plan.forward_planes(r))
    np.testing.assert_allclose(np.asarray(cd.gather_global(grid, out, 0)), f,
                               atol=5e-4)


def test_autotune_fft_gate_failure():
    import cudecomp_tpu as cd

    cfg = GridConfig(gdims=(16, 16, 16), pdims=(1, 1))
    grid = cd.make_grid(cfg, devices=jax.devices()[:1])
    with pytest.raises(RuntimeError, match="gate"):
        cd.autotune_fft(grid, gate=1e-30, n_warmup=1, n_trials=1, iters=2)


def test_plan_policy_pinning(monkeypatch):
    # per-plan precision/gauss beat the env knobs at trace time
    import cudecomp_tpu as cd
    from cudecomp_tpu.ops import mxu_fft

    cfg = GridConfig(gdims=(8, 8, 8), pdims=(1, 1))
    grid = cd.make_grid(cfg, devices=jax.devices()[:1])
    seen = []
    orig = mxu_fft._precision

    def spy(n=None):
        p = orig(n)
        seen.append(p)
        return p

    monkeypatch.setattr(mxu_fft, "_precision", spy)
    monkeypatch.setenv("CUDECOMP_TPU_FFT_PRECISION", "highest")
    plan = cd.DistributedFFT(grid=grid, split_complex=True, precision="high")
    import numpy as np
    r = cd.scatter_global(grid, np.ones((8, 8, 8), np.float32), 0)
    plan.forward_planes((r, r))
    import jax.lax as lax
    assert lax.Precision.HIGH in seen
    assert lax.Precision.HIGHEST not in seen


def test_autotune_fft_uneven_decomposition():
    # review fix: the gate must ignore the padding slots the transpose
    # pipeline zeroes at repack — on uneven decompositions every
    # candidate used to fail the gate spuriously and the search raised
    grid = make_grid_for((16, 15, 16), (2, 4))
    res = cd.autotune_fft(grid, real=True, n_warmup=1, n_trials=1, iters=2)
    assert any(t.gate_passed for t in res.trials)
    assert res.plan.precision in ("high", "highest")


def test_matmul_complex_keyed_on_mesh_platform():
    # the FFT engine follows the platform of the plan's mesh, not the
    # process default backend: a CPU mesh takes the matmul core, a GPU
    # mesh the XLA FFT op (cuFFT)
    from types import SimpleNamespace
    from cudecomp_tpu.ops.fft import _use_matmul_complex

    def mesh_of(platform):
        dev = SimpleNamespace(platform=platform)
        return SimpleNamespace(devices=np.array([dev], dtype=object))

    assert _use_matmul_complex(mesh_of("cpu")) is True
    assert _use_matmul_complex(mesh_of("gpu")) is False
    grid = make_grid_for((8, 8, 8), (2, 2))
    assert _use_matmul_complex(grid.mesh) is True


def test_autotune_fft_stays_on_grid_devices(monkeypatch):
    # the search data is made on the grid's own devices: no key is built
    # on the process default device, and the trial data lands sharded
    # over the grid's mesh
    import cudecomp_tpu as cd

    def no_default_key(*a, **k):
        raise AssertionError("PRNGKey built on the default device")

    monkeypatch.setattr(jax.random, "PRNGKey", no_default_key)
    grid = make_grid_for((8, 8, 8), (2, 2))
    res = cd.autotune_fft(grid, candidates=(("highest", True),),
                          n_warmup=0, n_trials=1, iters=1)
    assert res.trials[0].gate_passed


def test_spectral_fields_replicated_on_plan_mesh():
    # eager operator fields live on every device of the plan's mesh, not
    # on the default device alone
    import cudecomp_tpu as cd
    grid = make_grid_for((8, 8, 8), (2, 2))
    sops = cd.SpectralOperators(plan=cd.DistributedFFT(grid=grid))
    for k in sops.wavenumbers():
        assert {s.device for s in k.addressable_shards} == set(
            grid.mesh.devices.flat)
