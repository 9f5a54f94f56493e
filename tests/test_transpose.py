"""Transpose correctness — global-linear-index oracle over the parameterized
matrix of the reference suite (transpose_tests.cc:45-61): process grids x
all four ops x layouts x dtypes x methods, on even grids and the deliberately
uneven 9x10x11 grid, plus halo/padding variants."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import cudecomp_tpu as cd
from cudecomp_tpu.config import GridConfig, TransposeMethod
from cudecomp_tpu.utils import testing as T


def make_grid_for(gdims, pdims, **kw):
    cfg = GridConfig(gdims=gdims, pdims=pdims, **kw)
    return cd.make_grid(cfg, devices=jax.devices()[: pdims[0] * pdims[1]])


def roundtrip_check(grid, dtype=np.float64, method=None, rtol=0):
    """Scatter oracle field to X-pencil, walk X->Y->Z->Y->X, gather and check
    every intermediate stage against the original."""
    x_global = T.global_index_field(grid.gdims, dtype=dtype)
    buf = cd.scatter_global(grid, x_global, 0)
    T.check_shards_match_pencil(grid, buf, 0, x_global)

    stages = [
        (cd.transpose_x_to_y, 1),
        (cd.transpose_y_to_z, 2),
        (cd.transpose_z_to_y, 1),
        (cd.transpose_y_to_x, 0),
    ]
    for op, out_axis in stages:
        buf = op(grid, buf, method=method)
        got = cd.gather_global(grid, buf, out_axis)
        np.testing.assert_allclose(got, x_global, rtol=rtol, atol=0,
                                   err_msg=f"{op.__name__}")
        T.check_shards_match_pencil(grid, buf, out_axis, x_global)


PDIMS_4 = [(1, 4), (2, 2), (4, 1)]
PDIMS_8 = [(1, 8), (2, 4), (4, 2), (8, 1)]


@pytest.mark.parametrize("pdims", PDIMS_4 + [(2, 4)])
def test_roundtrip_even_natural(pdims):
    roundtrip_check(make_grid_for((8, 8, 8), pdims))


@pytest.mark.parametrize("pdims", PDIMS_4)
def test_roundtrip_uneven_9_10_11(pdims):
    roundtrip_check(make_grid_for((9, 10, 11), pdims))


@pytest.mark.parametrize("pdims", [(2, 2), (2, 4)])
def test_roundtrip_axis_contiguous(pdims):
    roundtrip_check(make_grid_for((8, 8, 8), pdims,
                                  transpose_axis_contiguous=(True, True, True)))


def test_roundtrip_axis_contiguous_uneven():
    roundtrip_check(make_grid_for((9, 10, 11), (2, 2),
                                  transpose_axis_contiguous=(True, True, True)))


def test_roundtrip_mixed_mem_order():
    # arbitrary per-pencil orders (transpose_mem_order config,
    # include/cudecomp.h:145-149): exercise unpack-into-permuted layouts
    roundtrip_check(make_grid_for(
        (8, 8, 8), (2, 2),
        transpose_mem_order=((1, 0, 2), (2, 1, 0), (0, 2, 1))))


def test_roundtrip_mixed_mem_order_uneven():
    roundtrip_check(make_grid_for(
        (9, 10, 11), (2, 2),
        transpose_mem_order=((2, 1, 0), (1, 2, 0), (2, 0, 1))))


@pytest.mark.parametrize("method", [TransposeMethod.ALL_TO_ALL,
                                    TransposeMethod.RING,
                                    TransposeMethod.RING_PIPELINED,
                                    TransposeMethod.RING_HIER])
@pytest.mark.parametrize("pdims", [(2, 2), (1, 4), (2, 4)])
def test_methods_even(method, pdims):
    roundtrip_check(make_grid_for((8, 8, 8), pdims), method=method)


@pytest.mark.parametrize("method", [TransposeMethod.ALL_TO_ALL,
                                    TransposeMethod.RING,
                                    TransposeMethod.RING_PIPELINED,
                                    TransposeMethod.RING_HIER])
def test_methods_uneven(method):
    # RING_PIPELINED runs the true per-peer pipeline here too
    # (non-divisible extents: pad-to-max chunks, masked-add unpack)
    roundtrip_check(make_grid_for((9, 10, 11), (2, 2)), method=method)


@pytest.mark.parametrize("pdims", [(2, 2), (2, 4)])
def test_pipelined_axis_contiguous(pdims):
    # exercises the fused slice->ppermute->single-permute-unpack path with
    # nontrivial input AND output memory orders
    roundtrip_check(make_grid_for((8, 8, 8), pdims,
                                  transpose_axis_contiguous=(True, True, True)),
                    method=TransposeMethod.RING_PIPELINED)


def test_pipelined_mixed_mem_order():
    roundtrip_check(make_grid_for(
        (8, 8, 8), (2, 2),
        transpose_mem_order=((1, 0, 2), (2, 1, 0), (0, 2, 1))),
        method=TransposeMethod.RING_PIPELINED)


def test_pipelined_component_dims():
    # split-complex style trailing component dim rides through the pipeline
    grid = make_grid_for((8, 8, 8), (2, 2))
    x_global = T.global_index_field(grid.gdims, dtype=np.float32)
    xg2 = np.stack([x_global, -x_global], axis=-1)
    buf = cd.scatter_global(grid, x_global, 0)
    buf = jnp.stack([buf, -buf], axis=-1)
    y = cd.transpose_x_to_y(grid, buf, method=TransposeMethod.RING_PIPELINED)
    got = cd.gather_global(grid, y[..., 0], 1)
    np.testing.assert_array_equal(got, x_global)
    got2 = cd.gather_global(grid, y[..., 1], 1)
    np.testing.assert_array_equal(got2, -x_global)


def test_pipelined_with_halos_padding():
    grid = make_grid_for((8, 8, 8), (2, 2))
    x_global = T.global_index_field(grid.gdims, dtype=np.float64)
    buf = cd.scatter_global(grid, x_global, 0)
    y = cd.transpose_x_to_y(grid, buf, output_halo_extents=(1, 1, 0),
                            output_padding=(0, 2, 0),
                            method=TransposeMethod.RING_PIPELINED)
    got = cd.gather_global(grid, y, 1, halo_extents=(1, 1, 0),
                           padding=(0, 2, 0))
    np.testing.assert_array_equal(got, x_global)
    back = cd.transpose_y_to_x(grid, y, input_halo_extents=(1, 1, 0),
                               input_padding=(0, 2, 0),
                               method=TransposeMethod.RING_PIPELINED)
    np.testing.assert_array_equal(cd.gather_global(grid, back, 0), x_global)


def test_hier_schedule_covers_all_peers():
    from cudecomp_tpu.parallel.collectives import hier_schedule
    for n, group in [(8, 2), (8, 4), (12, 3), (6, 6), (8, 1), (9, 3)]:
        steps = hier_schedule(n, group)
        assert len(steps) == n - 1
        G = n // group if group > 1 and n % group == 0 else 1
        K = group if G > 1 else n
        for j in range(n):
            g, k = divmod(j, K)
            peers = {((g + dg) % max(G, 1)) * K + (k + dk) % K
                     for dg, dk in steps}
            assert peers == set(range(n)) - {j}, (n, group, j)
        # every step must be a bijection (valid ppermute)
        for dg, dk in steps:
            dst = [((j // K + dg) % max(G, 1)) * K + (j % K + dk) % K
                   for j in range(n)]
            assert sorted(dst) == list(range(n))


def test_hier_multislice_mock(monkeypatch):
    # 4 devices along pc spanning 2 mock slices: group size 2 -> two-tier
    # schedule actually engages (gdims unique so the plan cache can't reuse
    # a flat-ring program built by other tests)
    from cudecomp_tpu.parallel import mesh as mesh_mod
    grid = make_grid_for((16, 8, 8), (2, 4))
    devs = list(np.asarray(grid.mesh.devices).reshape(-1))
    fake = {id(d): (i % 4) // 2 for i, d in enumerate(devs)}
    monkeypatch.setattr(mesh_mod, "_slice_index",
                        lambda d: fake.get(id(d), 0))
    from cudecomp_tpu.parallel.mesh import axis_group_size
    assert axis_group_size(grid.mesh, "pc") == 2
    roundtrip_check(grid, method=TransposeMethod.RING_HIER)


def test_ring_non_power_of_two():
    # multi-level ring analog: non-power-of-two communicator (3 ranks),
    # reference transpose_tests.cc:223-225
    roundtrip_check(make_grid_for((9, 10, 11), (3, 1)),
                    method=TransposeMethod.RING)
    roundtrip_check(make_grid_for((8, 8, 8), (1, 3)),
                    method=TransposeMethod.RING)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128])
def test_dtypes(dtype):
    roundtrip_check(make_grid_for((8, 8, 8), (2, 2)), dtype=dtype)


def test_col_major_rank_order():
    roundtrip_check(make_grid_for((8, 8, 8), (2, 2),
                                  rank_order=cd.RankOrder.COL_MAJOR))
    roundtrip_check(make_grid_for((9, 10, 11), (2, 4),
                                  rank_order=cd.RankOrder.COL_MAJOR))


def test_gdims_dist():
    # distribute as-if (8,8,8) with excess on Z (FFT padding trick)
    roundtrip_check(make_grid_for((8, 8, 11), (2, 2), gdims_dist=(8, 8, 8)))


def test_transpose_with_halos_and_padding():
    # per-op input/output halo extents and padding (include/cudecomp.h:545-632)
    grid = make_grid_for((8, 8, 8), (2, 2))
    x_global = T.global_index_field(grid.gdims)
    ih, oh = (1, 2, 0), (0, 1, 1)
    ip, op_ = (0, 0, 2), (1, 0, 0)
    buf = cd.scatter_global(grid, x_global, 0, halo_extents=ih, padding=ip)
    out = cd.transpose_x_to_y(grid, buf, input_halo_extents=ih,
                              output_halo_extents=oh, input_padding=ip,
                              output_padding=op_)
    got = cd.gather_global(grid, out, 1, halo_extents=oh, padding=op_)
    np.testing.assert_allclose(got, x_global)
    # output halo regions are zero-initialized
    mask = cd.valid_interior_mask(grid, 1, halo_extents=oh, padding=op_)
    host = np.asarray(jax.device_get(out))
    assert np.all(host[~mask] == 0)


def test_transpose_asymmetric_halos_uneven():
    grid = make_grid_for((9, 10, 11), (2, 2),
                         transpose_axis_contiguous=(True, True, True))
    x_global = T.global_index_field(grid.gdims)
    ih, oh = (1, 3, 2), (2, 1, 0)
    buf = cd.scatter_global(grid, x_global, 1, halo_extents=ih)
    out = cd.transpose_y_to_z(grid, buf, input_halo_extents=ih,
                              output_halo_extents=oh)
    got = cd.gather_global(grid, out, 2, halo_extents=oh)
    np.testing.assert_allclose(got, x_global)


def test_slab_no_comm_paths():
    # 1x1 degenerate: everything local (transpose.h:326-362 analog)
    roundtrip_check(make_grid_for((8, 9, 10), (1, 1)))
    roundtrip_check(make_grid_for((8, 9, 10), (1, 1),
                                  transpose_axis_contiguous=(True, True, True)))


def test_empty_pencil_rejected():
    grid = make_grid_for((2, 2, 8), (4, 1))
    x = jnp.zeros(grid.global_shape(0))
    with pytest.raises(ValueError, match="empty pencil"):
        cd.transpose_x_to_y(grid, x)


def test_shape_mismatch_rejected():
    grid = make_grid_for((8, 8, 8), (2, 2))
    with pytest.raises(ValueError, match="does not match"):
        cd.transpose_x_to_y(grid, jnp.zeros((7, 8, 8)))
    with pytest.raises(ValueError, match="does not match"):
        cd.transpose_x_to_y(grid, jnp.zeros((8, 8)))  # rank too low
    with pytest.raises(ValueError, match="does not match"):
        cd.transpose_y_to_z(grid, jnp.zeros((4, 4, 4)))
    # trailing component dims are allowed
    out = cd.transpose_x_to_y(grid, jnp.zeros((8, 8, 8, 3)))
    assert out.shape == (8, 8, 8, 3)


def test_jit_and_grad():
    # ops are jittable and differentiable (functional bonus vs reference)
    grid = make_grid_for((8, 8, 8), (2, 2))
    x_global = T.global_index_field(grid.gdims)
    buf = cd.scatter_global(grid, x_global, 0)

    @jax.jit
    def f(b):
        y = cd.transpose_x_to_y(grid, b)
        return cd.transpose_y_to_z(grid, y)

    out = f(buf)
    np.testing.assert_allclose(cd.gather_global(grid, out, 2), x_global)

    def loss(b):
        return jnp.sum(cd.transpose_x_to_y(grid, b) ** 2)

    g = jax.grad(loss)(buf)
    np.testing.assert_allclose(np.asarray(jax.device_get(g)),
                               2 * np.asarray(jax.device_get(buf)))


@pytest.mark.parametrize("pdims", [(4, 1), (2, 4), (3, 1)])
def test_ring_xor_schedule(pdims):
    # XOR pairwise schedule for power-of-two sizes; increment-ring fallback
    # for the (3,1) non-power-of-two case
    roundtrip_check(make_grid_for((8, 9, 10), pdims),
                    method=cd.TransposeMethod.RING_XOR)


def test_pipelined_gdims_dist():
    # gdims_dist excess tacks onto the last pencil -> uneven scatter splits;
    # RING_PIPELINED's uneven per-peer pipeline must stay exact here
    grid = make_grid_for((12, 8, 8), (2, 2), gdims_dist=(8, 8, 8))
    f = T.global_index_field((12, 8, 8))
    x = cd.scatter_global(grid, f, 0)
    y = cd.transpose_x_to_y(grid, x, method=TransposeMethod.RING_PIPELINED)
    np.testing.assert_array_equal(cd.gather_global(grid, y, 1), f)
    back = cd.transpose_y_to_x(grid, y, method=TransposeMethod.RING_PIPELINED)
    np.testing.assert_array_equal(cd.gather_global(grid, back, 0), f)


def test_clear_plan_caches_releases_and_recompiles():
    # autotune-candidate grids pin compiled shard_map programs in the
    # builder caches; clear_plan_caches drops them and live grids simply
    # recompile on next use (reference: graph cache cleared between
    # autotune configs, autotune.cc:629)
    from cudecomp_tpu.ops.transpose import _build_transpose_fn

    grid = make_grid_for((8, 8, 8), (2, 4))
    f = np.random.default_rng(0).standard_normal((8, 8, 8))
    x = cd.scatter_global(grid, f, 0)
    y = cd.transpose_x_to_y(grid, x)
    assert _build_transpose_fn.cache_info().currsize > 0
    cd.clear_plan_caches()
    assert _build_transpose_fn.cache_info().currsize == 0
    y2 = cd.transpose_x_to_y(grid, x)  # recompiles fine
    np.testing.assert_allclose(np.asarray(y2), np.asarray(y))


def _grid_1d(gdims, n=4, **cfg_kw):
    """Slab grid on a genuinely single-axis mesh (pdims (n, 1), the pc
    axis omitted from the mesh)."""
    from jax.sharding import Mesh
    cfg = GridConfig(gdims=gdims, pdims=(n, 1), **cfg_kw)
    mesh = Mesh(np.array(jax.devices()[:n]), ("pr",))
    return cd.make_grid(cfg, mesh=mesh)


def test_1d_mesh_all_methods_oracle():
    # the relaxed 1D-mesh GridDescriptor is correct for every strategy
    gdims = (8, 12, 16)
    f = T.global_index_field(gdims)
    for m in (TransposeMethod.ALL_TO_ALL, TransposeMethod.RING,
              TransposeMethod.RING_PIPELINED):
        grid = _grid_1d(gdims)
        x = cd.scatter_global(grid, f, 0)
        y = cd.transpose_x_to_y(grid, x, method=m)
        np.testing.assert_allclose(cd.gather_global(grid, y, 1), f,
                                   err_msg=str(m))
        z = cd.transpose_y_to_z(grid, y, method=m)  # pc=1: slab elision
        np.testing.assert_allclose(cd.gather_global(grid, z, 2), f,
                                   err_msg=str(m))


def test_net_perm():
    from cudecomp_tpu.ops.transpose import _net_perm

    cfg = GridConfig(gdims=(16, 24, 32), pdims=(1, 1),
                     transpose_axis_contiguous=(True, True, True))
    cyc = {(1, 2, 0), (2, 0, 1)}
    for a, d in ((0, +1), (1, +1), (2, -1), (1, -1)):
        assert _net_perm(cfg, a, d) in cyc
    # natural layout: nets are identity (single-device transposes are no-ops)
    cfg_n = GridConfig(gdims=(16, 24, 32), pdims=(1, 1))
    for a, d in ((0, +1), (1, +1), (2, -1), (1, -1)):
        assert _net_perm(cfg_n, a, d) == (0, 1, 2)


_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


@pytest.mark.parametrize("dtype", [np.float32, np.complex64, jnp.bfloat16])
@pytest.mark.parametrize("perm", _PERMS)
def test_local_permute_matches_numpy(perm, dtype):
    # one device, natural X pencil, Y pencil stored in order ``perm``: the
    # X->Y transpose is exactly one local permute (XLA's transpose), whose
    # output buffer must equal np.transpose of the input
    from cudecomp_tpu.ops.transpose import _net_perm

    gd = (6, 10, 14)
    cfg = GridConfig(gdims=gd, pdims=(1, 1),
                     transpose_mem_order=((0, 1, 2), perm, (0, 1, 2)))
    grid = cd.make_grid(cfg, devices=jax.devices()[:1])
    assert _net_perm(cfg, 0, +1) == perm
    f = np.arange(np.prod(gd)).reshape(gd) % 251
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        f = f + 1j * (f[::-1] % 7)
    f = np.asarray(f).astype(dtype)
    x = jax.device_put(f, grid.sharding(0))
    y = cd.transpose_x_to_y(grid, x)
    assert y.dtype == x.dtype
    np.testing.assert_array_equal(np.asarray(y), np.transpose(f, perm))
