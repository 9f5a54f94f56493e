"""cuDecomp-named compatibility layer (cudecomp_tpu.compat) — a ported
reference application's call structure must work end-to-end.

The flow below is the reference's basic_usage example shape
(examples/cc/basic_usage/basic_usage.cc): init -> config defaults ->
grid-desc create -> pencil info -> transpose cycle -> halo update ->
finalize, under the original entry-point names."""

import numpy as np
import pytest
import jax

import cudecomp_tpu as cd
from cudecomp_tpu import compat as cc
from cudecomp_tpu.config import HaloMethod, TransposeMethod


def test_ported_basic_usage_flow():
    handle = cc.cudecompInit()

    config = cc.cudecompGridDescConfigSetDefaults()
    config.gdims = (16, 20, 24)
    config.pdims = (2, 2)
    config.transpose_comm_backend = cc.CUDECOMP_TRANSPOSE_COMM_MPI_A2A
    grid = cc.cudecompGridDescCreate(handle, config,
                                     devices=jax.devices()[:4])
    assert grid.config.transpose_method == TransposeMethod.ALL_TO_ALL

    pinfo = cc.cudecompGetPencilInfo(handle, grid, 0)
    assert pinfo.size == int(np.prod(pinfo.shape))

    f = np.arange(np.prod(config.gdims), dtype=np.float64).reshape(
        config.gdims)
    x = cd.scatter_global(grid, f, 0)
    y = cc.cudecompTransposeXToY(handle, grid, x)
    z = cc.cudecompTransposeYToZ(handle, grid, y)
    y2 = cc.cudecompTransposeZToY(handle, grid, z)
    x2 = cc.cudecompTransposeYToX(handle, grid, y2)
    np.testing.assert_array_equal(cd.gather_global(grid, x2, 0), f)

    he = (1, 1, 1)
    h = np.zeros(grid.global_shape(0, halo_extents=he))
    h = jax.device_put(h, grid.sharding(0))
    h2 = cc.cudecompUpdateHalosX(handle, grid, h, halo_extents=he,
                                 halo_periods=(True, True, True))
    assert h2.shape == h.shape

    r = cc.cudecompGetShiftedRank(handle, grid, 0, 1, 1, True, rank=0)
    assert 0 <= r < 4
    # off-domain, non-periodic: -1 like the reference
    assert cc.cudecompGetShiftedRank(handle, grid, 0, 1, 99, False,
                                     rank=0) == -1

    # workspace-size queries: reference formulas, element counts
    assert cc.cudecompGetTransposeWorkspaceSize(handle, grid) > 0
    assert cc.cudecompGetHaloWorkspaceSize(handle, grid, 0, he) > 0
    assert cc.cudecompGetDataTypeSize(cc.CUDECOMP_FLOAT) == 4
    assert cc.cudecompGetDataTypeSize(cc.CUDECOMP_DOUBLE_COMPLEX) == 16

    # no-op allocation surface
    assert cc.cudecompMalloc(handle, grid, 1024) is None
    assert cc.cudecompFree(handle, grid, None) is None

    cc.cudecompGridDescDestroy(handle, grid)
    cc.cudecompFinalize(handle)


def test_backend_enum_mapping():
    for be, m in [(cc.CUDECOMP_TRANSPOSE_COMM_MPI_P2P, TransposeMethod.RING),
                  (cc.CUDECOMP_TRANSPOSE_COMM_MPI_P2P_PL,
                   TransposeMethod.RING_PIPELINED),
                  (cc.CUDECOMP_TRANSPOSE_COMM_NCCL, TransposeMethod.RING_XOR),
                  (cc.CUDECOMP_TRANSPOSE_COMM_NVSHMEM,
                   TransposeMethod.ALL_TO_ALL)]:
        config = cc.cudecompGridDescConfigSetDefaults()
        config.gdims = (8, 8, 8)
        config.pdims = (2, 2)
        config.transpose_comm_backend = be
        g = cc.cudecompGridDescCreate(None, config,
                                      devices=jax.devices()[:4])
        assert g.config.transpose_method == m
    config = cc.cudecompGridDescConfigSetDefaults()
    config.gdims = (8, 8, 8)
    config.pdims = (2, 2)
    config.halo_comm_backend = cc.CUDECOMP_HALO_COMM_NVSHMEM
    g = cc.cudecompGridDescCreate(None, config, devices=jax.devices()[:4])
    assert g.config.halo_method == HaloMethod.PPERMUTE


@pytest.mark.parametrize("name,kind,method", [
    ("CUDECOMP_TRANSPOSE_COMM_NVSHMEM", "transpose",
     TransposeMethod.ALL_TO_ALL),
    ("CUDECOMP_TRANSPOSE_COMM_NVSHMEM_SM", "transpose",
     TransposeMethod.ALL_TO_ALL),
    ("CUDECOMP_TRANSPOSE_COMM_NVSHMEM_PL", "transpose",
     TransposeMethod.RING_PIPELINED),
    ("CUDECOMP_HALO_COMM_NVSHMEM", "halo", HaloMethod.PPERMUTE),
    ("CUDECOMP_HALO_COMM_NVSHMEM_BLOCKING", "halo", HaloMethod.PPERMUTE),
])
def test_nvshmem_backends_map_to_nccl_collectives(name, kind, method):
    # device-initiated NVSHMEM puts have no JAX route: each NVSHMEM backend
    # runs on the NCCL-backed collective that plays its role
    config = cc.cudecompGridDescConfigSetDefaults()
    config.gdims = (8, 8, 8)
    config.pdims = (2, 2)
    if kind == "transpose":
        config.transpose_comm_backend = getattr(cc, name)
    else:
        config.halo_comm_backend = getattr(cc, name)
    g = cc.cudecompGridDescCreate(None, config, devices=jax.devices()[:4])
    got = (g.config.transpose_method if kind == "transpose"
           else g.config.halo_method)
    assert got == method


def test_autotune_copies_config_back():
    # reference copies the autotuned config back into the caller's struct
    # (src/cudecomp.cc:1248-1265)
    handle = cc.cudecompInit()
    config = cc.cudecompGridDescConfigSetDefaults()
    config.gdims = (16, 16, 16)
    config.pdims = (0, 0)
    options = cc.cudecompGridDescAutotuneOptionsSetDefaults()
    options.n_warmup_trials = 0
    options.n_trials = 1
    options.autotune_transpose_backend = True
    options.disable_nccl_backends = True
    options.disable_nvshmem_backends = True
    grid = cc.cudecompGridDescCreate(handle, config, options)
    assert tuple(config.pdims) == tuple(grid.pdims)
    assert config.transpose_comm_backend in (
        cc.CUDECOMP_TRANSPOSE_COMM_MPI_P2P,
        cc.CUDECOMP_TRANSPOSE_COMM_MPI_P2P_PL,
        cc.CUDECOMP_TRANSPOSE_COMM_MPI_A2A)
    rt = cc.cudecompGetGridDescConfig(handle, grid)
    assert tuple(rt.pdims) == tuple(grid.pdims)
    cc.cudecompFinalize(handle)


def test_all_families_disabled_rejected():
    options = cc.cudecompGridDescAutotuneOptionsSetDefaults()
    options.disable_mpi_backends = True
    options.disable_nccl_backends = True
    options.disable_nvshmem_backends = True
    options.autotune_transpose_backend = True
    config = cc.cudecompGridDescConfigSetDefaults()
    config.gdims = (16, 16, 16)
    with pytest.raises(ValueError, match="disabled"):
        cc.cudecompGridDescCreate(None, config, options)


def test_per_op_payloads_translate():
    # per-op trial payloads (cudecomp.h:195-208) thread through to the
    # native options and the sweep runs with them
    options = cc.cudecompGridDescAutotuneOptionsSetDefaults()
    he = ((1, 1, 1),) * 4
    options.transpose_input_halo_extents = he
    options.transpose_output_halo_extents = he
    options.n_warmup_trials = 0
    options.n_trials = 1
    config = cc.cudecompGridDescConfigSetDefaults()
    config.gdims = (16, 16, 16)
    config.pdims = (0, 0)
    grid = cc.cudecompGridDescCreate(None, config, options)
    assert tuple(config.pdims) == tuple(grid.pdims)
