"""Compile-level checks: the engine must lower to the intended XLA
collectives — the analog of asserting the reference called the
right backend primitive (NCCL grouped send/recv vs MPI_Alltoall etc.).

These inspect optimized HLO text, so they catch regressions like a slab
transpose accidentally emitting a collective, or a ring strategy collapsing
into one fused all-to-all.
"""

import numpy as np
import pytest
import jax

import cudecomp_tpu as cd
from cudecomp_tpu.config import GridConfig, TransposeMethod


def lowered_hlo(grid, method, ax_fn=None):
    fn = ax_fn or (lambda a: cd.transpose_x_to_y(grid, a, method=method))
    x = jax.device_put(np.zeros(grid.global_shape(0), np.float32),
                       grid.sharding(0))
    return jax.jit(fn).lower(x).compile().as_text()


def count(hlo, op):
    return sum(1 for line in hlo.splitlines() if f" {op}(" in line
               or f" {op}-start(" in line)


def make(gdims, pdims, **kw):
    return cd.make_grid(GridConfig(gdims=gdims, pdims=pdims, **kw),
                        devices=jax.devices()[: pdims[0] * pdims[1]])


def test_all_to_all_lowers_to_one_a2a():
    grid = make((8, 8, 8), (2, 4))
    hlo = lowered_hlo(grid, TransposeMethod.ALL_TO_ALL)
    assert count(hlo, "all-to-all") == 1
    assert count(hlo, "collective-permute") == 0


def test_ring_lowers_to_p_minus_1_permutes():
    grid = make((8, 8, 8), (4, 2))  # X<->Y over pr: P=4 -> 3 steps
    hlo = lowered_hlo(grid, TransposeMethod.RING)
    assert count(hlo, "all-to-all") == 0
    assert count(hlo, "collective-permute") == 3


def test_ring_pipelined_lowers_to_p_minus_1_permutes():
    grid = make((8, 8, 8), (4, 2))
    hlo = lowered_hlo(grid, TransposeMethod.RING_PIPELINED)
    assert count(hlo, "all-to-all") == 0
    assert count(hlo, "collective-permute") == 3


def test_ring_pipelined_uneven_is_per_chunk():
    # non-divisible extents ride the TRUE per-peer pipeline (pad-to-max
    # chunks, masked-add unpack), not the block-ring fallback: still P-1
    # permutes, and each permute moves ONE Bs-chunk (Bs=3 of 9 over P=4),
    # not the P*Bs packed buffer the block ring exchanges per step
    import re
    grid = make((9, 10, 11), (4, 2))  # X<->Y over pr: P=4, splits (3,2,2,2)
    hlo = lowered_hlo(grid, TransposeMethod.RING_PIPELINED)
    assert count(hlo, "all-to-all") == 0
    assert count(hlo, "collective-permute") == 3
    sizes = set()
    for line in hlo.splitlines():
        if " collective-permute(" in line or " collective-permute-start(" in line:
            m = re.search(r"f32\[([0-9,]+)\]", line)
            assert m, line
            dims = [int(v) for v in m.group(1).split(",")]
            sizes.add(int(np.prod(dims)))
    # local x-pencil is (9, 3, 6): X full, Y split 10->(3,3,2,2) by pr,
    # Z split 11->(6,5) by pc, both carried pad-to-max.  A pipeline chunk
    # is Bs=3 of the 9 X-rows -> 3*3*6 = 54 elements per permute; the
    # block ring would exchange the whole P*Bs packed buffer (216) per
    # step instead
    assert sizes == {3 * 3 * 6}


def test_slab_transpose_is_collective_free():
    # X<->Y over pr == 1: pure local reorder, no communication at all
    grid = make((8, 8, 8), (1, 8))
    hlo = lowered_hlo(grid, TransposeMethod.ALL_TO_ALL)
    for op in ("all-to-all", "collective-permute", "all-gather",
               "reduce-scatter", "all-reduce"):
        assert count(hlo, op) == 0, op


def test_halo_lowers_to_paired_permutes():
    grid = make((8, 8, 8), (2, 2))
    he = (0, 1, 0)

    def fn(a):
        return cd.update_halos(grid, a, 0, he, (True, True, True))

    x = jax.device_put(
        np.zeros(grid.global_shape(0, halo_extents=he), np.float32),
        grid.sharding(0))
    hlo = jax.jit(fn).lower(x).compile().as_text()
    # one +1 shift and one -1 shift
    assert count(hlo, "collective-permute") == 2
    assert count(hlo, "all-to-all") == 0


def test_fft_roundtrip_collective_budget():
    # 2x4 pencil c2c forward+inverse: exactly 4 transposes' worth of
    # all-to-alls, nothing else
    grid = make((8, 8, 8), (2, 4))
    plan = cd.DistributedFFT(grid=grid, split_complex=True)

    def fn(a):
        return plan.inverse(plan.forward(a))

    x = jax.device_put(np.zeros(grid.global_shape(0) + (2,), np.float32),
                       grid.sharding(0))
    hlo = jax.jit(fn).lower(x).compile().as_text()
    assert count(hlo, "all-to-all") == 4
    assert count(hlo, "collective-permute") == 0


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("pdims", [(2, 2), (1, 4)])
def test_fft_stages_stay_local(real, pdims, monkeypatch):
    # the XLA FFT op (the GPU path, forced here on the CPU mesh) runs per
    # shard: the forward lowers to the transposes' all-to-alls and never
    # gathers the array onto one device
    from cudecomp_tpu.ops import fft as F
    monkeypatch.setattr(F, "_use_matmul_complex", lambda mesh: False)
    grid = make((16, 16, 8), pdims)
    plan = cd.DistributedFFT(grid=grid, real=real)
    dtype = np.float32 if real else np.complex64
    x = jax.device_put(np.zeros(grid.global_shape(0), dtype),
                       grid.sharding(0))
    hlo = jax.jit(plan.forward).lower(x).compile().as_text()
    assert count(hlo, "all-gather") == 0
    assert count(hlo, "all-to-all") >= 1
    f = np.random.default_rng(1).standard_normal((16, 16, 8))
    f = f.astype(np.float32) if real else (f + 1j * f[::-1]).astype(dtype)
    got = cd.gather_global(plan.complex_grid,
                           plan.forward(cd.scatter_global(grid, f, 0)), 2)
    ref = (np.fft.fftn(np.fft.rfft(f, axis=0), axes=(1, 2)) if real
           else np.fft.fftn(f))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
