"""Mesh helpers — slice-aware layout (ICI+DCN hierarchy analog)."""

import numpy as np
import jax
import pytest

import cudecomp_tpu as cd
from cudecomp_tpu.config import GridConfig, RankOrder
from cudecomp_tpu.parallel.mesh import build_decomp_mesh, n_slices
from cudecomp_tpu.utils import testing as T


def test_single_slice_matches_build_mesh():
    mesh = build_decomp_mesh((2, 4), devices=jax.devices()[:8])
    assert mesh.shape == {"pr": 2, "pc": 4}
    # CPU devices all report slice 0 -> plain reshape, row-major ranks
    flat = list(np.array(mesh.devices).reshape(-1))
    assert [d.id for d in flat] == list(range(8))


def test_n_slices_cpu():
    assert n_slices(jax.devices()) == 1


class _FakeDev:
    def __init__(self, i, s):
        self.id = i
        self.slice_index = s

    def __repr__(self):
        return f"d{self.id}s{self.slice_index}"


def test_multi_slice_groups_whole_slices_on_pc():
    # 2 fake slices of 4 devices; pc=4 is NOT divisible by... use pc=2:
    devs = [_FakeDev(i, i // 4) for i in range(8)]
    mesh_arr = build_decomp_mesh((4, 2), devices=devs).devices
    # pc % s == 0: each column c should contain only devices of slice c
    for c in range(2):
        slices = {d.slice_index for d in mesh_arr[:, c]}
        assert slices == {c}, mesh_arr


def test_multi_slice_pr_axis_stays_on_ici():
    # design intent: the pr axis (X<->Y all-to-all, the densest traffic)
    # must stay inside one slice; slices tile the pc axis
    devs = [_FakeDev(i, i // 4) for i in range(8)]
    mesh_arr = build_decomp_mesh((2, 4), devices=devs).devices
    for c in range(4):
        slices = {d.slice_index for d in mesh_arr[:, c]}
        assert len(slices) == 1, mesh_arr


def test_multi_slice_pr_branch_when_pc_indivisible():
    # 2 slices, pdims (4, 1): pc=1 not divisible -> slices tile pr
    devs = [_FakeDev(i, i // 2) for i in range(4)]
    mesh_arr = build_decomp_mesh((4, 1), devices=devs).devices
    assert [d.slice_index for d in mesh_arr[:, 0]] == [0, 0, 1, 1]


def test_grid_on_decomp_mesh_end_to_end():
    mesh = build_decomp_mesh((2, 4), devices=jax.devices()[:8])
    cfg = GridConfig(gdims=(8, 8, 8), pdims=(2, 4))
    grid = cd.GridDescriptor(config=cfg, mesh=mesh)
    f = T.global_index_field((8, 8, 8))
    x = cd.scatter_global(grid, f, 0)
    z = cd.transpose_y_to_z(grid, cd.transpose_x_to_y(grid, x))
    np.testing.assert_allclose(cd.gather_global(grid, z, 2), f)


def test_embedding_in_larger_training_mesh():
    # docs/usage.md "Embedding in a larger training mesh": the decomposition
    # axes are a 2D sub-mesh of a 3D mesh with an extra 'data' axis; all
    # transpose ops must work and a vmapped batch composes correctly
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.array(jax.devices()[:8]).reshape(2, 2, 2)
    mesh = Mesh(devs, ("pr", "pc", "data"))
    cfg = GridConfig(gdims=(8, 12, 16), pdims=(2, 2))
    grid = cd.GridDescriptor(config=cfg, mesh=mesh)
    f = T.global_index_field((8, 12, 16))
    x = cd.scatter_global(grid, f, 0)
    z = cd.transpose_y_to_z(grid, cd.transpose_x_to_y(grid, x))
    back = cd.transpose_y_to_x(grid, cd.transpose_z_to_y(grid, z))
    np.testing.assert_allclose(cd.gather_global(grid, back, 0), f)

    # batched leading dim sharded over 'data' (DP-style), decomposition
    # applied per batch element via vmap
    fb = np.stack([f, 2.0 * f])
    xb = jax.device_put(fb, NamedSharding(mesh, P("data", None, "pr", "pc")))
    yb = jax.vmap(lambda v: cd.transpose_x_to_y(grid, v))(xb)
    y_ref = cd.transpose_x_to_y(grid, x)
    ga = cd.gather_global(grid, yb[0], 1)
    gb = cd.gather_global(grid, yb[1], 1)
    np.testing.assert_allclose(ga, cd.gather_global(grid, y_ref, 1))
    np.testing.assert_allclose(gb, 2.0 * cd.gather_global(grid, y_ref, 1))


class _GpuLikeDev:
    """A GPU device stub: GPUs report no meaningful slice, so the host
    (``process_index``) is their fast-interconnect group."""
    platform = "gpu"

    def __init__(self, i, host):
        self.id = i
        self.process_index = host
        self.slice_index = 0

    def __repr__(self):
        return f"gpu{self.id}h{self.process_index}"


def test_slice_index_groups_gpus_by_host():
    from cudecomp_tpu.parallel.mesh import _slice_index, axis_group_size
    one_host = [_GpuLikeDev(i, 0) for i in range(4)]
    assert {_slice_index(d) for d in one_host} == {0}
    assert n_slices(one_host) == 1
    two_hosts = [_GpuLikeDev(i, i // 4) for i in range(8)]
    assert [_slice_index(d) for d in two_hosts] == [0] * 4 + [1] * 4
    assert n_slices(two_hosts) == 2
    # pc divides the host count: each column holds one host's GPUs, so the
    # row axis stays inside NVLink and ring_hier's group is the host size
    mesh = build_decomp_mesh((4, 2), devices=two_hosts)
    for c in range(2):
        assert {d.process_index for d in mesh.devices[:, c]} == {c}
    assert axis_group_size(mesh, "pr") == 4
    # one host of four GPUs: plain reshape, ring_hier == ring
    mesh1 = build_decomp_mesh((2, 2), devices=one_host)
    assert [d.id for d in mesh1.devices.reshape(-1)] == [0, 1, 2, 3]
    assert axis_group_size(mesh1, "pr") == 2
