"""GridDescriptor — binds a :class:`GridConfig` to a ``jax.sharding.Mesh``.

The analog of ``cudecompGridDescCreate`` (``src/cudecomp.cc:1039-
1269``): where the reference creates row/column MPI communicators, NCCL
communicators and NVSHMEM teams, here the process grid is simply a 2D device
mesh with axes ``(pr, pc)`` and every collective is an XLA op over one of the
two axes.  X<->Y transposes communicate over ``pr`` (the reference's *column*
communicator, ``transpose.h:227``), Y<->Z over ``pc`` (the *row*
communicator).

A GridDescriptor may wrap a caller-provided mesh (including a sub-mesh of a
larger training mesh — the decomposition axes just need to exist by name),
or build one from a device list honoring the configured rank order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cudecomp_tpu.config import GridConfig, RankOrder
from cudecomp_tpu import geometry
from cudecomp_tpu.geometry import PencilInfo, Triple


@dataclasses.dataclass(frozen=True)
class GridDescriptor:
    """A decomposition bound to a device mesh.

    Attributes:
      config: the (possibly autotuned) static grid configuration.
      mesh: mesh holding at least the two decomposition axes.
      axis_names: mesh axis names for (pr, pc).
    """

    config: GridConfig
    mesh: Mesh
    axis_names: Tuple[str, str] = ("pr", "pc")

    def __post_init__(self):
        cfg = self.config
        if cfg.autotune_pdims:
            raise ValueError("GridDescriptor requires resolved pdims; run autotune "
                             "or set pdims explicitly")
        shape = self.mesh.shape
        for name, pd in zip(self.axis_names, cfg.pdims):
            if name not in shape:
                if pd == 1:
                    # a size-1 process-grid axis never shards or
                    # communicates, so a slab decomposition may ride a 1D
                    # mesh that simply omits it (e.g. Mesh(devs, ('pr',))
                    # with pdims (P, 1))
                    continue
                raise ValueError(f"mesh has no axis {name!r}; axes: {tuple(shape)}")
            if shape[name] != pd:
                raise ValueError(
                    f"mesh axis {name!r} has size {shape[name]}, config expects {pd}")

    # -- geometry passthroughs ---------------------------------------------------

    @property
    def pdims(self) -> Tuple[int, int]:
        return self.config.pdims

    @property
    def gdims(self) -> Triple:
        return self.config.gdims

    def pencil_info(self, axis: int, rank: Optional[int] = None,
                    coords: Optional[Tuple[int, int]] = None,
                    halo_extents=None, padding=None) -> PencilInfo:
        """Per-rank pencil info (``cudecompGetPencilInfo`` analog)."""
        if coords is None:
            coords = geometry.coords_of_rank(self.config, 0 if rank is None else rank)
        return geometry.get_pencil_info(self.config, axis, coords,
                                        halo_extents=halo_extents, padding=padding)

    def shifted_rank(self, axis: int, dim: int, displacement: int,
                     periodic: bool, rank: int) -> int:
        return geometry.get_shifted_rank(self.config, axis, dim, displacement,
                                         periodic, rank)

    def buffer_shape(self, axis: int, halo_extents=None, padding=None) -> Triple:
        return geometry.pencil_buffer_shape(self.config, axis, halo_extents, padding)

    def global_shape(self, axis: int, halo_extents=None, padding=None) -> Triple:
        return geometry.global_buffer_shape(self.config, axis, halo_extents, padding)

    # -- sharding ------------------------------------------------------------------

    def spec(self, axis: int) -> P:
        """PartitionSpec of a pencil buffer (memory order) for pencil ``axis``."""
        order = self.config.mem_order(axis)
        names = []
        for i in range(3):
            pd = geometry.shard_pdim_of_dim(axis, order[i])
            name = None if pd is None else self.axis_names[pd]
            if name is not None and name not in self.mesh.shape:
                name = None  # size-1 axis omitted from a 1D mesh
            names.append(name)
        return P(*names)

    def sharding(self, axis: int) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(axis))

    def comm_axis_name(self, ax: int, dir_: int) -> str:
        """Mesh axis over which the transpose (ax -> ax+dir) communicates.

        X<->Y re-shards dims 0/1 over Pr (axis_names[0]); Y<->Z re-shards
        dims 1/2 over Pc (axis_names[1]).  Matches the row/col communicator
        selection in ``transpose.h:222-228``.
        """
        lo_axis = min(ax, ax + dir_)
        return self.axis_names[0] if lo_axis == 0 else self.axis_names[1]


def build_mesh(
    pdims: Tuple[int, int],
    devices: Optional[Sequence[jax.Device]] = None,
    rank_order: RankOrder = RankOrder.ROW_MAJOR,
    axis_names: Tuple[str, str] = ("pr", "pc"),
) -> Mesh:
    """Arrange devices into a (Pr, Pc) mesh honoring the rank order.

    Rank ``r``'s coordinates follow ``geometry.coords_of_rank``: row-major
    ``r = pr*Pc + pc`` (reference default) or column-major ``r = pc*Pr + pr``.
    """
    pr, pc = pdims
    if devices is None:
        devices = jax.devices()
    devices = list(devices)
    if len(devices) < pr * pc:
        raise ValueError(f"need {pr * pc} devices, have {len(devices)}")
    devices = devices[: pr * pc]
    arr = np.array(devices, dtype=object)
    if rank_order == RankOrder.ROW_MAJOR:
        grid = arr.reshape(pr, pc)
    else:
        grid = arr.reshape(pc, pr).T
    return Mesh(grid, axis_names)


def make_grid(
    config: GridConfig,
    devices: Optional[Sequence[jax.Device]] = None,
    mesh: Optional[Mesh] = None,
    axis_names: Tuple[str, str] = ("pr", "pc"),
    autotune_options=None,
    example_dtype=None,
) -> GridDescriptor:
    """Create a GridDescriptor (``cudecompGridDescCreate`` analog).

    With ``pdims == (0, 0)`` the autotuner sweeps process-grid factor pairs
    (and optionally transpose strategies) on real compiled-program timings
    and freezes the winner into the returned descriptor — the analog of
    ``src/cudecomp.cc:1200-1211`` dispatching into ``autotune.cc``.
    """
    if config.autotune_pdims or (
            autotune_options is not None and autotune_options.autotune_transpose_method):
        if mesh is not None:
            # the sweep builds its own candidate meshes over `devices`;
            # silently dropping a caller mesh (e.g. a sub-mesh of a
            # training mesh) would tune on the wrong device set and
            # return a grid not bound to the caller's mesh
            raise ValueError(
                "make_grid: autotuning with an explicit mesh is not "
                "supported — pass devices= instead, or autotune first "
                "and bind the winning config to your mesh via "
                "GridDescriptor(config=result.grid.config, mesh=mesh)")
        from cudecomp_tpu.autotune import autotune  # circular-import guard
        result = autotune(config, devices=devices, options=autotune_options,
                          axis_names=axis_names, dtype=example_dtype)
        return result.grid
    if mesh is None:
        mesh = build_mesh(config.pdims, devices=devices,
                          rank_order=config.rank_order, axis_names=axis_names)
    return GridDescriptor(config=config, mesh=mesh, axis_names=axis_names)


def clear_plan_caches() -> None:
    """Drop every cached compiled plan (transpose / FFT stage / halo /
    stencil builders).

    The reference pairs its CUDA-graph cache with grid-descriptor destroy
    (``graph.h:37-51``; the autotuner clears it between trial configs,
    ``autotune.cc:629``).  Functional JAX has no destroy hook, so
    throwaway :class:`GridDescriptor` objects — autotune sweep candidates,
    short-lived grids in long processes — pin their compiled ``shard_map``
    programs (and the mesh/device objects they close over) in the builder
    LRU caches until natural eviction.  Calling this releases them all;
    live grids simply recompile their plans on next use.
    """
    from cudecomp_tpu.ops import fft, halo, stencil, transpose
    transpose._build_transpose_fn.cache_clear()
    fft._build_local_fft.cache_clear()
    halo._build_halo_fn.cache_clear()
    stencil._stencil_apply_fn.cache_clear()
    stencil._diff_apply_fn.cache_clear()


def init() -> None:
    """No-op migration hook (``cudecompInit`` analog, cudecomp.h:249).

    The JAX runtime owns device/communicator lifetime, so there is
    nothing to initialize; the hook exists so ported applications keep
    their init/finalize call structure.  Raises early with a clear error
    if no devices are visible (the closest analog of the reference's
    init-time failure modes)."""
    if not jax.devices():
        raise RuntimeError("cudecomp_tpu.init: no JAX devices visible")


def finalize() -> None:
    """No-op migration hook (``cudecompFinalize`` analog, cudecomp.h:268).

    Drops the library's cached compiled plans (the only state the
    rebuild holds outside XLA's own management)."""
    clear_plan_caches()
