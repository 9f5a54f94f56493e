"""cudecomp_tpu — a JAX pencil-decomposition library.

A ground-up JAX/XLA rebuild of the capabilities of NVIDIA/cuDecomp: 1D slab
and 2D pencil decompositions of 3D Cartesian grids over a 2D device mesh, the
full global transpose set (X<->Y, Y<->Z), halo-exchange routines, a
distributed 3D FFT (c2c/r2c), and a runtime autotuner that jointly searches
process-grid shape x transpose strategy x memory layout from compiled-program
timings.

Design stance (a rebuild, not a port):
  * the process grid is a ``jax.sharding.Mesh`` with axes ``('pr', 'pc')``;
  * the NCCL/NVSHMEM/CUDA-aware-MPI backend zoo of the reference collapses to
    XLA collectives: ``lax.all_to_all`` (one-shot) and ``lax.ppermute`` rings
    (pipelined analog), which XLA hands to NCCL on GPUs;
  * local FFTs are ``jnp.fft`` (cuFFT on GPUs); pack/unpack/local-permute
    work is fused by XLA;
  * everything is functional and jittable; there are no streams, events,
    workspaces or allocators — XLA owns buffers.  Workspace-size queries are
    kept as diagnostics for parity with the reference API.

Public API parity map (reference -> here):
  cudecompInit/Finalize              -> (not needed; JAX runtime)  init() kept as no-op hook
  cudecompGridDescCreate             -> make_grid() / GridDescriptor
  cudecompGetPencilInfo              -> GridDescriptor.pencil_info() / get_pencil_info()
  cudecompTranspose{XToY,...}        -> transpose_x_to_y(), ... (ops.transpose)
  cudecompUpdateHalos{X,Y,Z}         -> update_halos() (ops.halo)
  cudecompGetShiftedRank             -> get_shifted_rank()
  cudecompGet*WorkspaceSize          -> transpose_workspace_size(), halo_workspace_size()
  autotune.cc                        -> autotune() (autotune.py)
"""

from cudecomp_tpu.config import (
    GridConfig,
    TransposeMethod,
    HaloMethod,
    RankOrder,
    AutotuneOptions,
)
from cudecomp_tpu.geometry import (
    PencilInfo,
    get_splits,
    get_split_offsets,
    get_pencil_info,
    get_shifted_rank,
    pencil_buffer_shape,
    global_buffer_shape,
    transpose_workspace_size,
    halo_workspace_size,
)
from cudecomp_tpu.grid import (GridDescriptor, make_grid,
                               clear_plan_caches, init, finalize)
from cudecomp_tpu.ops.transpose import (
    transpose_x_to_y,
    transpose_y_to_x,
    transpose_y_to_z,
    transpose_z_to_y,
)
from cudecomp_tpu.ops.halo import update_halos
from cudecomp_tpu.ops.stencil import (laplacian7, diffusion_step, halo_map,
                                      stencil_apply)
from cudecomp_tpu.ops import fft
from cudecomp_tpu.ops.fft import (DistributedFFT, autotune_fft,
                                  fft3d, ifft3d)
from cudecomp_tpu.ops.spectral import (SpectralOperators, wavenumber_fields,
                                       dealias_mask)
from cudecomp_tpu.autotune import autotune, AutotuneResult
from cudecomp_tpu import performance
from cudecomp_tpu.performance import (perf_report_enable, profile_trace,
                                      segment_roundtrip)
from cudecomp_tpu.utils import checkpoint
from cudecomp_tpu.utils.arrays import (
    scatter_global,
    gather_global,
    valid_interior_mask,
)

__version__ = "0.1.0"

__all__ = [
    "GridConfig",
    "TransposeMethod",
    "HaloMethod",
    "RankOrder",
    "AutotuneOptions",
    "PencilInfo",
    "get_splits",
    "get_split_offsets",
    "get_pencil_info",
    "get_shifted_rank",
    "pencil_buffer_shape",
    "global_buffer_shape",
    "transpose_workspace_size",
    "halo_workspace_size",
    "GridDescriptor",
    "make_grid",
    "transpose_x_to_y",
    "transpose_y_to_x",
    "transpose_y_to_z",
    "transpose_z_to_y",
    "update_halos",
    "laplacian7",
    "diffusion_step",
    "halo_map",
    "stencil_apply",
    "fft",
    "DistributedFFT",
    "autotune_fft",
    "fft3d",
    "clear_plan_caches",
    "init",
    "finalize",
    "SpectralOperators",
    "wavenumber_fields",
    "dealias_mask",
    "ifft3d",
    "autotune",
    "AutotuneResult",
    "performance",
    "perf_report_enable",
    "profile_trace",
    "segment_roundtrip",
    "checkpoint",
    "scatter_global",
    "gather_global",
    "valid_interior_mask",
]
