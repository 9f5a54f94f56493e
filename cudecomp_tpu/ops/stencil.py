"""Ghost-plane stencil pipeline — the halo -> stencil consumer path.

The reference's halo engine exists to serve stencil applications:
exchange ghost cells into a halo'd buffer, then apply a local stencil
(``include/internal/halo.h:40-315``; ``docs/basic_usage.rst`` halo
discussion).  ``update_halos`` reproduces that buffer contract for API
parity; this module is the functional form, with no persistent halo
regions in the user's arrays:

* state stays in the plain interior pencil layout (no halo regions);
* ghost planes are exchanged per shard — ``lax.ppermute`` shifts over
  the mesh axis that shards each dim (NCCL send/recv on GPUs), local
  wrap-around slices for unsharded periodic dims, zeros at non-periodic
  edges (``ppermute`` delivers zeros to ranks without a source, which is
  exactly the Dirichlet-0 ghost convention);
* the stencil is a sum of shifted slices of the ghost-extended block,
  which XLA fuses into one elementwise pass over the output; on GPU
  meshes (float32, extents that tile) a Pallas kernel on the Triton
  route computes it instead, wrapping local periodic dims by index so
  only the other dims need ghost planes.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from cudecomp_tpu.parallel.collectives import shard_map_fn
from cudecomp_tpu.utils.tracing import trace_range

__all__ = ["laplacian7", "diffusion_step", "halo_map", "stencil_apply"]


def _local_extents(grid, axis: int) -> Tuple[int, int, int]:
    """Per-shard interior extents in buffer (memory) order; raises on
    non-divisible sharded extents (the ghost-plane pipeline has no
    pad-to-max machinery — use ``update_halos`` for ragged grids)."""
    cfg = grid.config
    order = cfg.mem_order(axis)
    spec = grid.spec(axis)
    ext = []
    for i in range(3):
        g = cfg.gdims[order[i]]
        name = spec[i]
        P = grid.mesh.shape[name] if name is not None else 1
        if g % P:
            raise ValueError(
                f"ghost-plane stencil requires divisible extents; global dim "
                f"{order[i]} has {g} over {P} shards (use update_halos for "
                f"uneven grids)")
        ext.append(g // P)
    return tuple(ext)


def _extend_dim(ul, d, w, name, P, periodic):
    """Extend a local block by ``w`` ghost planes on both sides of dim
    ``d`` (neighbor slabs via paired ppermute, local wrap when the dim is
    unsharded, zero ghosts at non-periodic edges)."""
    n = ul.shape[d]
    lo_slab = lax.slice_in_dim(ul, 0, w, axis=d)
    hi_slab = lax.slice_in_dim(ul, n - w, n, axis=d)
    if P == 1:
        if periodic:
            lo, hi = hi_slab, lo_slab
        else:
            lo, hi = jnp.zeros_like(hi_slab), jnp.zeros_like(lo_slab)
    else:
        fwd = [(j, (j + 1) % P) for j in range(P)]
        bwd = [(j, (j - 1) % P) for j in range(P)]
        if not periodic:
            fwd, bwd = fwd[:-1], bwd[1:]
        lo = lax.ppermute(hi_slab, name, fwd)
        hi = lax.ppermute(lo_slab, name, bwd)
    return jnp.concatenate([lo, ul, hi], axis=d)


def halo_map(grid, u, fn, axis: int = 0, width=1,
             halo_periods=(True, True, True)):
    """Apply a user stencil ``fn`` to each shard's block extended by ghost
    cells — the functional, width-generic form of the reference's
    halo'd-buffer contract (``cudecompUpdateHalos`` + user stencil,
    halo.h:40-315) with no persistent halo regions in the user's arrays.

    ``u`` is a halo-free pencil-``axis`` array; each shard's local block
    of shape ``(mx, my, mz)`` is extended to ``(mx+2wx, my+2wy, mz+2wz)``
    with neighbor data (``width`` may be an int or a per-memory-dim
    triple; dims are extended sequentially, so corner/edge ghosts compose
    exactly like successive reference halo calls), and ``fn`` maps the
    extended block back to ``(mx, my, mz)``.  Trailing component dims
    (vector fields, ``(..., C)``) pass through unsharded and unextended —
    ``fn`` sees them and may CHANGE them (vector -> scalar divergence,
    scalar -> vector gradient); the output component dims are probed
    abstractly via ``jax.eval_shape``.  Non-periodic edges see zero
    ghosts (Dirichlet); sharded extents must divide evenly.

    This is the engine behind :func:`stencil_apply` and
    :func:`laplacian7`; use it directly for higher-order or anisotropic
    stencils.
    """
    cfg = grid.config
    if axis not in (0, 1, 2):
        raise ValueError(f"axis out of range: {axis}")
    if u.ndim < 3:
        raise ValueError("halo_map expects a 3D pencil array (plus "
                         "optional trailing component dims)")
    widths = ((int(width),) * 3 if np.isscalar(width)
              else tuple(int(w) for w in width))
    if len(widths) != 3 or any(w < 0 for w in widths):
        raise ValueError(f"invalid width {width!r}")
    periods = tuple(bool(p) for p in halo_periods)
    if len(periods) != 3:
        raise ValueError("halo_periods must have length 3")
    expected = grid.global_shape(axis)
    if tuple(u.shape[:3]) != expected:
        raise ValueError(
            f"halo_map: input shape {tuple(u.shape)} does not match the "
            f"halo-free pencil layout {expected}")
    comp = tuple(u.shape[3:])
    interior = _local_extents(grid, axis)
    for d in range(3):
        if widths[d] > interior[d]:
            raise ValueError(
                f"ghost width {widths[d]} exceeds the local extent "
                f"{interior[d]} of memory dim {d} (halo.h:120-145 analog)")
    order = cfg.mem_order(axis)
    periods_mem = tuple(periods[order[d]] for d in range(3))
    from jax.sharding import PartitionSpec
    spec = grid.spec(axis)
    if comp:
        spec = PartitionSpec(*spec, *([None] * len(comp)))
    ndev_by_name = dict(grid.mesh.shape)

    # ``fn`` may CHANGE the trailing component dims (vector -> scalar
    # divergence, scalar -> vector gradient): probe its output shape
    # abstractly on the extended block to build the output spec
    ext_shape = tuple(interior[d] + 2 * widths[d] for d in range(3)) + comp
    out_aval = jax.eval_shape(fn, jax.ShapeDtypeStruct(ext_shape, u.dtype))
    if tuple(out_aval.shape[:3]) != interior:
        raise ValueError(
            f"halo_map fn returned spatial shape {tuple(out_aval.shape)}; "
            f"expected the interior block extents {interior} (+ any "
            f"trailing component dims)")
    ext = interior + tuple(out_aval.shape[3:])
    out_spec = PartitionSpec(*grid.spec(axis),
                             *([None] * (out_aval.ndim - 3)))

    def local_fn(ul):
        for d in range(3):
            if widths[d] == 0:
                continue
            name = spec[d]
            P = ndev_by_name.get(name, 1) if name is not None else 1
            ul = _extend_dim(ul, d, widths[d], name, P, periods_mem[d])
        out = fn(ul)
        if tuple(out.shape) != ext:
            raise ValueError(
                f"halo_map fn returned shape {tuple(out.shape)}; expected "
                f"the interior block shape {ext}")
        return out

    with trace_range(f"cudecomp_tpu.halo_map_axis{axis}"):
        return shard_map_fn(local_fn, grid.mesh, in_specs=(spec,),
                            out_specs=out_spec)(u)


def stencil_apply(grid, u, weights, axis: int = 0,
                  halo_periods=(True, True, True)):
    """Apply an arbitrary compact 3x3x3 stencil to a halo-free pencil
    array: ``out[i,j,k] = sum_{d} weights[1+dx,1+dy,1+dz] *
    u[i+dx, j+dy, k+dz]`` with periodic or Dirichlet-zero boundaries per
    dim.

    Index conventions: tap offsets index the BUFFER's memory dims (for
    the default natural layout these coincide with global X/Y/Z; under
    ``transpose_axis_contiguous``/``transpose_mem_order`` map your taps
    through ``grid.config.mem_order(axis)``), while ``halo_periods`` is
    indexed by GLOBAL dims, matching ``update_halos``.

    ``weights`` must be a static host array; zero taps cost nothing.
    The stencil runs on the ghost-extended :func:`halo_map` form: one
    ghost exchange, then the weighted sum of shifted slices, which XLA
    fuses into one pass.  This generalizes :func:`laplacian7` to any
    27-point kernel (smoothers, biased differences, 27-point
    Laplacians).

    Differentiable: the VJP of a linear stencil is the stencil with
    reflected offsets (``w[-o]``) — exact for periodic wrap and for
    Dirichlet zero ghosts alike (the zero-ghost operator's matrix
    transpose), so the backward pass is one fused apply too.
    """
    w = np.asarray(weights, dtype=np.float64)
    if w.shape != (3, 3, 3):
        raise ValueError(f"weights must be (3, 3, 3); got {w.shape}")
    periods = tuple(bool(p) for p in halo_periods)
    return _stencil_apply_fn(grid, axis, periods, w.tobytes())(u)


@lru_cache(maxsize=256)
def _stencil_apply_fn(grid, axis, periods, w_bytes: bytes):
    """Cached differentiable apply for one (grid, weights) configuration;
    adjoint = reflected taps (see :func:`stencil_apply`)."""
    w = np.frombuffer(w_bytes, dtype=np.float64).reshape(3, 3, 3)
    w_adj = w[::-1, ::-1, ::-1]

    @jax.custom_vjp
    def f(u):
        return _stencil_apply_impl(grid, u, w, axis, periods)

    def fwd(u):
        return f(u), None

    def bwd(_, g):
        return (_stencil_apply_fn(grid, axis, periods, w_adj.tobytes())(g),)

    f.defvjp(fwd, bwd)
    return f


def _pow2_divisor(n: int, cap: int) -> int:
    """Largest power of two <= cap dividing n."""
    b = 1
    while b * 2 <= cap and n % (b * 2) == 0:
        b *= 2
    return b


def _kernel_tiles(ext):
    """(by, bz) output tile of the GPU stencil kernel for local extents
    ``ext``, or None when the extents do not tile (Triton blocks are powers
    of two): bz up to 512 along the contiguous dim, by * bz <= 4096."""
    _, my, mz = ext
    bz = _pow2_divisor(mz, 512)
    if bz < 32:
        return None
    return _pow2_divisor(my, max(1, 4096 // bz)), bz


def _stencil_kernel(u_ref, o_ref, *, taps, ext, wrap, by, bz):
    """One (by, bz) output tile of plane i: each tap is one load of the
    shifted tile, served from L1/L2 after its first touch.  Wrap dims
    index the unextended block modulo its extent; the other dims read a
    block extended by one ghost plane on each side."""
    import jax.experimental.pallas as pl
    mx, my, mz = ext
    i, j, k = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    rows = j * by + jnp.arange(by)
    cols = k * bz + jnp.arange(bz)
    acc = jnp.zeros((by, bz), jnp.float32)
    for (dx, dy, dz), wv in taps:
        xi = (i + dx) % mx if wrap[0] else i + 1 + dx
        yi = (rows + dy) % my if wrap[1] else rows + 1 + dy
        zi = (cols + dz) % mz if wrap[2] else cols + 1 + dz
        acc = acc + wv * u_ref[xi, yi[:, None], zi[None, :]]
    o_ref[i, pl.ds(j * by, by), pl.ds(k * bz, bz)] = acc


def _stencil_kernel_call(ue, taps, ext, wrap, interpret=False):
    """Pallas call (Triton route) of :func:`_stencil_kernel` on one shard:
    ``ue`` is the local block, extended by one plane on each side of every
    non-wrap dim; returns the (mx, my, mz) output block."""
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import triton as plt
    by, bz = _kernel_tiles(ext)
    mx, my, mz = ext
    kernel = partial(_stencil_kernel, taps=taps, ext=ext, wrap=wrap, by=by,
                     bz=bz)
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(ext, ue.dtype),
        grid=(mx, my // by, mz // bz),
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret)(ue)


def _use_stencil_kernel(grid, ext, dtype) -> bool:
    """The GPU kernel serves float32 blocks on GPU meshes whose extents
    tile; everything else takes the XLA shifted-slice form."""
    return (grid.mesh.devices.flat[0].platform == "gpu"
            and np.dtype(dtype) == np.float32
            and _kernel_tiles(ext) is not None)


def _stencil_apply_impl(grid, u, w, axis, periods):
    if len(periods) != 3:
        raise ValueError("halo_periods must have length 3")
    if axis not in (0, 1, 2):
        raise ValueError(f"axis out of range: {axis}")
    if u.ndim != 3:
        raise ValueError("stencil_apply expects a plain 3D pencil array")
    expected = grid.global_shape(axis)
    if tuple(u.shape) != expected:
        raise ValueError(
            f"stencil_apply: input shape {tuple(u.shape)} does not match "
            f"the halo-free pencil layout {expected}")

    ext = _local_extents(grid, axis)
    taps = tuple(
        ((dx, dy, dz), float(w[1 + dx, 1 + dy, 1 + dz]))
        for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
        if w[1 + dx, 1 + dy, 1 + dz] != 0.0)

    if taps and _use_stencil_kernel(grid, ext, u.dtype):
        # local periodic dims wrap inside the kernel; only the others
        # are extended by ghost planes (exchanged by halo_map)
        order = grid.config.mem_order(axis)
        spec = grid.spec(axis)
        wrap = tuple(periods[order[d]] and (
            spec[d] is None or grid.mesh.shape[spec[d]] == 1)
            for d in range(3))
        return halo_map(grid, u,
                        partial(_stencil_kernel_call, taps=taps, ext=ext,
                                wrap=wrap),
                        axis, tuple(0 if wr else 1 for wr in wrap), periods)

    # ghost-extended shards + shifted-slice sum
    def fn(ue):
        out = None
        for (dx, dy, dz), wv in taps:
            sl = tuple(slice(1 + o, (1 + o) + n)
                       for o, n in zip((dx, dy, dz), ext))
            term = wv * ue[sl]
            out = term if out is None else out + term
        if out is None:
            out = jnp.zeros(ext, u.dtype)
        return out.astype(u.dtype)

    return halo_map(grid, u, fn, axis, 1, periods)


@lru_cache(maxsize=256)
def _diff_apply_fn(grid, axis, periods, alpha, beta):
    """Differentiable ``alpha*I + beta*L`` apply for one (grid, op)
    configuration, routed through the generic weight-set machinery as the
    face-tap stencil {center: alpha - 6*beta, faces: beta}.

    Cached so repeated ``laplacian7``/``diffusion_step`` calls skip the
    Python-side weight-array rebuild, and so :func:`~cudecomp_tpu.grid.
    clear_plan_caches` has a concrete cache to drop (the underlying
    compiled programs live in ``_stencil_apply_fn``'s cache).

    The operator is self-adjoint, so ``_stencil_apply_fn``'s
    reflected-tap VJP reuses the same apply.
    """
    w = np.zeros((3, 3, 3), np.float64)
    for d in range(3):
        lo = [1, 1, 1]
        hi = [1, 1, 1]
        lo[d], hi[d] = 0, 2
        w[tuple(lo)] = w[tuple(hi)] = beta
    w[1, 1, 1] = alpha - 6.0 * beta
    return _stencil_apply_fn(grid, axis, periods, w.tobytes())


def laplacian7(grid, u, axis: int = 0, halo_periods=(True, True, True)):
    """7-point Laplacian of a halo-free pencil array (unit grid spacing).

    The fused ghost-plane alternative to ``update_halos`` + a shifted-
    slice stencil: one collective round for the boundary planes, one
    fused pass for the stencil.
    Non-periodic edges use zero (Dirichlet) ghost planes.  Differentiable
    (self-adjoint custom VJP — the backward pass is one fused apply too).
    """
    periods = tuple(bool(p) for p in halo_periods)
    with trace_range(f"cudecomp_tpu.laplacian7_axis{axis}"):
        return _diff_apply_fn(grid, axis, periods, 0.0, 1.0)(u)


def diffusion_step(grid, u, dt, axis: int = 0,
                   halo_periods=(True, True, True)):
    """One fused explicit diffusion step ``u + dt * lap(u)``.

    Same pipeline as :func:`laplacian7` with the axpy folded into the
    stencil weights (centre ``1 - 6 dt``).  Differentiable; a traced
    (non-static) ``dt`` takes the two-pass ``u + dt * laplacian7(u)``
    composition, since the weights are specialized per static
    coefficient pair.
    """
    periods = tuple(bool(p) for p in halo_periods)
    with trace_range(f"cudecomp_tpu.diffusion_step_axis{axis}"):
        try:
            dt_c = float(dt)
        except (TypeError, jax.errors.ConcretizationTypeError,
                jax.errors.TracerArrayConversionError):
            return u + dt * laplacian7(grid, u, axis, periods)
        return _diff_apply_fn(grid, axis, periods, 1.0, dt_c)(u)
