"""Mesh construction helpers, including hybrid multi-host meshes.

The reference's topology layer discovers NVLink/NVSwitch nodes and MNNVL
cliques and schedules intra-group transfers on the fast interconnect while
pipelining inter-group transfers over IB (``common.h:426-577``,
``transpose.h:695-709``).  Here the same two-tier structure is expressed as
a mesh whose MAJOR process-grid axis spans the slow tier and whose MINOR
axis stays inside one fast-interconnect group: XLA then routes each
collective on the right transport automatically — the intra/inter-group
scheduling machinery collapses into mesh-axis placement.

``build_decomp_mesh`` places the decomposition so that the *row* axis (Pr,
used by the X<->Y all-to-all) stays inside one group whenever it fits,
since X<->Y moves the densest traffic in the reference's benchmarks, and
lets Pc absorb the slow dimension.  With one group (one host: all its
GPUs joined all to all by NVLink) it degrades to a plain reshape.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh

from cudecomp_tpu.config import RankOrder
from cudecomp_tpu.utils.env import log_warn


def _slice_index(d) -> int:
    """Fast-interconnect group id of a device.

    GPUs and CPUs: the host (``process_index``) — the GPUs of one host
    share NVLink, and crossing hosts rides the network, which is the role
    the reference gives hostnames in ``gatherGlobalMPIInfo``
    (cudecomp.cc:508-595).  CPU devices of a multi-process cluster also
    report ``slice_index=0`` across processes, so the process id is the
    only truthful boundary there too.  Other devices group by their
    ``slice_index`` attribute when they have one, else into one group.
    """
    if getattr(d, "platform", None) in ("cpu", "gpu"):
        return d.process_index
    si = getattr(d, "slice_index", None)
    return 0 if si is None else si


def n_slices(devices: Optional[Sequence[jax.Device]] = None) -> int:
    devices = devices if devices is not None else jax.devices()
    return len({_slice_index(d) for d in devices})


def axis_group_size(mesh: Mesh, axis_name: str) -> int:
    """Fast-interconnect group size along one mesh axis.

    The analog of the reference's ``npergroup`` (``common.h:426-494``): how
    many consecutive devices along ``axis_name`` share a group (one host's
    NVLink domain).  Returns the full axis size when the axis lies within
    one group or the group pattern is irregular (-> flat ring), so callers
    can use it directly as the ``group`` of a two-tier schedule.
    """
    names = list(mesh.axis_names)
    dev = np.moveaxis(np.asarray(mesh.devices), names.index(axis_name), 0)
    cols = dev.reshape(dev.shape[0], -1)
    P = cols.shape[0]
    K = P
    # every position along the other axes must exhibit the same contiguous
    # grouping, else the "intra-group" steps of a two-tier schedule would
    # cross groups for some rows — fall back to a flat ring (K = P)
    for c in range(cols.shape[1]):
        slices = [_slice_index(d) for d in cols[:, c]]
        k = next((i for i in range(1, P) if slices[i] != slices[0]), P)
        if k == P or P % k:
            return P
        for g in range(P // k):
            if len({slices[g * k + j] for j in range(k)}) != 1:
                return P
        if c == 0:
            K = k
        elif k != K:
            return P
    return K


def build_decomp_mesh(
    pdims: Tuple[int, int],
    devices: Optional[Sequence[jax.Device]] = None,
    rank_order: RankOrder = RankOrder.ROW_MAJOR,
    axis_names: Tuple[str, str] = ("pr", "pc"),
) -> Mesh:
    """(Pr, Pc) mesh that is aware of fast-interconnect groups.

    With S groups of equal size, prefers a layout where one process-grid
    axis is a multiple of S and groups whole groups, so that the other
    axis's collectives stay entirely inside one group.
    """
    pr, pc = pdims
    devices = list(devices if devices is not None else jax.devices())
    if len(devices) < pr * pc:
        raise ValueError(f"need {pr * pc} devices, have {len(devices)}")
    devices = devices[: pr * pc]
    s = len({_slice_index(d) for d in devices})
    if s <= 1:
        from cudecomp_tpu.grid import build_mesh
        return build_mesh((pr, pc), devices, rank_order, axis_names)

    # several groups: sort devices by (group, local id) and tile groups
    # along the axis that divides the group count
    devices.sort(key=lambda d: (_slice_index(d), d.id))
    arr = np.array(devices, dtype=object)

    def slice_aligned(a, b):
        # (a, b) grid with whole groups along the b axis when possible
        # (then a-axis collectives stay inside one group)
        if b % s == 0:
            return arr.reshape(s, a, b // s).transpose(1, 0, 2).reshape(a, b)
        if a % s == 0:
            # contiguous row blocks of a//s rows per group
            return arr.reshape(a, b)
        log_warn(f"pdims {pdims} not alignable to {s} device groups; "
                 f"collectives may cross groups on both axes")
        return arr.reshape(a, b)

    if rank_order == RankOrder.COL_MAJOR:
        # col-major rank->coords contract: build the slice-aligned grid
        # on transposed dims, then transpose (the s==1 analog is
        # build_mesh's reshape(pc, pr).T)
        grid = slice_aligned(pc, pr).T
    else:
        grid = slice_aligned(pr, pc)
    return Mesh(grid, axis_names)
