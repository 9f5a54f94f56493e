"""Collective exchange strategies — the "communication backends".

The reference's backend zoo (CUDA-aware MPI / NCCL / NVSHMEM, plain and
pipelined: ``include/internal/comm_routines.h``) collapses here to the choice
of XLA collective algorithm over one mesh axis:

  * ``exchange_all_to_all`` — one fused ``lax.all_to_all`` (XLA lowers it
    to NCCL's all-to-all on GPUs; analog of the NCCL/MPI_A2A one-shot
    backends).
  * ``exchange_ring`` — P-1 ``lax.ppermute`` steps, one peer per step.  This
    is the analog of the reference's pipelined per-peer backends
    (``cudecompAlltoallPipelined``, comm_routines.h:427-631): XLA's
    latency-hiding scheduler can overlap each step's transfer with
    neighboring steps' pack/unpack work.

Both operate on a block layout: the input is ``(P*B, ...)`` where block ``p``
(rows ``p*B:(p+1)*B``) is destined for mesh-axis peer ``p``; the output has
block ``q`` holding the data received from peer ``q``.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

try:  # jax >= 0.4.35 exposes shard_map at top level
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map


def shard_map_fn(f, mesh, in_specs, out_specs):
    """shard_map with replication checking off (we use manual collectives)."""
    try:
        return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                          check_vma=False)
    except TypeError:  # older kwarg name
        return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                          check_rep=False)


def exchange_all_to_all(blocks, axis_name: str, n: int, block: int):
    """One-shot tiled all-to-all: block p -> peer p, received stacked by peer."""
    return lax.all_to_all(blocks, axis_name, split_axis=0, concat_axis=0,
                          tiled=True)


def _ring_exchange(blocks, axis_name: str, n: int, block: int, steps):
    """Shared scaffold for every per-peer (ring-style) exchange.

    ``steps`` is a list of ``(sigma, sigma_inv)`` pairs — each step is a
    permutation ``j -> sigma(j)`` of the axis indices (``sigma_inv`` its
    inverse).  At each step every device sends the block destined for
    ``sigma(me)`` and stores the received block under its sender's index
    ``sigma_inv(me)``; the self block is a local copy.  The block contract
    (rows ``p*B:(p+1)*B`` per peer, output indexed by sender) lives ONLY
    here, so the increment / XOR / hierarchical schedules cannot drift.
    """
    me = lax.axis_index(axis_name)
    out = jnp.zeros_like(blocks)
    self_blk = lax.dynamic_slice_in_dim(blocks, me * block, block, axis=0)
    out = lax.dynamic_update_slice_in_dim(out, self_blk, me * block, axis=0)
    for sigma, sigma_inv in steps:
        send_peer = sigma(me)
        recv_peer = sigma_inv(me)
        blk = lax.dynamic_slice_in_dim(blocks, send_peer * block, block,
                                       axis=0)
        perm = [(j, sigma(j)) for j in range(n)]
        recv = lax.ppermute(blk, axis_name, perm)
        out = lax.dynamic_update_slice_in_dim(out, recv, recv_peer * block,
                                              axis=0)
    return out


def exchange_ring(blocks, axis_name: str, n: int, block: int):
    """Ring (per-peer) exchange via ``lax.ppermute`` — pipelined analog.

    Step ``s`` sends block ``(me+s) % n`` to peer ``(me+s) % n`` and receives
    the matching block from peer ``(me-s) % n``.  The self block is a local
    copy.  Mirrors the ring peer ordering of ``getAlltoallPeerRanks``
    (common.h:533-577); each step is one collective-permute, which XLA
    lowers to NCCL send/recv pairs on GPUs.
    """
    steps = [(lambda j, s=s: (j + s) % n, lambda j, s=s: (j - s) % n)
             for s in range(1, n)]
    return _ring_exchange(blocks, axis_name, n, block, steps)


def exchange_ring_xor(blocks, axis_name: str, n: int, block: int):
    """Pairwise-exchange ring using the XOR peer schedule.

    The reference pairs peers as ``me ^ s`` per step for power-of-two
    communicators (``getAlltoallPeerRanks`` common.h:533-577) so every step
    is a symmetric pairwise swap (each link used bidirectionally at once).
    Falls back to the increment ring for non-power-of-two sizes.
    """
    if n & (n - 1):
        return exchange_ring(blocks, axis_name, n, block)
    # each XOR step is an involution: sigma == sigma_inv
    steps = [(lambda j, s=s: j ^ s,) * 2 for s in range(1, n)]
    return _ring_exchange(blocks, axis_name, n, block, steps)


def hier_schedule(n: int, group: int):
    """Two-tier peer schedule (multi-level ring, common.h:533-577 analog).

    Devices along the axis decompose as ``j = g * group + k`` (g = slice /
    fast-interconnect group, k = index within the group).  Every step is a
    valid permutation ``j -> ((g+dg) % G) * group + (k+dk) % group``; steps
    are ordered with inter-group displacements first, interleaved with
    intra-group ones, so slow inter-host transfers are issued early and
    fast intra-host transfers fill in behind them (the reference pairs
    each inter-group transfer with an intra-group one,
    transpose.h:695-709).

    Returns a list of (dg, dk) displacement pairs covering all n-1 peers.
    """
    if group <= 1 or n % group:
        return [(0, s) for s in range(1, n)]
    G = n // group
    inter = [(dg, dk) for dg in range(1, G) for dk in range(group)]
    intra = [(0, dk) for dk in range(1, group)]
    steps = []
    ii, jj = 0, 0
    while ii < len(inter) or jj < len(intra):
        if ii < len(inter):
            steps.append(inter[ii])
            ii += 1
        if jj < len(intra):
            steps.append(intra[jj])
            jj += 1
    return steps


def exchange_ring_hier(blocks, axis_name: str, n: int, block: int,
                       group: int = 1):
    """Hierarchical (two-tier) ring exchange for multi-host meshes.

    Same block contract as :func:`exchange_ring`, but peers are enumerated
    with the mixed-radix schedule of :func:`hier_schedule` so each
    ``ppermute`` step is either purely intra-group or purely inter-group,
    with inter-group steps front-loaded.  With ``group <= 1`` (one host)
    this degenerates to the plain increment ring.
    """
    if group <= 1 or n % group:
        group = n  # one group: (0, dk) displacements == increment ring
    G = n // group

    def peer_of(dg, dk, j):
        return ((j // group + dg) % G) * group + (j % group + dk) % group

    steps = [(lambda j, dg=dg, dk=dk: peer_of(dg, dk, j),
              lambda j, dg=dg, dk=dk: peer_of((-dg) % G, (-dk) % group, j))
             for dg, dk in hier_schedule(n, group)]
    return _ring_exchange(blocks, axis_name, n, block, steps)


EXCHANGES = {
    "all_to_all": exchange_all_to_all,
    "ring": exchange_ring,
    "ring_xor": exchange_ring_xor,
    "ring_hier": exchange_ring_hier,  # engine injects group= at build time
    # "ring_pipelined" is implemented inside the transpose engine (it
    # restructures the pack/permute phases, not just the exchange)
}
