"""Grid configuration — the JAX analog of ``cudecompGridDescConfig_t``.

Reference parity: ``include/cudecomp.h:128-238`` defines the config struct
(gdims, gdims_dist, pdims, transpose_comm_backend, transpose_axis_contiguous,
transpose_mem_order, halo_comm_backend) and an options struct with autotuning
knobs.  Here the same information is a frozen dataclass; the communication
"backend" enums collapse to XLA collective *strategies* (see
``TransposeMethod`` / ``HaloMethod``) because XLA owns the transport (NCCL
on GPUs, in-process copies on the CPU) and the interesting choice is the
collective algorithm, not the library.

Memory-order convention (differs from the reference by a C-order/Fortran-order
mirror, documented here once):

  * Local pencil buffers are C-order (row-major) JAX arrays; the LAST array
    dimension is contiguous.
  * ``mem_order[i]`` for a pencil gives the *global axis* (0=X, 1=Y, 2=Z)
    stored in array dimension ``i``; dimension 2 is contiguous.
  * Natural order is ``(0, 1, 2)`` — array indexed ``[x, y, z]``, Z
    contiguous.  (The reference's natural column-major ``[X,Y,Z]`` has X
    contiguous; the two are byte-wise mirrors, semantically equivalent.)
  * ``transpose_axis_contiguous[ax] = True`` selects the cyclic order that
    puts the pencil axis contiguous: ``((ax+1)%3, (ax+2)%3, ax)``.  This is
    the analog of the reference's cyclic permutation table
    (``docs/basic_usage.rst:143-166``, resolution ``src/cudecomp.cc:1120-1133``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple

Triple = Tuple[int, int, int]


class TransposeMethod(enum.Enum):
    """Collective strategy for global transposes.

    Replacement for ``cudecompTransposeCommBackend_t``
    (``include/cudecomp.h:48-59``): the MPI/NCCL/NVSHMEM x {plain, pipelined}
    matrix collapses to the choice of XLA collective algorithm.
    """

    #: One-shot fused ``lax.all_to_all`` over the mesh axis (default).
    ALL_TO_ALL = "all_to_all"
    #: ``lax.ppermute`` ring, one peer per step — the analog of the
    #: reference's pipelined per-peer P2P backends; lets XLA overlap each
    #: step's transfer with the next step's pack and previous step's unpack.
    RING = "ring"
    #: Pairwise XOR peer schedule (reference's power-of-two pairing,
    #: common.h:533-577); falls back to RING for non-power-of-two sizes.
    RING_XOR = "ring_xor"
    #: True per-peer software pipeline (the reference's flagship pipelined
    #: backends, transpose.h:683-744): each ring step slices and permutes
    #: ONLY that peer's chunk, so chunk s+1's local pack and chunk s-1's
    #: unpack have no data dependence on chunk s's transfer and XLA's
    #: latency-hiding scheduler can overlap local permute work with the
    #: transfers.
    RING_PIPELINED = "ring_pipelined"
    #: Two-tier ring for multi-host meshes (the reference's multi-level
    #: intra/inter-group ring, common.h:533-577): peers enumerated in mixed
    #: radix (host, within-host) with inter-host steps issued first and
    #: intra-host (NVLink) steps interleaved behind them
    #: (transpose.h:695-709 pairing analog).  Equals RING on one host.
    RING_HIER = "ring_hier"


class HaloMethod(enum.Enum):
    """Collective strategy for halo exchanges.

    Replaces ``cudecompHaloCommBackend_t`` (``include/cudecomp.h:61-68``).
    """

    #: Paired ``lax.ppermute`` shifts (+1 / -1) — the default.
    PPERMUTE = "ppermute"


class RankOrder(enum.Enum):
    """Process-grid rank ordering (``cudecompRankOrder`` analog,
    ``include/internal/common.h:318-346``): how linear device ids map onto
    the (pr, pc) process grid."""

    ROW_MAJOR = "row_major"  # rank = pr * Pc + pc   (reference default)
    COL_MAJOR = "col_major"  # rank = pc * Pr + pr


def _as_triple(v, name: str) -> Triple:
    t = tuple(int(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"{name} must have length 3, got {v!r}")
    return t  # type: ignore[return-value]


_VALID_ORDERS = {
    (0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0),
}


def default_mem_order(axis: int, axis_contiguous: bool) -> Triple:
    """Memory order for a pencil: natural or cyclic axis-contiguous.

    Mirrors ``src/cudecomp.cc:1120-1133`` under the C-order convention
    described in the module docstring.
    """
    if axis_contiguous:
        return ((axis + 1) % 3, (axis + 2) % 3, axis)
    return (0, 1, 2)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Static description of a decomposed 3D grid.

    Attributes:
      gdims: global grid extents (X, Y, Z).
      pdims: process grid (Pr, Pc).  ``Pr * Pc`` must equal the mesh size.
        ``(0, 0)`` requests autotuning of the process grid shape.
      gdims_dist: distribute as if the grid had these (smaller) extents, with
        the excess tacked onto the last populated pencil — used for FFT
        padding tricks (reference: ``include/cudecomp.h:137``,
        ``src/cudecomp.cc:1135-1150``).  ``None`` means ``gdims``.
      transpose_axis_contiguous: per pencil axis, whether transposes produce
        the cyclic axis-contiguous layout.
      transpose_mem_order: optional explicit per-pencil memory orders; wins
        over ``transpose_axis_contiguous`` when given (reference
        ``include/cudecomp.h:145-149``).
      rank_order: mapping of linear device ids to the process grid.
      transpose_method / halo_method: XLA collective strategies.
    """

    gdims: Triple
    pdims: Triple = (0, 0)  # type: ignore[assignment]  # (Pr, Pc)
    gdims_dist: Optional[Triple] = None
    transpose_axis_contiguous: Tuple[bool, bool, bool] = (False, False, False)
    transpose_mem_order: Optional[Tuple[Triple, Triple, Triple]] = None
    rank_order: RankOrder = RankOrder.ROW_MAJOR
    transpose_method: TransposeMethod = TransposeMethod.ALL_TO_ALL
    halo_method: HaloMethod = HaloMethod.PPERMUTE

    def __post_init__(self):
        object.__setattr__(self, "gdims", _as_triple(self.gdims, "gdims"))
        pd = tuple(int(x) for x in self.pdims)
        if len(pd) != 2:
            raise ValueError(f"pdims must have length 2, got {self.pdims!r}")
        object.__setattr__(self, "pdims", pd)
        if any(g <= 0 for g in self.gdims):
            raise ValueError(f"gdims must be positive, got {self.gdims}")
        if any(p < 0 for p in pd) or (pd[0] == 0) != (pd[1] == 0):
            raise ValueError(
                f"pdims must both be positive, or both 0 for autotuning; got {pd}")
        if self.gdims_dist is not None:
            gd = _as_triple(self.gdims_dist, "gdims_dist")
            if any(d <= 0 for d in gd):
                raise ValueError(f"gdims_dist must be positive, got {gd}")
            if any(d > g for d, g in zip(gd, self.gdims)):
                # reference: src/cudecomp.cc:1134-1139
                raise ValueError(
                    f"gdims_dist entries must be <= gdims entries: {gd} vs {self.gdims}")
            object.__setattr__(self, "gdims_dist", gd)
        ac = tuple(bool(b) for b in self.transpose_axis_contiguous)
        if len(ac) != 3:
            raise ValueError("transpose_axis_contiguous must have length 3")
        object.__setattr__(self, "transpose_axis_contiguous", ac)
        if self.transpose_mem_order is not None:
            mo = tuple(_as_triple(o, "transpose_mem_order[i]")
                       for o in self.transpose_mem_order)
            if len(mo) != 3:
                raise ValueError("transpose_mem_order must give 3 pencil orders")
            for o in mo:
                if o not in _VALID_ORDERS:
                    raise ValueError(f"invalid memory order permutation {o}")
            object.__setattr__(self, "transpose_mem_order", mo)
        if not isinstance(self.rank_order, RankOrder):
            object.__setattr__(self, "rank_order", RankOrder(self.rank_order))
        if not isinstance(self.transpose_method, TransposeMethod):
            object.__setattr__(
                self, "transpose_method", TransposeMethod(self.transpose_method))
        if not isinstance(self.halo_method, HaloMethod):
            object.__setattr__(self, "halo_method", HaloMethod(self.halo_method))

    # -- derived, all static Python ------------------------------------------------

    @property
    def effective_gdims_dist(self) -> Triple:
        return self.gdims_dist if self.gdims_dist is not None else self.gdims

    def mem_order(self, axis: int) -> Triple:
        """Memory order for pencil ``axis`` (array-dim -> global axis)."""
        if self.transpose_mem_order is not None:
            return self.transpose_mem_order[axis]
        return default_mem_order(axis, self.transpose_axis_contiguous[axis])

    def inv_mem_order(self, axis: int) -> Triple:
        """Inverse permutation: global axis -> array dim."""
        o = self.mem_order(axis)
        inv = [0, 0, 0]
        for i, a in enumerate(o):
            inv[a] = i
        return tuple(inv)  # type: ignore[return-value]

    def with_pdims(self, pdims: Sequence[int]) -> "GridConfig":
        return dataclasses.replace(self, pdims=tuple(int(p) for p in pdims))

    @property
    def autotune_pdims(self) -> bool:
        return self.pdims == (0, 0)


@dataclasses.dataclass(frozen=True)
class AutotuneOptions:
    """Autotuner knobs — analog of ``cudecompGridDescAutotuneOptions_t``
    (``include/cudecomp.h:186-238``) minus the GPU-specific fields.

    Attributes:
      n_warmup / n_trials: per-candidate timing protocol
        (reference: ``src/autotune.cc:541-626`` uses 3 warmup + 5 trials).
      transpose_op_weights: weights for (XToY, YToZ, ZToY, YToX) when
        scoring (``autotune.cc:631-680`` analog, exact).  Uniform weights
        time one chained round trip; weights uniform within each
        production pair (w0 == w1, w2 == w3) time the two chained pairs
        X2Y;Y2Z and Z2Y;Y2X; weights differing within a pair time each
        nonzero-weight op as its own program and score the true
        ``sum(w_i * t_i)``.  All forms compose with the per-op trial
        payloads below.
      autotune_transpose_method / autotune_halo_method: sweep the collective
        strategy in addition to pdims.
      skip_threshold: abandon a candidate early if its cheap probe (one
        warmup + one trial) exceeds ``skip_threshold * best_time`` — the
        candidate never runs its full trial protocol (reference
        ``src/autotune.cc:578-602``).
      methods: explicit candidate strategy list (None = all).
      pr_range / pc_range: inclusive clamps on process-grid factors, the
        analog of ``CUDECOMP_AUTOTUNE_P_{ROW,COL}_RANGE``.
      dtype: trial buffer dtype (None = float32; pass the production dtype
        to tune with production payloads, the reference behavior
        ``autotune.cc:377-483``).
      n_components: trailing component dims of size 2 appended to trial
        buffers (1 = split-complex production payload: 2x the bytes per
        exchange of a plain float32 trial).
    """

    n_warmup: int = 3
    n_trials: int = 5
    transpose_op_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    autotune_transpose_method: bool = True
    autotune_halo_method: bool = False
    dtype: Optional[object] = None
    n_components: int = 0
    #: also sweep the pencil memory layout (natural vs axis-contiguous) —
    #: the analog of benchmarking the reference's transpose_axis_contiguous
    #: placements (benchmark CSVs sweep ac=000/111)
    autotune_layouts: bool = False
    skip_threshold: float = 0.0
    methods: Optional[Tuple[TransposeMethod, ...]] = None
    halo_methods: Optional[Tuple[HaloMethod, ...]] = None
    pr_range: Optional[Tuple[int, int]] = None
    pc_range: Optional[Tuple[int, int]] = None
    halo_extents: Triple = (0, 0, 0)
    halo_periods: Tuple[bool, bool, bool] = (True, True, True)
    halo_axis: int = 0
    #: padding payload for halo autotuning trials (``cudecomp.h:218``)
    halo_padding: Triple = (0, 0, 0)
    #: which communication pattern selects the process grid: "transpose"
    #: (default) times transpose round trips, "halo" times halo updates on
    #: ``halo_axis`` pencils — the analog of ``grid_mode``
    #: (``cudecomp.h:172``, dispatch ``src/cudecomp.cc:1200-1211``)
    grid_mode: str = "transpose"
    #: when False, exclude process grids that split any pencil axis
    #: unevenly (``allow_uneven_decompositions``, ``cudecomp.h:175``)
    allow_uneven_decompositions: bool = True
    #: optional per-op trial payloads: 4 triples (X2Y, Y2Z, Z2Y, Y2X), the
    #: halo/padding arguments the application will use in production —
    #: ``transpose_input_halo_extents[4][3]`` etc (``cudecomp.h:195-208``)
    transpose_input_halo_extents: Optional[Tuple[Triple, ...]] = None
    transpose_output_halo_extents: Optional[Tuple[Triple, ...]] = None
    transpose_input_padding: Optional[Tuple[Triple, ...]] = None
    transpose_output_padding: Optional[Tuple[Triple, ...]] = None

    def __post_init__(self):
        if self.grid_mode not in ("transpose", "halo"):
            raise ValueError(
                f"grid_mode must be 'transpose' or 'halo', got "
                f"{self.grid_mode!r}")
        if len(self.transpose_op_weights) != 4:
            # caught here: inside the sweep an IndexError would be
            # swallowed by the per-candidate failure skip and surface as
            # a misleading 'all candidates failed'
            raise ValueError(
                f"transpose_op_weights must give 4 weights (X2Y, Y2Z, "
                f"Z2Y, Y2X), got {self.transpose_op_weights!r}")
        object.__setattr__(self, "halo_extents",
                           _as_triple(self.halo_extents, "halo_extents"))
        object.__setattr__(self, "halo_padding",
                           _as_triple(self.halo_padding, "halo_padding"))
        if len(self.halo_periods) != 3:
            raise ValueError(
                f"halo_periods must have length 3, got "
                f"{self.halo_periods!r}")
        for name in ("transpose_input_halo_extents",
                     "transpose_output_halo_extents",
                     "transpose_input_padding", "transpose_output_padding"):
            val = getattr(self, name)
            if val is None:
                continue
            try:
                n = len(val)
            except TypeError:
                n = -1
            if n != 4:
                raise ValueError(
                    f"{name} must give 4 per-op triples (X2Y, Y2Z, Z2Y, "
                    f"Y2X), got {val!r}")
            val = tuple(_as_triple(v, f"{name}[i]") for v in val)
            object.__setattr__(self, name, val)
