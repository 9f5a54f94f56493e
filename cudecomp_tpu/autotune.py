"""Runtime autotuner — process-grid shape x transpose strategy search.

Rebuild of ``src/autotune.cc``: where the reference sweeps pdims
factor pairs x communication backends with CUDA-event-timed trials
(``autotuneTransposeBackend`` :275-769, ``autotuneHaloBackend`` :771-1124),
this sweeps pdims factor pairs x XLA collective strategies with
compiled-program wall timings (``block_until_ready``), keeping the
reference's protocol structure:

  * per-candidate warmup + timed trials (3 + 5 by default, :541-626);
  * per-op weighted sums over the 4-transpose round trip X2Y;Y2Z;Z2Y;Y2X;
  * skip-threshold early-out: abandon a candidate whose first trial already
    exceeds ``skip_threshold * best`` (:578-602);
  * two-phase dispatch: transpose (grid + strategy) first, then halo strategy
    with the grid fixed (``src/cudecomp.cc:1200-1211``);
  * empty-pencil candidates are skipped (:334-373).

The winner is frozen into the returned :class:`GridDescriptor`'s config, the
analog of the autotuned config copied back to the caller
(``src/cudecomp.cc:1248-1265``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from cudecomp_tpu import geometry
from cudecomp_tpu.config import (AutotuneOptions, GridConfig, HaloMethod,
                                 TransposeMethod)
from cudecomp_tpu.grid import GridDescriptor, build_mesh


@dataclasses.dataclass
class TrialRecord:
    pdims: Tuple[int, int]
    method: str
    times_s: Tuple[float, ...]   # per-trial weighted round-trip seconds
    avg_s: float
    min_s: float
    skipped: bool = False


@dataclasses.dataclass
class AutotuneResult:
    grid: GridDescriptor
    best_pdims: Tuple[int, int]
    best_method: TransposeMethod
    best_time_s: float
    trials: List[TrialRecord]
    halo_trials: List[TrialRecord] = dataclasses.field(default_factory=list)
    best_halo_method: Optional[HaloMethod] = None

    def save_json(self, path: str):
        """Persist the tuned choice (+ trial table) so applications can fix
        the configuration and skip re-tuning — the workflow the reference
        docs recommend (docs/autotuning.rst:37-38)."""
        import json
        payload = {
            "best_pdims": list(self.best_pdims),
            "best_method": self.best_method.value,
            "best_axis_contiguous": list(
                self.grid.config.transpose_axis_contiguous),
            "best_halo_method": (self.best_halo_method.value
                                 if self.best_halo_method else None),
            "best_time_s": self.best_time_s,
            "trials": [dataclasses.asdict(t) for t in self.trials],
            "halo_trials": [dataclasses.asdict(t) for t in self.halo_trials],
        }

        def _finite(o):
            # skipped trials carry float('inf'); json.dump would emit the
            # non-standard 'Infinity' token and the file would not parse
            # as strict JSON (jq/JS tooling) — persist null instead
            if isinstance(o, dict):
                return {k: _finite(v) for k, v in o.items()}
            if isinstance(o, list):
                return [_finite(v) for v in o]
            if isinstance(o, float) and not np.isfinite(o):
                return None
            return o

        with open(path, "w") as f:
            json.dump(_finite(payload), f, indent=2, allow_nan=False)

    def report(self) -> str:
        """Human-readable trial table (perf-report analog)."""
        lines = ["CUDECOMP_TPU: autotune results (avg s | min s):"]
        for t in self.trials:
            status = "SKIPPED" if t.skipped else f"{t.avg_s:.6f} | {t.min_s:.6f}"
            lines.append(f"  pdims={t.pdims} method={t.method:12s} {status}")
        for t in self.halo_trials:
            status = "SKIPPED" if t.skipped else f"{t.avg_s:.6f} | {t.min_s:.6f}"
            lines.append(f"  halo  pdims={t.pdims} method={t.method:12s} {status}")
        ac = self.grid.config.transpose_axis_contiguous
        lines.append(
            f"  -> selected pdims={self.best_pdims} "
            f"method={self.best_method.value} ac={int(ac[0])} "
            f"({self.best_time_s:.6f} s)")
        return "\n".join(lines)


def load_tuned_config(path: str, base_config: GridConfig) -> GridConfig:
    """Apply a persisted autotune result to a config (skip re-tuning)."""
    import json
    with open(path) as f:
        payload = json.load(f)
    cfg = base_config.with_pdims(payload["best_pdims"])
    cfg = dataclasses.replace(
        cfg, transpose_method=TransposeMethod(payload["best_method"]))
    if payload.get("best_axis_contiguous") is not None:
        cfg = dataclasses.replace(
            cfg, transpose_axis_contiguous=tuple(
                payload["best_axis_contiguous"]))
    if payload.get("best_halo_method"):
        cfg = dataclasses.replace(
            cfg, halo_method=HaloMethod(payload["best_halo_method"]))
    return cfg


def _valid_pdims(cfg: GridConfig, nranks: int,
                 options: AutotuneOptions) -> List[Tuple[int, int]]:
    from cudecomp_tpu.utils import env as env_util
    pr_range = options.pr_range or env_util.int_range(
        "CUDECOMP_TPU_AUTOTUNE_P_ROW_RANGE")
    pc_range = options.pc_range or env_util.int_range(
        "CUDECOMP_TPU_AUTOTUNE_P_COL_RANGE")
    out = []
    for pr, pc in geometry.pdim_candidates(nranks):
        if pr_range and not (pr_range[0] <= pr <= pr_range[1]):
            continue
        if pc_range and not (pc_range[0] <= pc <= pc_range[1]):
            continue
        trial = cfg.with_pdims((pr, pc))
        # skip empty-pencil candidates (autotune.cc:334-373); optionally
        # skip uneven decompositions (allow_uneven_decompositions,
        # cudecomp.h:175)
        ok = True
        for axis in range(3):
            a, b = geometry.pencil_shard_dims(axis)
            for dim, P in ((a, pr), (b, pc)):
                splits = geometry._dist_splits(trial, dim, P)
                if min(splits) == 0 or (
                        not options.allow_uneven_decompositions
                        and len(set(splits)) > 1):
                    ok = False
                    break
            if not ok:
                break
        if ok:
            out.append((pr, pc))
    return out


def _allreduce_trials(times: List[float]) -> List[float]:
    """Cross-host reduction of trial times (autotune.cc:167-188 analog).

    On a multi-controller deployment every process times the same globally
    collective trials, but wall clocks differ; averaging across processes
    makes every host score candidates identically, so the argmin selection
    is itself a deterministic broadcast (the analog of the reference's
    rank-0 bcast of the winner, autotune.cc:731-736)."""
    if jax.process_count() == 1:
        return times
    from jax.experimental import multihost_utils
    gathered = multihost_utils.process_allgather(np.asarray(times))
    return [float(t) for t in np.asarray(gathered).reshape(
        jax.process_count(), -1).mean(axis=0)]


def _time_roundtrip(grid: GridDescriptor, dtype, weights,
                    n_warmup: int, n_trials: int,
                    skip_after_first_above: Optional[float],
                    iters: int = 2,
                    n_components: int = 0,
                    op_kwargs=None) -> Tuple[List[float], bool]:
    """Weighted 4-op round-trip timings (forced completion); returns
    (per-trial weighted seconds, skipped).

    The round trip runs ``iters`` times inside one jit ending in a scalar
    reduction (see ``performance.time_scanned``), whose fetch is the
    completion barrier.  With uniform
    weights one chained program is timed (the reference's ``at_results``
    round-trip semantics, autotune.cc:546-626).  Non-uniform weights that
    are uniform WITHIN each production-adjacent pair (w0 == w1, w2 == w3)
    time the two chained pairs X2Y;Y2Z and Z2Y;Y2X as separate programs
    scored (w0+w1)/2 and (w2+w3)/2 — exact, since w*(t0+t1) == w*t0 + w*t1,
    and cheaper than four programs.  Weights that differ within a pair time
    each op as its OWN pinned-carry scanned program on its production input
    pencil/payload and score the true per-op sum sum(w_i * t_i) — the
    reference's per-op event timings (autotune.cc:631-680); zero-weight ops
    are never compiled or run.  Every decomposition composes with the
    per-op halo/padding payloads (payload chaining is validated upstream,
    so each op's standalone input payload equals what the chained cycle
    would feed it).

    When a skip threshold is given, ONE cheap probe (1 warmup + 1 trial on
    the SAME compiled executable the full protocol reuses — no extra
    compile) runs first; a candidate whose probe already exceeds the
    threshold never runs its remaining trials — the wall-time saving of the
    reference's first-trial early-out (autotune.cc:578-602), with the same
    caveat: a skipped candidate can never become best, so a threshold
    tight enough to clip timing noise can exclude the true winner (the
    reference shares this failure mode; use skip_threshold >= ~2).

    ``n_components`` appends that many trailing component dims of size 2
    (e.g. 1 for split-complex) so trials move the production payload.
    ``op_kwargs`` gives 4 per-op keyword dicts (halo extents / padding the
    application will use — ``transpose_input_halo_extents`` etc,
    ``cudecomp.h:195-208``).
    """
    from cudecomp_tpu import performance as perf
    from cudecomp_tpu.ops import transpose as tr

    cfg = grid.config
    op_kwargs = op_kwargs or ({}, {}, {}, {})
    in_he0 = op_kwargs[0].get("input_halo_extents", (0, 0, 0))
    in_pad0 = op_kwargs[0].get("input_padding", (0, 0, 0))
    shape = (geometry.global_buffer_shape(cfg, 0, in_he0, in_pad0)
             + (2,) * n_components)
    x = jax.device_put(np.zeros(shape, dtype=np.dtype(dtype)),
                       grid.sharding(0))
    m = cfg.transpose_method

    def roundtrip(a):
        b = tr.transpose_x_to_y(grid, a, method=m, **op_kwargs[0])
        b = tr.transpose_y_to_z(grid, b, method=m, **op_kwargs[1])
        b = tr.transpose_z_to_y(grid, b, method=m, **op_kwargs[2])
        return tr.transpose_y_to_x(grid, b, method=m, **op_kwargs[3])

    uniform = len(set(weights)) == 1
    w_mean = float(np.mean(weights))

    if uniform:
        rt_timer = perf.ScannedTimer(roundtrip, x, iters)
        warm_done = 0
        if skip_after_first_above is not None:
            probe = _allreduce_trials(rt_timer.time(n_warmup=1, n_trials=1))
            score = w_mean * probe[0]
            if score > skip_after_first_above:
                return [score], True
            warm_done = 2  # the probe's warmup + timed run warmed it

        # score = sum(w_i * t_i) = w * t_roundtrip
        ts = rt_timer.time(max(n_warmup - warm_done, 0), n_trials)
        times = [t * weights[0] for t in ts]
        return _allreduce_trials(times), False

    def pinned(op_fn):
        # A standalone op (or pair) does not return its own input shape, so
        # the scanned carry is the INPUT pinned by the op's completion
        # scalar (carry' = carry + eps * scalar(op(carry))): the data
        # dependence forces the op to execute every scan iteration.  The
        # pin's reduction+add cost is identical across the method
        # candidates being ranked (same buffer shapes), so it cancels in
        # the argmin.
        def it(a):
            eps = jnp.asarray(1e-30, a.dtype)
            return a + eps * perf.completion_scalar(
                op_fn(a)).astype(a.dtype)
        return it

    if weights[0] == weights[1] and weights[2] == weights[3]:
        # pair-granular weighting (exact for within-pair-uniform weights,
        # since w*(t0+t1) == w*t0 + w*t1): the two production-adjacent
        # halves of the cycle are timed as separate chained programs.  The
        # forward pair reuses the round trip's x-pencil input; the backward
        # pair needs a z-pencil input carrying op 2's input payload (which
        # the chain validation guarantees equals op 1's output payload).
        def fwd_pair(a):
            b = tr.transpose_x_to_y(grid, a, method=m, **op_kwargs[0])
            return tr.transpose_y_to_z(grid, b, method=m, **op_kwargs[1])

        def bwd_pair(c):
            b = tr.transpose_z_to_y(grid, c, method=m, **op_kwargs[2])
            return tr.transpose_y_to_x(grid, b, method=m, **op_kwargs[3])

        in_he2 = op_kwargs[2].get("input_halo_extents", (0, 0, 0))
        in_pad2 = op_kwargs[2].get("input_padding", (0, 0, 0))
        zshape = (geometry.global_buffer_shape(cfg, 2, in_he2, in_pad2)
                  + (2,) * n_components)
        z = jax.device_put(np.zeros(zshape, dtype=np.dtype(dtype)),
                           grid.sharding(2))
        w_fwd = (weights[0] + weights[1]) / 2.0
        w_bwd = (weights[2] + weights[3]) / 2.0
        # the probe and the full protocol share the SAME two compiled
        # pair executables (the roundtrip program is never built here —
        # compiling it for one probe would waste a remote compile)
        fwd_timer = perf.ScannedTimer(pinned(fwd_pair), x, iters)
        bwd_timer = perf.ScannedTimer(pinned(bwd_pair), z, iters)
        warm_done = 0
        if skip_after_first_above is not None:
            pf = _allreduce_trials(fwd_timer.time(n_warmup=1, n_trials=1))
            pb = _allreduce_trials(bwd_timer.time(n_warmup=1, n_trials=1))
            score = w_fwd * pf[0] + w_bwd * pb[0]
            if score > skip_after_first_above:
                return [score], True
            warm_done = 2
        pair_warm = max(n_warmup - warm_done, 0)
        t_fwd = fwd_timer.time(pair_warm, n_trials)
        t_bwd = bwd_timer.time(pair_warm, n_trials)
        times = [w_fwd * a + w_bwd * b for a, b in zip(t_fwd, t_bwd)]
        return _allreduce_trials(times), False

    # exact per-op weighting (autotune.cc:631-680 analog): weights differ
    # WITHIN a production pair, so each nonzero-weight op is timed as its
    # own pinned-carry scanned program on its production input pencil and
    # payload, and candidates are scored by the true sum(w_i * t_i).
    # Zero-weight ops contribute nothing to the score, so they are never
    # compiled or run (the wall-time win that makes e.g. a (0,0,0,1)
    # single-op tune cheap).
    op_fns = (tr.transpose_x_to_y, tr.transpose_y_to_z,
              tr.transpose_z_to_y, tr.transpose_y_to_x)
    in_axes = (0, 1, 2, 1)  # input pencil of X2Y, Y2Z, Z2Y, Y2X
    timers = []
    for k in range(4):
        if weights[k] == 0:
            timers.append(None)
            continue
        in_he = op_kwargs[k].get("input_halo_extents", (0, 0, 0))
        in_pad = op_kwargs[k].get("input_padding", (0, 0, 0))
        kshape = (geometry.global_buffer_shape(cfg, in_axes[k], in_he,
                                               in_pad)
                  + (2,) * n_components)
        xk = jax.device_put(np.zeros(kshape, dtype=np.dtype(dtype)),
                            grid.sharding(in_axes[k]))
        op = partial(op_fns[k], grid, method=m, **op_kwargs[k])
        timers.append(perf.ScannedTimer(pinned(op), xk, iters))
    warm_done = 0
    if skip_after_first_above is not None:
        probes = [(_allreduce_trials(t.time(n_warmup=1, n_trials=1))[0]
                   if t is not None else 0.0) for t in timers]
        score = sum(w * p for w, p in zip(weights, probes))
        if score > skip_after_first_above:
            return [score], True
        warm_done = 2
    op_warm = max(n_warmup - warm_done, 0)
    t_ops = [(t.time(op_warm, n_trials) if t is not None
              else [0.0] * n_trials) for t in timers]
    times = [sum(w * t[i] for w, t in zip(weights, t_ops))
             for i in range(n_trials)]
    return _allreduce_trials(times), False


def _time_halo(grid: GridDescriptor, dtype, options: AutotuneOptions,
               n_warmup: int, n_trials: int, iters: int = 2,
               n_components: int = 0) -> List[float]:
    from cudecomp_tpu import performance as perf
    from cudecomp_tpu.ops.halo import update_halos

    cfg = grid.config
    axis = options.halo_axis
    he = options.halo_extents
    pad = options.halo_padding
    shape = (geometry.global_buffer_shape(cfg, axis, he, pad)
             + (2,) * n_components)
    x = jax.device_put(np.zeros(shape, dtype=np.dtype(dtype)),
                       grid.sharding(axis))
    fn = lambda a: update_halos(grid, a, axis, he, options.halo_periods,
                                padding=pad)
    return _allreduce_trials(perf.time_scanned(
        fn, x, iters=iters, n_warmup=n_warmup, n_trials=n_trials))


def _halo_method_candidates(options: AutotuneOptions, devices):
    if options.halo_methods:
        return list(options.halo_methods)
    return [HaloMethod.PPERMUTE]


def _trial_op_kwargs(options: AutotuneOptions):
    """Per-op transpose trial payload kwargs (the halo/padding arguments
    the application will use in production — cudecomp.h:195-208).

    The trial runs the 4 ops as a chained (and scanned) cycle
    X2Y;Y2Z;Z2Y;Y2X, so op k's output payload must equal op k+1's input
    payload and the cycle must close — validated here with a clear error
    instead of every candidate failing its shape check."""
    out = [{}, {}, {}, {}]
    for name, val in (
            ("input_halo_extents", options.transpose_input_halo_extents),
            ("output_halo_extents", options.transpose_output_halo_extents),
            ("input_padding", options.transpose_input_padding),
            ("output_padding", options.transpose_output_padding)):
        if val is not None:
            for i in range(4):
                out[i][name] = val[i]
    zero = (0, 0, 0)
    for kind in ("halo_extents", "padding"):
        for k in range(4):
            o = out[k].get(f"output_{kind}", zero)
            i = out[(k + 1) % 4].get(f"input_{kind}", zero)
            if tuple(o) != tuple(i):
                raise ValueError(
                    f"autotune trial payloads do not chain: op {k}'s "
                    f"output_{kind} {tuple(o)} != op {(k + 1) % 4}'s "
                    f"input_{kind} {tuple(i)} (the trial cycle "
                    f"X2Y;Y2Z;Z2Y;Y2X feeds each op's output to the next "
                    f"op's input and wraps around)")
    return tuple(out)


def autotune(
    config: GridConfig,
    devices: Optional[Sequence[jax.Device]] = None,
    options: Optional[AutotuneOptions] = None,
    axis_names: Tuple[str, str] = ("pr", "pc"),
    dtype=None,
) -> AutotuneResult:
    """Search (pdims x transpose strategy), then halo strategy, and return a
    GridDescriptor with the winning configuration frozen in.

    With ``options.grid_mode == "halo"`` the phases invert (the reference's
    ``CUDECOMP_AUTOTUNE_GRID_HALO`` dispatch, src/cudecomp.cc:1200-1211):
    the process grid is chosen by timing halo updates on ``halo_axis``
    pencils across (pdims x halo method), then the transpose strategy is
    tuned with the grid fixed."""
    options = options or AutotuneOptions()
    if devices is None:
        devices = jax.devices()
    nranks = len(devices)
    if dtype is None:
        dtype = options.dtype
    if dtype is None:
        # trial dtype default: float32 (the plain real payload).  Pass
        # dtype=/AutotuneOptions.dtype to tune with the production dtype
        # (reference behavior, autotune.cc:377-483), or use
        # AutotuneOptions.n_components for split-complex payloads.
        dtype = jnp.float32
    n_comp = options.n_components

    if config.autotune_pdims:
        pdims_cands = _valid_pdims(config, nranks, options)
        if not pdims_cands:
            raise ValueError(f"no valid process-grid factorization of {nranks} "
                             f"devices for gdims {config.gdims}")
    else:
        pdims_cands = [config.pdims]

    # ---- grid_mode == "halo": choose the process grid (and halo method)
    # by timing halo updates first (autotuneHaloBackend with grid sweep,
    # src/autotune.cc:771-1124) --------------------------------------------
    halo_first_trials: List[TrialRecord] = []
    halo_first_best = None  # (time, pdims, halo_method)
    if options.grid_mode == "halo":
        if not any(options.halo_extents):
            raise ValueError(
                "grid_mode='halo' requires nonzero AutotuneOptions."
                "halo_extents (the reference rejects this too)")
        # with autotune_halo_method=False the grid is still chosen by halo
        # timing, but only with the CONFIGURED halo method (an explicit
        # config.halo_method must not be overridden)
        halo_cands = (_halo_method_candidates(options, devices)
                      if options.autotune_halo_method
                      else [config.halo_method])
        for pdims in pdims_cands:
            mesh = build_mesh(pdims, devices=devices,
                              rank_order=config.rank_order,
                              axis_names=axis_names)
            for hm in halo_cands:
                cfg = dataclasses.replace(config.with_pdims(pdims),
                                          halo_method=hm)
                grid = GridDescriptor(config=cfg, mesh=mesh,
                                      axis_names=axis_names)
                try:
                    times = _time_halo(grid, dtype, options,
                                       options.n_warmup, options.n_trials,
                                       n_components=options.n_components)
                except Exception:
                    halo_first_trials.append(TrialRecord(
                        pdims, hm.value, (), float("inf"), float("inf"),
                        skipped=True))
                    continue
                avg = float(np.mean(times))
                halo_first_trials.append(TrialRecord(
                    pdims, hm.value, tuple(times), avg,
                    float(np.min(times))))
                if halo_first_best is None or avg < halo_first_best[0]:
                    halo_first_best = (avg, pdims, hm)
        if halo_first_best is None:
            raise RuntimeError("autotuning failed: every halo-mode grid "
                               "candidate was skipped")
        pdims_cands = [halo_first_best[1]]

    from cudecomp_tpu.utils import env as env_util
    if options.autotune_transpose_method:
        default_methods = [TransposeMethod.ALL_TO_ALL, TransposeMethod.RING,
                           TransposeMethod.RING_XOR,
                           TransposeMethod.RING_PIPELINED]
        from cudecomp_tpu.parallel.mesh import n_slices
        if n_slices(devices) > 1:
            # two-tier schedule only differs from RING across slices
            default_methods.append(TransposeMethod.RING_HIER)
        methods = list(options.methods or env_util.filter_candidates(
            "CUDECOMP_TPU_AUTOTUNE_TRANSPOSE_METHODS",
            tuple(default_methods)))
    else:
        methods = [config.transpose_method]

    # layout axis: natural vs axis-contiguous pencils (the reference's
    # benchmark sweeps transpose_axis_contiguous placements); explicit
    # transpose_mem_order configs are left untouched
    if options.autotune_layouts and config.transpose_mem_order is None:
        layouts = [(False,) * 3, (True,) * 3]
    else:
        layouts = [config.transpose_axis_contiguous]

    weights = options.transpose_op_weights
    # validate the per-op trial payload chain ONCE, outside the candidate
    # loop (inside it a ValueError would be swallowed as candidate-skip)
    trial_kwargs = _trial_op_kwargs(options)
    trials: List[TrialRecord] = []
    best = None  # (time, pdims, method, grid)
    first_error: Optional[Exception] = None

    for pdims in pdims_cands:
        mesh = build_mesh(pdims, devices=devices, rank_order=config.rank_order,
                          axis_names=axis_names)
        for method in methods:
          for layout in layouts:
            cfg = dataclasses.replace(config.with_pdims(pdims),
                                      transpose_method=method,
                                      transpose_axis_contiguous=layout)
            grid = GridDescriptor(config=cfg, mesh=mesh, axis_names=axis_names)
            threshold = None
            if options.skip_threshold > 0 and best is not None:
                threshold = options.skip_threshold * best[0]
            method_tag = (method.value if len(layouts) == 1 else
                          f"{method.value}/ac={int(layout[0])}")
            try:
                times, skipped = _time_roundtrip(
                    grid, dtype, weights, options.n_warmup, options.n_trials,
                    threshold, n_components=n_comp, op_kwargs=trial_kwargs)
            except Exception as e:
                # candidate failed to compile/run (OOM analog) — skip it,
                # like the reference's collective OOM fallback (autotune.cc:437-447)
                if first_error is None:
                    first_error = e
                trials.append(TrialRecord(pdims, method_tag, (), float("inf"),
                                          float("inf"), skipped=True))
                continue
            avg = float(np.mean(times))
            rec = TrialRecord(pdims, method_tag, tuple(times), avg,
                              float(np.min(times)), skipped=skipped)
            trials.append(rec)
            if not skipped and (best is None or avg < best[0]):
                best = (avg, pdims, method, grid)

    if best is None:
        raise RuntimeError(
            "autotuning failed: every candidate was skipped"
            + (f"; first failure: {first_error!r}" if first_error else "")
        ) from first_error

    best_time, best_pdims, best_method, best_grid = best

    halo_trials: List[TrialRecord] = []
    best_halo = None
    if options.grid_mode == "halo":
        # phase 1 already chose the halo method along with the grid —
        # freeze it into the winning config
        best_halo = halo_first_best[2]
        halo_trials = halo_first_trials
        best_grid = GridDescriptor(
            config=dataclasses.replace(best_grid.config,
                                       halo_method=best_halo),
            mesh=best_grid.mesh, axis_names=axis_names)
    elif options.autotune_halo_method and any(options.halo_extents):
        halo_methods = _halo_method_candidates(options, devices)
        hbest = None
        for hm in halo_methods:
            cfg = dataclasses.replace(best_grid.config, halo_method=hm)
            grid = GridDescriptor(config=cfg, mesh=best_grid.mesh,
                                  axis_names=axis_names)
            try:
                times = _time_halo(grid, dtype, options, options.n_warmup,
                                   options.n_trials, n_components=n_comp)
            except Exception:
                # one failing halo candidate must not abort the autotune
                # after the transpose sweep succeeded (same candidate-skip
                # as the transpose loop, autotune.cc:437-447 analog)
                halo_trials.append(TrialRecord(best_pdims, hm.value, (),
                                               float("inf"), float("inf"),
                                               skipped=True))
                continue
            avg = float(np.mean(times))
            halo_trials.append(TrialRecord(best_pdims, hm.value, tuple(times),
                                           avg, float(np.min(times))))
            if hbest is None or avg < hbest[0]:
                hbest = (avg, hm, grid)
        if hbest is not None:
            best_halo = hbest[1]
            best_grid = hbest[2]

    # drop the loser candidates' compiled plans (the analog of the
    # reference clearing its graph cache between autotune configs,
    # autotune.cc:629); the winner recompiles on first real use
    from cudecomp_tpu.grid import clear_plan_caches
    clear_plan_caches()

    return AutotuneResult(grid=best_grid, best_pdims=best_pdims,
                          best_method=best_method, best_time_s=best_time,
                          trials=trials, halo_trials=halo_trials,
                          best_halo_method=best_halo)
