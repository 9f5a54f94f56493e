"""Performance-report subsystem — observability for transposes/halos/FFT.

Rebuild of the reference's opt-in performance reporting
(``src/performance.cc``, ``include/internal/performance.h:32-133``,
``common.h:212-244``): where the reference records CUDA event pairs around
each operation into per-configuration circular sample buffers and prints
aggregated tables / CSV exports at destroy time, here a process-global
:class:`PerfRegistry` records wall-clock samples around each *dispatched*
operation (jit boundaries; inside a larger jit the op is fused and cannot be
timed individually — same as the reference's graph-captured paths) plus
derived metrics: total ms and achieved all-to-all bandwidth GB/s, the
headline metric of the reference report (``performance.cc:391,450``).

Enable via env ``CUDECOMP_TPU_ENABLE_PERFORMANCE_REPORT=1`` or
``perf_report_enable()``.  Samples are keyed by an op-configuration tuple
(op name, pencil axis/op pair, buffer shape, dtype, method) like the
reference's config-keyed maps (``performance.h:32-50``).  ``report()``
prints the aggregated table; ``write_csv()`` exports samples with
config-encoding filenames (``performance.cc:480-700`` analog).

Timing helpers for benchmarking live here too, shared by the autotuner and
bench.  All of them use **forced-completion** timing: the timed program ends
in a scalar reduction and the wall clock stops at the Python ``float()``
fetch of that scalar, a barrier that holds on every backend and also
checks that the program produced a value.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


_N_WARMUP_DISCARD = int(os.environ.get("CUDECOMP_TPU_PERF_N_WARMUP", "1"))
_MAX_SAMPLES = int(os.environ.get("CUDECOMP_TPU_PERF_MAX_SAMPLES", "1000"))


@dataclasses.dataclass
class OpSamples:
    """Circular sample buffer per op configuration (common.h:212-244 analog)."""
    key: Tuple
    times_ms: List[float] = dataclasses.field(default_factory=list)
    bytes_moved: int = 0  # per-invocation a2a bytes (for BW derivation)
    n_discarded: int = 0

    def add(self, ms: float):
        if self.n_discarded < _N_WARMUP_DISCARD:
            self.n_discarded += 1
            return
        if len(self.times_ms) >= _MAX_SAMPLES:
            self.times_ms.pop(0)
        self.times_ms.append(ms)


class PerfRegistry:
    def __init__(self):
        self.enabled = os.environ.get(
            "CUDECOMP_TPU_ENABLE_PERFORMANCE_REPORT", "0") == "1"
        self.samples: Dict[Tuple, OpSamples] = {}
        self.trace_attribution: Dict = None

    def record(self, key: Tuple, ms: float, bytes_moved: int = 0):
        s = self.samples.get(key)
        if s is None:
            s = self.samples[key] = OpSamples(key=key, bytes_moved=bytes_moved)
        s.add(ms)

    def attach_trace(self, log_dir: str) -> Dict:
        """Join a :func:`profile_trace` capture into the registry: the next
        :meth:`report` prints per-op DEVICE times and the comm/local split
        next to the wall-clock samples — in-pipeline attribution the
        synthetic-program segmentation (:func:`segment_roundtrip`) cannot
        give (``src/performance.cc:391-450`` analog)."""
        self.trace_attribution = device_op_attribution(log_dir)
        return self.trace_attribution

    def clear(self):
        self.samples.clear()
        self.trace_attribution = None

    # -- reporting -------------------------------------------------------------

    def rows(self, cross_host: bool = False):
        """Aggregated per-config stats.  With ``cross_host=True`` on a
        multi-controller deployment the wall-time stats are additionally
        reduced across processes (min of mins / max of maxes / mean of
        avgs), like the reference's cross-rank MPI reductions
        (performance.cc:391-450).  The reduction is COLLECTIVE: every
        process must call with identical sample keys, so it is opt-in —
        the common 'print on process 0 only' pattern would deadlock."""
        out = []
        multi = cross_host and jax.process_count() > 1
        for key, s in sorted(self.samples.items(), key=lambda kv: str(kv[0])):
            if not s.times_ms and not multi:
                continue
            if s.times_ms:
                t = np.array(s.times_ms)
                avg, mn, mx, std = (float(t.mean()), float(t.min()),
                                    float(t.max()), float(t.std()))
            else:
                # warmup-only on this process: still participate in the
                # collective below (skipping would mismatch allgather
                # counts across processes and deadlock); NaNs are ignored
                # by the nan-aware reductions
                t = np.array([])
                avg = mn = mx = std = float("nan")
            count = len(t)
            if multi:
                from jax.experimental import multihost_utils
                g = np.asarray(multihost_utils.process_allgather(
                    np.array([avg, mn, mx, std, float(count)])))
                g = g.reshape(-1, 5)
                import warnings
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")  # all-NaN slices
                    avg, mn, mx, std = (float(np.nanmean(g[:, 0])),
                                        float(np.nanmin(g[:, 1])),
                                        float(np.nanmax(g[:, 2])),
                                        float(np.nanmean(g[:, 3])))
                count = int(g[:, 4].sum())  # global sample count
                if np.isnan(avg):
                    continue  # no process has post-warmup samples
            row = {
                "config": "/".join(str(k) for k in key),
                "count": count,
                "avg_ms": avg,
                "min_ms": mn,
                "max_ms": mx,
                "std_ms": std,
            }
            if s.bytes_moved:
                row["a2a_gbps"] = s.bytes_moved / (avg / 1e3) / 1e9
            out.append(row)
        return out

    def report(self, detail: int = None, cross_host: bool = False) -> str:
        """Aggregated table; ``detail >= 1`` appends per-sample times per
        config (the reference's detail levels, performance.cc:480-700 —
        level 2's cross-rank gather is the registry itself on a
        multi-controller deployment, where each process holds its own).
        ``cross_host=True`` reduces stats across processes (collective:
        every process must call it).  Default from CUDECOMP_TPU_PERF_DETAIL.
        """
        if detail is None:
            detail = int(os.environ.get("CUDECOMP_TPU_PERF_DETAIL", "0"))
        lines = ["CUDECOMP_TPU: performance report",
                 f"{'config':60s} {'count':>6s} {'avg ms':>10s} {'min ms':>10s} "
                 f"{'max ms':>10s} {'std':>8s} {'A2A GB/s':>10s}"]
        for r in self.rows(cross_host=cross_host):
            bw = f"{r.get('a2a_gbps', 0):.1f}" if "a2a_gbps" in r else "-"
            lines.append(
                f"{r['config']:60s} {r['count']:6d} {r['avg_ms']:10.4f} "
                f"{r['min_ms']:10.4f} {r['max_ms']:10.4f} {r['std_ms']:8.4f} "
                f"{bw:>10s}")
        if detail >= 1:
            for key, s in sorted(self.samples.items(),
                                 key=lambda kv: str(kv[0])):
                if not s.times_ms:
                    continue
                lines.append(f"  samples {'/'.join(str(k) for k in key)}:")
                for i, t in enumerate(s.times_ms):
                    lines.append(f"    {i:4d} {t:10.4f} ms")
        if self.trace_attribution:
            a = self.trace_attribution
            pct = 100.0 * a["comm_ms"] / a["total_ms"] if a["total_ms"] else 0
            lines.append(
                f"  device-time attribution (profiler trace): total "
                f"{a['total_ms']:.3f} ms = comm {a['comm_ms']:.3f} ms "
                f"({pct:.1f}%) + local {a['local_ms']:.3f} ms")
            top = sorted(a["ops"].items(), key=lambda kv: -kv[1])[:10]
            for name, ms in top:
                kind = ("comm" if name.startswith(_COMM_OP_PREFIXES)
                        else "local")
                lines.append(f"    {name:54s} {kind:5s} {ms:10.4f} ms")
        write_dir = os.environ.get("CUDECOMP_TPU_PERF_WRITE_DIR")
        if write_dir:
            # auto-export CSVs at report time, the analog of
            # CUDECOMP_PERFORMANCE_REPORT_WRITE_DIR (docs/env_vars.rst:77-91)
            paths = self.write_csv(write_dir)
            lines.append(f"  wrote {len(paths)} CSV file(s) to {write_dir}")
        return "\n".join(lines)

    def write_csv(self, directory: str = ".", prefix: str = "cudecomp_tpu_perf"):
        """Per-config CSV export with config-encoding filenames."""
        paths = []
        os.makedirs(directory, exist_ok=True)
        for key, s in self.samples.items():
            if not s.times_ms:
                continue
            tag = "_".join(str(k).replace(" ", "").replace("/", "-")
                           for k in key)
            path = os.path.join(directory, f"{prefix}.{tag}.csv")
            with open(path, "w") as f:
                f.write("sample,time_ms\n")
                for i, t in enumerate(s.times_ms):
                    f.write(f"{i},{t}\n")
            paths.append(path)
        return paths


REGISTRY = PerfRegistry()


def perf_report_enable(enable: bool = True):
    REGISTRY.enabled = enable


def _force_bytes(out):
    """Completion barrier for an already-dispatched op: block, then fetch
    one element's concrete bytes from EVERY output leaf (multi-output ops
    need every buffer forced)."""
    jax.block_until_ready(out)
    for leaf in jax.tree_util.tree_leaves(out):
        if hasattr(leaf, "addressable_shards") and leaf.addressable_shards:
            shard = leaf.addressable_shards[0].data
            np.asarray(shard[(0,) * shard.ndim])


def maybe_record(key_fn: Callable, run_fn: Callable, arr):
    """Run ``run_fn(arr)``; when reporting is enabled and ``arr`` is a
    concrete array (dispatched, not traced), record a wall-time sample.

    Inside a larger jit the op is fused and cannot be timed individually —
    the same limitation the reference has for CUDA-graph-captured paths."""
    if not REGISTRY.enabled or isinstance(arr, jax.core.Tracer):
        return run_fn(arr)
    t0 = time.perf_counter()
    out = run_fn(arr)
    _force_bytes(out)
    ms = (time.perf_counter() - t0) * 1e3
    key, nbytes = key_fn()
    REGISTRY.record(key, ms, nbytes)
    return out


def _time_exchanges(grid, dtype, method_key: str, *, iters, n_warmup,
                    n_trials) -> float:
    """Sum of scanned exchange-only timings for the 4 transpose steps.

    Each exchange runs on a synthetic block buffer of exactly the shapes
    the engine exchanges (pad-to-max chunks), under ``shard_map`` over the
    op's comm axis; the buffer is shape-preserving so the exchange chains
    under ``lax.scan`` and nothing can fold (collectives are opaque to the
    simplifier).  Slab steps (P == 1) cost zero."""
    from cudecomp_tpu import geometry
    from cudecomp_tpu.parallel.collectives import EXCHANGES, shard_map_fn
    from jax.sharding import PartitionSpec

    cfg = grid.config
    m = "ring" if method_key == "ring_pipelined" else method_key
    exch = EXCHANGES[m]
    total = 0.0
    for ax, dir_ in ((0, +1), (1, +1), (2, -1), (1, -1)):
        comm_pd = geometry.shard_pdim_of_dim(ax + dir_, ax)
        P = cfg.pdims[comm_pd]
        if P == 1:
            continue
        name = grid.axis_names[comm_pd]
        scatter = ax  # the input-pencil dim that splits across peers
        ms_in = geometry.max_splits(cfg, ax)
        Bs = geometry.max_splits(cfg, ax + dir_)[scatter]
        other = [ms_in[d] for d in range(3) if d != scatter]
        kwargs = {}
        if m == "ring_hier":
            from cudecomp_tpu.parallel.mesh import axis_group_size
            kwargs["group"] = axis_group_size(grid.mesh, name)

        def body(b, P=P, Bs=Bs, name=name, kw=kwargs):
            return exch(b, name, P, Bs, **kw)

        fn = shard_map_fn(body, grid.mesh,
                          in_specs=(PartitionSpec(name),),
                          out_specs=PartitionSpec(name))
        blocks = jax.device_put(
            np.zeros((P * P * Bs, other[0], other[1]), dtype),
            jax.sharding.NamedSharding(grid.mesh, PartitionSpec(name)))
        total += float(np.min(time_scanned(
            fn, blocks, iters=iters, n_warmup=n_warmup, n_trials=n_trials)))
    return total


def segment_roundtrip(grid, dtype=np.float32, *, method=None, iters: int = 2,
                      n_warmup: int = 2, n_trials: int = 5,
                      record: bool = True) -> Dict[str, float]:
    """Segment the 4-op transpose round trip into a2a vs local time.

    The reference wraps each all-to-all step in its own CUDA event pair and
    reports total / A2A / local ms plus achieved A2A bandwidth
    (``performance.cc:391,450``).  Inside one XLA program the collective
    cannot be timed separately, so the a2a phase is measured with scanned
    exchange-only programs on synthetic block buffers of the exact
    exchanged shapes (collectives cannot be folded by the simplifier) and
    local time is derived by subtraction; on a single device each op is
    timed in its own scan (the chained cycle composes to the identity and
    XLA deletes it).  Returns total_ms / a2a_ms / local_ms / a2a_gbps
    (per chip).
    """
    from cudecomp_tpu import geometry
    from cudecomp_tpu.ops import transpose as tr

    cfg = grid.config
    m = method.value if hasattr(method, "value") else (
        method or cfg.transpose_method.value)

    def rt(mm):
        def f(a):
            b = tr.transpose_x_to_y(grid, a, method=mm)
            b = tr.transpose_y_to_z(grid, b, method=mm)
            b = tr.transpose_z_to_y(grid, b, method=mm)
            return tr.transpose_y_to_x(grid, b, method=mm)
        return f

    ops = [(tr.transpose_x_to_y, 0), (tr.transpose_y_to_z, 1),
           (tr.transpose_z_to_y, 2), (tr.transpose_y_to_x, 1)]
    shapes_match = (grid.global_shape(0) == grid.global_shape(1)
                    == grid.global_shape(2))
    if cfg.pdims == (1, 1):
        # On one device a chained round trip composes to the
        # identity permutation and XLA folds it away entirely (even
        # through lax.optimization_barrier) — time each op separately
        # instead, the analog of the reference's per-op event pairs.
        # a2a is zero by definition.
        total = 0.0
        if shapes_match:
            # cubic: each op is shape-preserving, so scan it (iterations
            # cannot fuse with each other); the *1.0000001 pins a real
            # elementwise pass so layout assignment cannot turn the
            # permute into a bitcast on the scan carry
            for op, in_ax in ops:
                xo = jax.device_put(np.zeros(grid.global_shape(in_ax),
                                             dtype), grid.sharding(in_ax))
                total += float(np.min(time_scanned(
                    lambda a, op=op: op(grid, a, method=m) * 1.0000001, xo,
                    iters=iters, n_warmup=n_warmup, n_trials=n_trials)))
        else:
            # non-cubic: ops change buffer shape, so they cannot scan on
            # their own carry; time each via the scalar-feedback scan
            # (amortizes the per-dispatch overhead, which would otherwise
            # swamp sub-ms ops — see time_scanned_shapechange)
            outs = [1, 2, 1, 0]  # output pencil axis of each cycle op
            for (op, in_ax), o_ax in zip(ops, outs):
                xo = jax.device_put(np.zeros(grid.global_shape(in_ax),
                                             dtype), grid.sharding(in_ax))
                total += float(np.min(time_scanned_shapechange(
                    lambda a, op=op: op(grid, a, method=m), xo,
                    grid.global_shape(o_ax), iters=max(iters, 8),
                    n_warmup=n_warmup, n_trials=n_trials,
                    device=grid.mesh.devices.flat[0])))
        local, a2a = total, 0.0
    else:
        # Chained round trip = what a real pipeline sees (adjacent ops may
        # legitimately fuse); the a2a phase is timed DIRECTLY with scanned
        # exchange-only programs (shape-preserving, and collectives cannot
        # be folded), local = total - a2a.  This is the honest inversion of
        # the reference's per-step a2a event pairs (performance.cc:391,450).
        x = jax.device_put(np.zeros(grid.global_shape(0), dtype),
                           grid.sharding(0))
        total = float(np.min(time_scanned(
            rt(m), x, iters=iters, n_warmup=n_warmup, n_trials=n_trials)))
        a2a = _time_exchanges(grid, dtype, m, iters=iters,
                              n_warmup=n_warmup, n_trials=n_trials)
        # at very small problem sizes per-program overhead can make the 4
        # isolated exchange timings exceed the fused round trip; clamp (the
        # segmentation is meaningful when op time >> dispatch overhead)
        a2a = min(a2a, total)
        local = max(total - a2a, 0.0)

    # per-chip bytes leaving the chip over the round trip (4 exchanges)
    itemsize = np.dtype(dtype).itemsize
    nbytes = 0
    for ax, dir_ in ((0, +1), (1, +1), (2, -1), (1, -1)):
        P = cfg.pdims[geometry.shard_pdim_of_dim(ax + dir_, ax)]
        ms_in = geometry.max_splits(cfg, ax)
        elems = ms_in[0] * ms_in[1] * ms_in[2]
        nbytes += int(elems * itemsize * (P - 1) / max(P, 1))
    gbps = nbytes / a2a / 1e9 if a2a > 0 else 0.0

    out = {"total_ms": total * 1e3, "a2a_ms": a2a * 1e3,
           "local_ms": local * 1e3, "a2a_gbps": gbps}
    if record and REGISTRY.enabled:
        key = ("transpose_roundtrip_segmented", cfg.gdims, cfg.pdims, m,
               str(np.dtype(dtype)))
        REGISTRY.record(key + ("total",), out["total_ms"], nbytes)
        REGISTRY.record(key + ("a2a",), out["a2a_ms"], nbytes)
        REGISTRY.record(key + ("local",), out["local_ms"])
    return out


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a jax.profiler trace around a region — the deep-inspection
    analog of the reference's NVTX+Nsight workflow.  View with
    ``tensorboard --logdir <log_dir>`` or Perfetto."""
    with jax.profiler.trace(log_dir):
        yield


# collective ops by HLO name; GPU kernel spans spell some of them with
# underscores (``all_to_all.6.1`` as read on the H100)
_COMM_OP_PREFIXES = tuple(
    p for op in ("all-to-all", "collective-permute", "all-gather",
                 "all-reduce", "reduce-scatter", "collective-broadcast",
                 "send", "recv")
    for p in {op, op.replace("-", "_")})

def _device_op_spans(data) -> List[Tuple[str, float]]:
    """(op name, ms) for every device-executed op span of one trace-events
    export.

    On a GPU the profiler writes one process per card, ``/device:GPU:<n>``,
    whose ``Stream #<k>(...)`` threads carry one span per executed kernel,
    named by its HLO op (``loop_multiply_fusion``, ``wrapped_transpose``,
    ``all-to-all.1``...).  Only those stream threads count: host processes
    (``/host:CPU``) record dispatch, not execution, and any other thread
    of a device process (whole-program or step lanes) would count the same
    time twice.  A trace with no device process (the CPU backend) keeps
    the host events that carry an ``hlo_op`` tag, which are the executed
    ops there."""
    events = data.get("traceEvents", [])
    pids, tids = {}, {}
    for e in events:
        if e.get("ph") != "M":
            continue
        if e.get("name") == "process_name":
            pids[e["pid"]] = e["args"].get("name", "")
        elif e.get("name") == "thread_name":
            tids[(e.get("pid"), e.get("tid"))] = e["args"].get("name", "")
    dev_pids = {p for p, n in pids.items() if n.startswith("/device:GPU")}
    out = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        hlo = (e.get("args") or {}).get("hlo_op")
        if dev_pids:
            keep = (e.get("pid") in dev_pids and tids.get(
                (e.get("pid"), e.get("tid")), "").startswith("Stream"))
        else:
            keep = bool(hlo)
        if keep:
            out.append((hlo or e.get("name", "?"), e["dur"] / 1e3))
    return out


def device_op_attribution(log_dir: str) -> Dict:
    """Comm/local device-time split from a :func:`profile_trace` capture.

    Keeps only device-executed HLO spans (see :func:`_device_op_spans`)
    and buckets them by op name into collective-communication time vs
    local compute — the in-pipeline attribution the reference samples
    with event pairs around every a2a step inside the production op
    (``src/performance.cc:391-450``).  Times sum across device lanes.

    Returns ``{"ops": {name: ms}, "comm_ms", "local_ms", "total_ms"}``.
    """
    import glob
    import gzip
    import json as _json
    ops: Dict[str, float] = {}
    for path in glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                          recursive=True):
        with gzip.open(path, "rt") as f:
            data = _json.load(f)
        for name, ms in _device_op_spans(data):
            ops[name] = ops.get(name, 0.0) + ms
    comm = sum(v for k, v in ops.items()
               if k.startswith(_COMM_OP_PREFIXES))
    total = sum(ops.values())
    return {"ops": ops, "comm_ms": comm, "local_ms": total - comm,
            "total_ms": total}


@contextlib.contextmanager
def attributed_trace(log_dir: str = None):
    """Trace a region and attach its device-time attribution to
    :data:`REGISTRY`, so the next ``REGISTRY.report()`` prints device-side
    comm/local columns next to the wall-clock samples::

        with perf.attributed_trace():
            roundtrip(x).block_until_ready()
        print(perf.REGISTRY.report())
    """
    import tempfile
    d = log_dir or tempfile.mkdtemp(prefix="cudecomp_tpu_trace_")
    with jax.profiler.trace(d):
        yield d
    REGISTRY.attach_trace(d)


# ---------------------------------------------------------------------------
# shared timing protocol (autotune + bench) — forced completion
# ---------------------------------------------------------------------------

def completion_scalar(out):
    """Reduce a pytree of arrays to one scalar whose value depends on every
    output buffer.  Fetching it with ``float()`` is the completion barrier
    of every timing helper here."""
    acc = None
    for leaf in jax.tree_util.tree_leaves(out):
        if not hasattr(leaf, "dtype"):
            continue
        x = leaf
        if jnp.issubdtype(x.dtype, jnp.complexfloating):
            x = jnp.real(x) + jnp.imag(x)
        elif not jnp.issubdtype(x.dtype, jnp.floating):
            x = x.astype(jnp.float32)
        s = jnp.sum(x)
        acc = s if acc is None else acc + s
    return jnp.zeros(()) if acc is None else acc


def time_fn(fn, *args, n_warmup: int = 3, n_trials: int = 5,
            reduce: str = "avg") -> Tuple[float, List[float]]:
    """Warmup + timed trials of a callable (autotune.cc:541-626 protocol)
    with a forced-completion barrier; returns (reduced seconds, trials)."""
    timed = jax.jit(lambda *a: completion_scalar(fn(*a)))
    for _ in range(n_warmup):
        float(timed(*args))
    times = []
    for _ in range(n_trials):
        t0 = time.perf_counter()
        float(timed(*args))
        times.append(time.perf_counter() - t0)
    red = {"avg": np.mean, "min": np.min, "max": np.max}[reduce]
    return float(red(times)), times


class ScannedTimer:
    """A prepared forced-completion scan program that can be timed in
    multiple rounds WITHOUT re-tracing/re-compiling (a probe + full-trials
    protocol shares the executable, so compilation is paid once)."""

    def __init__(self, fn, x, iters: int):
        self.x = x
        self.iters = iters

        @jax.jit
        def run(v):
            def body(c, _):
                return fn(c), ()
            out, _ = lax.scan(body, v, None, length=iters)
            return completion_scalar(out)

        self._run = run

    def time(self, n_warmup: int, n_trials: int) -> List[float]:
        """Per-iteration seconds for ``n_trials`` timed runs after
        ``n_warmup`` untimed ones (warm-up persists across calls: the
        program is compiled once per ScannedTimer)."""
        for _ in range(n_warmup):
            float(self._run(self.x))
        times = []
        for _ in range(n_trials):
            t0 = time.perf_counter()
            float(self._run(self.x))
            times.append((time.perf_counter() - t0) / self.iters)
        return times


def time_scanned_shapechange(op, x, out_shape, *, iters: int = 8,
                             n_warmup: int = 2, n_trials: int = 5,
                             device=None) -> List[float]:
    """Scan-amortized timing of a shape-CHANGING op on one chip.

    A shape-changing op cannot be scanned on its own carry (the output
    does not feed the next input), and one-shot dispatch timing carries
    the dispatch and fetch overhead as noise on every sub-ms
    measurement.  This program instead scans a
    scalar carry ``s`` that is fed back into the operand
    (``x * (1 + 1e-12 * s)``) so the op's input genuinely depends on the
    previous iteration — XLA cannot hoist the loop-invariant op out of
    the scan — and reduces each output against a runtime-argument weight
    tensor (``sum(y * w)``), which the algebraic simplifier cannot
    constant-fold through the permutation (``w`` is a device buffer, and
    relocating the transpose onto ``w`` costs the same pass; a bare
    ``sum(y)`` WOULD fold, since a full reduce of a permutation is
    permutation-invariant).  The carry/reduce overhead is measured by a
    twin scan without the op and subtracted, so the residual bias is a
    fraction of one elementwise pass rather than a dispatch round trip —
    the per-op analog of the reference's CUDA-event pairs
    (``performance.cc:391``) for ops the cubic scanning path cannot time.

    Returns per-iteration seconds per trial (clamped at >= 0).
    """
    dt = x.dtype
    device = device if device is not None else jax.devices()[0]
    w = jax.device_put(np.ones(out_shape, dt), device)
    wx = jax.device_put(np.ones(x.shape, dt), device)

    def timed(run_op):
        run = _shapechange_scan_fn(op, dt, iters, run_op)
        for _ in range(n_warmup):
            float(run(x, w, wx))
        ts = []
        for _ in range(n_trials):
            t0 = time.perf_counter()
            float(run(x, w, wx))
            ts.append((time.perf_counter() - t0) / iters)
        return ts

    with_op = timed(True)
    base = float(np.min(timed(False)))
    return [max(t - base, 0.0) for t in with_op]


def _shapechange_scan_fn(op, dt, iters: int, run_op: bool):
    """The jitted scalar-feedback scan program behind
    ``time_scanned_shapechange`` (factored out so tests can inspect its
    optimized HLO and assert the op survives compilation)."""

    @jax.jit
    def run(v, wo, wi):
        def body(s, _):
            vi = v * (1 + 1e-12 * s)
            if run_op:
                return jnp.sum(op(vi) * wo), ()
            return jnp.sum(vi * wi), ()
        out, _ = lax.scan(body, jnp.zeros((), dt), None, length=iters)
        return completion_scalar(out)

    return run


def time_scanned(fn, x, *, iters: int = 2, n_warmup: int = 2,
                 n_trials: int = 5) -> List[float]:
    """Forced-completion timing of a shape-preserving op chain.

    Runs ``iters`` applications of ``fn`` inside one jit via ``lax.scan``
    (amortizing per-dispatch latency) ending in a scalar reduction;
    returns per-iteration seconds for each trial.  This is the timing
    protocol of ``bench.py`` shared with the autotuner (the analog of the
    reference's CUDA-event trials, autotune.cc:541-626)."""
    return ScannedTimer(fn, x, iters).time(n_warmup, n_trials)
