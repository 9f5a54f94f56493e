"""Performance-report subsystem — sample capture, aggregation, bandwidth
derivation, CSV export (performance.cc analog)."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import cudecomp_tpu as cd
from cudecomp_tpu.config import GridConfig
from cudecomp_tpu.performance import REGISTRY


def test_perf_registry_records_dispatched_ops(tmp_path):
    REGISTRY.clear()
    cd.perf_report_enable(True)
    try:
        grid = cd.make_grid(GridConfig(gdims=(8, 8, 8), pdims=(2, 2)),
                            devices=jax.devices()[:4])
        x = jax.device_put(jnp.zeros(grid.global_shape(0)), grid.sharding(0))
        for _ in range(3):
            y = cd.transpose_x_to_y(grid, x)
            x = cd.transpose_y_to_x(grid, y)
        he = (1, 1, 1)
        h = jax.device_put(jnp.zeros(grid.global_shape(0, halo_extents=he)),
                           grid.sharding(0))
        # first sample per key is warmup-discarded, so call twice
        cd.update_halos(grid, h, 0, he, (True, True, True))
        cd.update_halos(grid, h, 0, he, (True, True, True))

        rows = REGISTRY.rows()
        names = {r["config"].split("/")[0] for r in rows}
        assert "transpose_x_to_y" in names
        assert "transpose_y_to_x" in names
        assert any(n.startswith("update_halos") for n in names)
        xy = [r for r in rows if r["config"].startswith("transpose_x_to_y")][0]
        assert xy["count"] == 2  # 3 calls - 1 warmup discard
        assert xy["a2a_gbps"] > 0
        report = REGISTRY.report()
        assert "transpose_x_to_y" in report and "A2A GB/s" in report

        paths = REGISTRY.write_csv(str(tmp_path))
        assert paths and all(os.path.exists(p) for p in paths)
        with open(paths[0]) as f:
            assert f.readline().startswith("sample,time_ms")
    finally:
        cd.perf_report_enable(False)
        REGISTRY.clear()


def test_perf_registry_skips_traced_calls():
    REGISTRY.clear()
    cd.perf_report_enable(True)
    try:
        grid = cd.make_grid(GridConfig(gdims=(8, 8, 8), pdims=(2, 2)),
                            devices=jax.devices()[:4])
        x = jax.device_put(jnp.zeros(grid.global_shape(0)), grid.sharding(0))

        @jax.jit
        def f(b):
            return cd.transpose_x_to_y(grid, b)

        f(x)
        # inside jit the op is traced; no sample must be recorded
        assert not REGISTRY.rows()
    finally:
        cd.perf_report_enable(False)
        REGISTRY.clear()


def test_rows_cross_host_reduction(monkeypatch):
    # mocked 2-process deployment: avg averaged, min of mins, max of maxes
    import numpy as np
    import jax
    from cudecomp_tpu import performance as perf

    reg = perf.PerfRegistry()
    reg.enabled = True
    monkeypatch.setattr(perf, "_N_WARMUP_DISCARD", 0)
    reg.record(("op",), 2.0)
    reg.record(("op",), 4.0)

    monkeypatch.setattr(jax, "process_count", lambda: 2)

    class FakeMH:
        @staticmethod
        def process_allgather(x):
            a = np.asarray(x)
            return np.stack([a, a + np.array([1.0, -0.5, 2.0, 0.0, 0.0])])

    monkeypatch.setattr(jax.experimental, "multihost_utils", FakeMH)
    import sys
    monkeypatch.setitem(sys.modules, "jax.experimental.multihost_utils",
                        FakeMH)
    (row,) = reg.rows(cross_host=True)
    # default (non-collective) path must NOT reduce
    (local_row,) = reg.rows()
    assert local_row["avg_ms"] == 3.0
    assert row["avg_ms"] == 3.5       # mean(3, 4)
    assert row["min_ms"] == 1.5       # min(2, 1.5)
    assert row["max_ms"] == 6.0       # max(4, 6)
    assert row["count"] == 4          # global sample count (2 + 2)
    assert local_row["count"] == 2


def test_segment_roundtrip_single_chip_chained():
    # one device, natural layout: every op of the chain is an identity
    # permute, so each op is timed on its own (a chained cycle would fold
    # away) — totals must be positive, a2a zero, all of it local
    from cudecomp_tpu import performance as perf

    cfg = GridConfig(gdims=(16, 16, 16), pdims=(1, 1))
    grid = cd.make_grid(cfg, devices=jax.devices()[:1])
    seg = perf.segment_roundtrip(grid, np.float32, iters=2, n_warmup=1,
                                 n_trials=1, record=False)
    assert seg["total_ms"] > 0
    assert seg["a2a_ms"] == 0.0
    assert seg["local_ms"] == seg["total_ms"]


def test_segment_roundtrip_single_chip_per_op():
    # axis-contiguous pencils: the chain folds to identity, so the per-op
    # pinned branch must be taken (and still return positive totals)
    from cudecomp_tpu import performance as perf

    cfg = GridConfig(gdims=(16, 16, 16), pdims=(1, 1),
                     transpose_axis_contiguous=(True, True, True))
    grid = cd.make_grid(cfg, devices=jax.devices()[:1])
    seg = perf.segment_roundtrip(grid, np.float32, iters=2, n_warmup=1,
                                 n_trials=1, record=False)
    assert seg["total_ms"] > 0
    assert seg["a2a_ms"] == 0.0


def test_segment_roundtrip_multi_device():
    # multi-device grid: chained total with direct a2a segmentation
    from cudecomp_tpu import performance as perf

    n = min(4, len(jax.devices()))
    if n < 2:
        import pytest
        pytest.skip("needs >= 2 devices")
    cfg = GridConfig(gdims=(8, 8, 8), pdims=(1, n))
    grid = cd.make_grid(cfg, devices=jax.devices()[:n])
    seg = perf.segment_roundtrip(grid, np.float32, iters=2, n_warmup=1,
                                 n_trials=1, record=False)
    assert seg["total_ms"] > 0
    assert 0.0 <= seg["a2a_ms"] <= seg["total_ms"]
    assert abs(seg["total_ms"] - seg["a2a_ms"] - seg["local_ms"]) < 1e-9


def test_report_write_dir_env(tmp_path, monkeypatch):
    # CUDECOMP_PERFORMANCE_REPORT_WRITE_DIR analog: report() auto-exports
    # per-config CSVs when the env var is set
    monkeypatch.setenv("CUDECOMP_TPU_PERF_WRITE_DIR", str(tmp_path))
    REGISTRY.enabled = True
    try:
        REGISTRY.record(("testop", (8, 8, 8)), 1.25, 1024)
        REGISTRY.record(("testop", (8, 8, 8)), 1.5, 1024)
        out = REGISTRY.report()
        assert "wrote" in out
        csvs = list(tmp_path.glob("cudecomp_tpu_perf.*.csv"))
        assert csvs, "no CSVs exported"
        body = csvs[0].read_text()
        assert body.startswith("sample,time_ms")
    finally:
        REGISTRY.enabled = False
        REGISTRY.samples.clear()


def test_segment_roundtrip_mixed_on_cpu_takes_per_op_branch():
    # complex payloads take the same one-device per-op branch as real ones
    # (every local permute is XLA's): the c64 round trip moves twice the
    # f32 bytes through the same program shape, so it is timed, not folded
    from cudecomp_tpu import performance as perf

    cfg = GridConfig(gdims=(32, 32, 32), pdims=(1, 1),
                     transpose_axis_contiguous=(True, True, True))
    grid = cd.make_grid(cfg, devices=jax.devices()[:1])
    seg_c = perf.segment_roundtrip(grid, np.complex64, iters=4,
                                   n_warmup=1, n_trials=2, record=False)
    seg_r = perf.segment_roundtrip(grid, np.float32, iters=4,
                                   n_warmup=1, n_trials=2, record=False)
    for seg in (seg_c, seg_r):
        assert seg["total_ms"] > 0
        assert seg["a2a_ms"] == 0.0 and seg["local_ms"] == seg["total_ms"]


def test_segment_roundtrip_single_chip_noncubic_scanned():
    # non-cubic single chip: ops change buffer shape, so the scalar-
    # feedback scan path must be taken and return finite non-negative
    # per-op-summed totals with a2a zero
    from cudecomp_tpu import performance as perf

    cfg = GridConfig(gdims=(24, 16, 8), pdims=(1, 1),
                     transpose_axis_contiguous=(True, True, True))
    grid = cd.make_grid(cfg, devices=jax.devices()[:1])
    seg = perf.segment_roundtrip(grid, np.float32, iters=2, n_warmup=1,
                                 n_trials=1, record=False)
    assert np.isfinite(seg["total_ms"]) and seg["total_ms"] >= 0
    assert seg["a2a_ms"] == 0.0


def test_shapechange_scan_program_keeps_the_op():
    # the whole point of the scalar-feedback + weighted-reduce design:
    # XLA must not hoist the loop-invariant op out of the scan nor fold
    # the reduce through the permutation.  Compile the program for a bare
    # jnp.transpose op and assert a transpose/copy survives in the
    # optimized HLO (a folded program would contain neither: a full
    # reduce of a permutation is permutation-invariant).
    from cudecomp_tpu.performance import _shapechange_scan_fn

    op = lambda v: jnp.transpose(v, (1, 2, 0))
    x = jnp.zeros((24, 16, 8), np.float32)
    w = jnp.ones((16, 8, 24), np.float32)
    wx = jnp.ones((24, 16, 8), np.float32)
    run = _shapechange_scan_fn(op, np.float32, 4, True)
    txt = run.lower(x, w, wx).compile().as_text()
    assert ("transpose" in txt) or ("copy" in txt)
    # and the baseline twin must NOT contain the op
    base = _shapechange_scan_fn(op, np.float32, 4, False)
    float(base(x, w, wx))  # compiles and runs


def test_attributed_trace_joins_device_times(tmp_path):
    # the trace join (performance.cc:391-450 analog): after tracing a real
    # in-pipeline round trip, report() carries a device-time section with
    # the comm/local split, and collectives land in the comm bucket
    from cudecomp_tpu import performance as perf

    REGISTRY.clear()
    cd.perf_report_enable(True)
    try:
        grid = cd.make_grid(GridConfig(gdims=(16, 16, 16), pdims=(2, 2)),
                            devices=jax.devices()[:4])
        x = jax.device_put(jnp.zeros(grid.global_shape(0), jnp.float32),
                           grid.sharding(0))
        fn = jax.jit(lambda a: cd.transpose_y_to_x(
            grid, cd.transpose_x_to_y(grid, a)))
        fn(x).block_until_ready()  # compile outside the trace
        cd.transpose_x_to_y(grid, x)  # wall-clock sample rows
        cd.transpose_x_to_y(grid, x)
        with perf.attributed_trace(str(tmp_path / "tr")) as d:
            fn(x).block_until_ready()
        assert d == str(tmp_path / "tr")
        attr = REGISTRY.trace_attribution
        assert attr is not None and attr["total_ms"] > 0
        # the all-to-all transpose must show collective device time
        assert attr["comm_ms"] > 0
        assert any(k.startswith("all-to-all") for k in attr["ops"])
        rep = REGISTRY.report()
        assert "device-time attribution" in rep
        assert "comm" in rep and "local" in rep
        # wall-clock rows still present next to the device columns
        assert "transpose_x_to_y" in rep
    finally:
        cd.perf_report_enable(False)
        REGISTRY.clear()
    assert REGISTRY.trace_attribution is None  # clear drops the join


def _gpu_form_trace():
    """A small trace-events export in the form the profiler writes on a
    GPU: one host process (python and runtime threads, some events tagged
    with the op they launched) and one process per card whose stream
    threads carry the executed kernels, plus a whole-program lane in the
    device process that covers the same time again."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/host:CPU"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
         "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 2,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 10,
         "args": {"name": "XLA Modules"}},
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 13,
         "args": {"name": "Stream #13(Compute)"}},
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 14,
         "args": {"name": "Stream #14(Collective)"}},
        {"ph": "M", "name": "process_name", "pid": 3,
         "args": {"name": "/device:GPU:1"}},
        {"ph": "M", "name": "thread_name", "pid": 3, "tid": 13,
         "args": {"name": "Stream #13(Compute)"}},
        # host: dispatch spans, one tagged with the op it launched
        {"ph": "X", "pid": 1, "tid": 1, "name": "PjitFunction", "dur": 900},
        {"ph": "X", "pid": 1, "tid": 1, "name": "launch", "dur": 50,
         "args": {"hlo_op": "fusion.1"}},
        # device 0: program span + the kernels it ran, on two streams
        {"ph": "X", "pid": 2, "tid": 10, "name": "jit_step", "dur": 700},
        {"ph": "X", "pid": 2, "tid": 13, "name": "loop_add_fusion",
         "dur": 200, "args": {"hlo_op": "loop_add_fusion"}},
        {"ph": "X", "pid": 2, "tid": 14, "name": "all_to_all.6.1",
         "dur": 300},
        # device 1: one collective kernel
        {"ph": "X", "pid": 3, "tid": 13, "name": "collective-permute.3",
         "dur": 100},
    ]
    return {"traceEvents": ev}


def test_device_op_spans_gpu_trace(tmp_path):
    # GPU form: host lanes are excluded, only the stream lanes of each
    # device process count (the program lane is not counted twice), and
    # the collectives land in the comm bucket
    import gzip
    import json
    from cudecomp_tpu import performance as perf

    spans = perf._device_op_spans(_gpu_form_trace())
    assert sorted(spans) == [("all_to_all.6.1", 0.3),
                             ("collective-permute.3", 0.1),
                             ("loop_add_fusion", 0.2)]
    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump(_gpu_form_trace(), f)
    attr = perf.device_op_attribution(str(tmp_path))
    assert attr["total_ms"] == pytest.approx(0.6)
    assert attr["comm_ms"] == pytest.approx(0.4)
    assert attr["local_ms"] == pytest.approx(0.2)
