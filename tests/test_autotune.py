"""Autotuner behavior — candidate enumeration, empty-pencil skipping,
two-phase (grid+strategy, then halo), frozen winning config
(autotune.cc analog)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cudecomp_tpu as cd
from cudecomp_tpu.config import (AutotuneOptions, GridConfig, HaloMethod,
                                 TransposeMethod)
from cudecomp_tpu.autotune import autotune, _valid_pdims


def test_valid_pdims_skips_empty_pencils():
    cfg = GridConfig(gdims=(2, 2, 64))
    opts = AutotuneOptions()
    cands = _valid_pdims(cfg, 4, opts)
    # any factor > 2 would leave empty pencils on dims 0/1
    assert cands == [(2, 2)]


def test_pr_pc_range_clamps():
    cfg = GridConfig(gdims=(64, 64, 64))
    opts = AutotuneOptions(pr_range=(2, 4), pc_range=(2, 4))
    cands = _valid_pdims(cfg, 8, opts)
    assert cands == [(2, 4), (4, 2)]


def test_autotune_end_to_end():
    cfg = GridConfig(gdims=(16, 16, 16))
    opts = AutotuneOptions(n_warmup=1, n_trials=2)
    result = autotune(cfg, devices=jax.devices()[:4], options=opts,
                      dtype=jnp.complex64)
    assert result.best_pdims in ((1, 4), (2, 2), (4, 1))
    assert isinstance(result.best_method, TransposeMethod)
    assert result.grid.config.pdims == result.best_pdims
    assert result.grid.config.transpose_method == result.best_method
    assert len(result.trials) >= 6  # 3 grids x 2 methods
    assert "selected" in result.report()


def test_autotune_fixed_pdims_method_sweep():
    cfg = GridConfig(gdims=(16, 16, 16), pdims=(2, 2))
    opts = AutotuneOptions(n_warmup=1, n_trials=2)
    result = autotune(cfg, devices=jax.devices()[:4], options=opts)
    assert result.best_pdims == (2, 2)
    assert {t.pdims for t in result.trials} == {(2, 2)}


def test_autotune_halo_phase():
    cfg = GridConfig(gdims=(16, 16, 16))
    opts = AutotuneOptions(n_warmup=1, n_trials=2,
                           autotune_halo_method=True,
                           halo_extents=(1, 1, 1))
    result = autotune(cfg, devices=jax.devices()[:4], options=opts)
    assert result.best_halo_method == HaloMethod.PPERMUTE
    assert result.halo_trials


def test_make_grid_runs_autotune():
    cfg = GridConfig(gdims=(16, 16, 16))  # pdims (0,0) -> autotune
    opts = AutotuneOptions(n_warmup=0, n_trials=1)
    grid = cd.make_grid(cfg, devices=jax.devices()[:4], autotune_options=opts)
    assert grid.config.pdims[0] * grid.config.pdims[1] == 4


def test_save_and_load_tuned_config(tmp_path):
    import cudecomp_tpu as cd
    from cudecomp_tpu.autotune import load_tuned_config
    cfg = cd.GridConfig(gdims=(16, 16, 16))
    opts = cd.AutotuneOptions(n_warmup=0, n_trials=1)
    result = autotune(cfg, devices=jax.devices()[:4], options=opts)
    p = str(tmp_path / "tuned.json")
    result.save_json(p)
    cfg2 = load_tuned_config(p, cfg)
    assert cfg2.pdims == result.best_pdims
    assert cfg2.transpose_method == result.best_method


def test_cross_host_trial_reduction(monkeypatch):
    # mocked multi-controller: trial times are averaged across processes so
    # every host scores candidates identically (autotune.cc:167-188 analog)
    import numpy as np
    from importlib import import_module
    at = import_module("cudecomp_tpu.autotune")

    monkeypatch.setattr(jax, "process_count", lambda: 2)

    class FakeMH:
        @staticmethod
        def process_allgather(x):
            return np.stack([np.asarray(x), np.asarray(x) + 1.0])

    monkeypatch.setattr(jax.experimental, "multihost_utils", FakeMH)
    import sys
    monkeypatch.setitem(sys.modules, "jax.experimental.multihost_utils",
                        FakeMH)
    out = at._allreduce_trials([1.0, 3.0])
    assert out == [1.5, 3.5]


def test_autotune_error_surfaced(monkeypatch):
    # when every candidate fails, the first underlying exception is chained
    import pytest
    from importlib import import_module
    at = import_module("cudecomp_tpu.autotune")

    def boom(*a, **k):
        raise RuntimeError("kaboom-inner")

    monkeypatch.setattr(at, "_time_roundtrip", boom)
    cfg = GridConfig(gdims=(16, 16, 16))
    with pytest.raises(RuntimeError, match="kaboom-inner"):
        autotune(cfg, devices=jax.devices()[:4],
                 options=AutotuneOptions(n_warmup=0, n_trials=1))


def test_autotune_layout_axis():
    # autotune_layouts sweeps natural vs axis-contiguous pencils and the
    # winner's layout is frozen into the returned grid
    cfg = GridConfig(gdims=(16, 16, 16))
    opts = AutotuneOptions(n_warmup=0, n_trials=1, autotune_layouts=True,
                           methods=(cd.TransposeMethod.ALL_TO_ALL,))
    result = autotune(cfg, devices=jax.devices()[:4], options=opts)
    tags = {t.method for t in result.trials}
    assert any("ac=0" in t for t in tags) and any("ac=1" in t for t in tags)
    assert result.grid.config.transpose_axis_contiguous in (
        (False,) * 3, (True,) * 3)


def test_skip_threshold_probe_early_out(monkeypatch):
    # a candidate whose cheap probe exceeds the threshold never runs the
    # full trial protocol (real wall-time early-out, autotune.cc:578-602);
    # the probe runs on the SAME prepared executable (no second compile)
    from cudecomp_tpu import performance as perf
    from cudecomp_tpu.autotune import _time_roundtrip
    calls = []
    timers = []
    orig_time = perf.ScannedTimer.time
    orig_init = perf.ScannedTimer.__init__

    def counting_init(self, fn, x, iters):
        timers.append(self)
        orig_init(self, fn, x, iters)

    def counting_time(self, n_warmup, n_trials):
        calls.append((n_warmup, n_trials))
        return orig_time(self, n_warmup, n_trials)

    monkeypatch.setattr(perf.ScannedTimer, "__init__", counting_init)
    monkeypatch.setattr(perf.ScannedTimer, "time", counting_time)
    cfg = GridConfig(gdims=(16, 16, 16), pdims=(4, 1))
    grid = cd.make_grid(cfg, devices=jax.devices()[:4])
    times, skipped = _time_roundtrip(grid, jnp.float32, (1.0,) * 4,
                                     n_warmup=2, n_trials=3,
                                     skip_after_first_above=1e-12)
    assert skipped and len(times) == 1
    assert calls == [(1, 1)]   # only the probe ran
    assert len(timers) == 1    # one program built (probe shares it)

    # not skipped: the full trials REUSE the probe's timer (no recompile)
    calls.clear()
    timers.clear()
    times, skipped = _time_roundtrip(grid, jnp.float32, (1.0,) * 4,
                                     n_warmup=2, n_trials=3,
                                     skip_after_first_above=1e12)
    assert not skipped and len(times) == 3
    assert calls == [(1, 1), (0, 3)] and len(timers) == 1


def test_halo_candidate_failure_skipped(monkeypatch):
    # one failing halo method is recorded SKIPPED instead of aborting the
    # autotune after the transpose sweep succeeded
    from importlib import import_module
    at = import_module("cudecomp_tpu.autotune")
    orig = at._time_halo
    calls = []

    def maybe_boom(grid, *a, **k):
        calls.append(grid.config.halo_method)
        if len(calls) == 1:
            raise RuntimeError("halo kaboom")
        return orig(grid, *a, **k)

    monkeypatch.setattr(at, "_time_halo", maybe_boom)
    cfg = GridConfig(gdims=(16, 16, 16), pdims=(2, 2))
    opts = AutotuneOptions(n_warmup=0, n_trials=1,
                           autotune_halo_method=True, halo_extents=(1, 1, 1),
                           halo_methods=(HaloMethod.PPERMUTE,
                                         HaloMethod.PPERMUTE),
                           methods=(TransposeMethod.ALL_TO_ALL,))
    result = autotune(cfg, devices=jax.devices()[:4], options=opts)
    assert result.best_halo_method == HaloMethod.PPERMUTE
    assert any(t.skipped for t in result.halo_trials)
    assert any(not t.skipped for t in result.halo_trials)


def test_autotune_production_payload_knobs():
    # AutotuneOptions.dtype / n_components: trials run the production
    # split-complex payload (reference tunes with the configured dtype,
    # autotune.cc:377-483)
    cfg = GridConfig(gdims=(16, 16, 16), pdims=(2, 2))
    opts = AutotuneOptions(n_warmup=0, n_trials=1, n_components=1,
                           dtype="float32",
                           methods=(TransposeMethod.ALL_TO_ALL,),
                           autotune_halo_method=True, halo_extents=(1, 1, 1))
    result = autotune(cfg, devices=jax.devices()[:4], options=opts)
    assert result.best_method == TransposeMethod.ALL_TO_ALL
    assert result.halo_trials


def test_nonuniform_weights_reduced_before_differencing():
    # per-program reduction happens before the xy/yz differencing, so the
    # yz term is a single non-negative constant across trials
    cfg = GridConfig(gdims=(16, 16, 16), pdims=(2, 2))
    grid = cd.make_grid(cfg, devices=jax.devices()[:4])
    from cudecomp_tpu.autotune import _time_roundtrip
    times, skipped = _time_roundtrip(grid, jnp.float32,
                                     (2.0, 1.0, 1.0, 2.0),
                                     n_warmup=1, n_trials=3,
                                     skip_after_first_above=None)
    assert not skipped and len(times) == 3
    assert all(t > 0 for t in times)


def test_grid_mode_halo_selects_grid():
    # reference CUDECOMP_AUTOTUNE_GRID_HALO dispatch (cudecomp.cc:1200-1211):
    # the process grid is chosen by halo timing, then the transpose method
    # is tuned with the grid fixed
    opts = cd.AutotuneOptions(n_warmup=1, n_trials=2, grid_mode="halo",
                              halo_extents=(1, 1, 1))
    cfg = cd.GridConfig(gdims=(16, 16, 16), pdims=(0, 0))
    res = autotune(cfg, options=opts)
    assert res.best_halo_method is not None
    assert res.halo_trials  # the grid sweep's halo trials are recorded
    assert res.grid.config.halo_method == res.best_halo_method
    # all halo trials cover > 1 pdims candidate on an 8-device mesh
    assert len({t.pdims for t in res.halo_trials}) > 1
    # transpose trials ran only on the halo-chosen grid
    assert {t.pdims for t in res.trials} == {res.best_pdims}


def test_grid_mode_halo_requires_extents():
    opts = cd.AutotuneOptions(grid_mode="halo")
    cfg = cd.GridConfig(gdims=(16, 16, 16), pdims=(0, 0))
    with pytest.raises(ValueError, match="halo_extents"):
        autotune(cfg, options=opts)


def test_grid_mode_validation():
    with pytest.raises(ValueError, match="grid_mode"):
        cd.AutotuneOptions(grid_mode="bogus")


def test_allow_uneven_decompositions_filter():
    from cudecomp_tpu.autotune import _valid_pdims

    cfg = cd.GridConfig(gdims=(36, 36, 36), pdims=(0, 0))
    allow = _valid_pdims(cfg, 8, cd.AutotuneOptions())
    strict = _valid_pdims(
        cfg, 8, cd.AutotuneOptions(allow_uneven_decompositions=False))
    assert (1, 8) in allow and (8, 1) in allow
    # 36 % 8 != 0: grids with an 8-way axis are uneven -> excluded
    assert set(strict) == {(2, 4), (4, 2)}
    # divisible gdims keep every candidate
    cfg2 = cd.GridConfig(gdims=(32, 32, 32), pdims=(0, 0))
    assert _valid_pdims(
        cfg2, 8, cd.AutotuneOptions(allow_uneven_decompositions=False)) == \
        _valid_pdims(cfg2, 8, cd.AutotuneOptions())


def test_trial_op_payload_halos():
    # trials run with the production per-op halo payloads
    # (transpose_input_halo_extents, cudecomp.h:195-208)
    he = (1, 1, 1)
    per_op = (he, he, he, he)
    opts = cd.AutotuneOptions(n_warmup=1, n_trials=2,
                              transpose_input_halo_extents=per_op,
                              transpose_output_halo_extents=per_op)
    cfg = cd.GridConfig(gdims=(16, 16, 16), pdims=(0, 0))
    res = autotune(cfg, options=opts)
    assert res.best_pdims in {t.pdims for t in res.trials}
    # non-uniform weights + payload halos: honored at pair granularity
    # (chained X2Y;Y2Z and Z2Y;Y2X programs, weighted (w0+w1)/2 and
    # (w2+w3)/2) — not collapsed to the mean
    opts2 = cd.AutotuneOptions(n_warmup=1, n_trials=2,
                               transpose_op_weights=(2.0, 1.0, 1.0, 2.0),
                               transpose_input_halo_extents=per_op,
                               transpose_output_halo_extents=per_op)
    res2 = autotune(cfg, options=opts2)
    assert res2.best_time_s > 0


def test_nonuniform_weights_with_payloads_distinct_scores(monkeypatch):
    # the per-pair decomposition must actually use the weights: with
    # deterministic fake pair timings, different weight vectors score the
    # same candidate differently (fwd pair weighted vs bwd pair weighted),
    # payloads present the whole time
    from cudecomp_tpu import autotune as at
    from cudecomp_tpu import performance as perf

    calls = []

    class FakeScannedTimer:
        # the pair path builds ONE ScannedTimer per pair program (fwd
        # first) and reuses it for probe + trials; tag by build order
        # with fixed distinct per-iteration times
        def __init__(self, fn, x, iters):
            calls.append(1)
            self._t = 0.1 if len(calls) % 2 == 1 else 0.3

        def time(self, n_warmup, n_trials):
            return [self._t] * max(n_trials, 1)

    monkeypatch.setattr(perf, "ScannedTimer", FakeScannedTimer)

    he = ((1, 1, 1),) * 4
    cfg = cd.GridConfig(gdims=(16, 16, 16), pdims=(2, 4))

    def score(weights):
        calls.clear()
        opts = cd.AutotuneOptions(
            n_warmup=1, n_trials=1, transpose_op_weights=weights,
            autotune_transpose_method=False,
            transpose_input_halo_extents=he,
            transpose_output_halo_extents=he)
        res = autotune(cfg, options=opts)
        # one fwd-pair + one bwd-pair program, shared by probe and trials
        assert len(calls) == 2
        return res.best_time_s

    # fwd-heavy weights score 2*0.1? no: w_fwd=(4+4)/2=4 -> 4*0.1 + 1*0.3
    s_fwd_heavy = score((4.0, 4.0, 1.0, 1.0))   # 4*0.1 + 1*0.3 = 0.7
    s_bwd_heavy = score((1.0, 1.0, 4.0, 4.0))   # 1*0.1 + 4*0.3 = 1.3
    assert abs(s_fwd_heavy - 0.7) < 1e-9
    assert abs(s_bwd_heavy - 1.3) < 1e-9
    assert s_fwd_heavy != s_bwd_heavy


def test_per_op_weights_select_different_winners(monkeypatch):
    # exact per-op weighting (autotune.cc:631-680): weights that differ
    # WITHIN a production pair time each nonzero-weight op on its own
    # input pencil, so on an asymmetric cost structure the weight vector
    # changes the winner: with op X2Y fast on pdims (2,4) and op Y2X fast
    # on (4,2), weights (1,0,0,0) and (0,0,0,1) must pick different grids.
    from cudecomp_tpu import performance as perf

    built = []

    class FakeScannedTimer:
        def __init__(self, fn, x, iters):
            built.append(1)
            pr = dict(x.sharding.mesh.shape)["pr"]
            pencil = tuple(x.sharding.spec).index(None)
            if pencil == 0:      # x-pencil input -> op 0 (X2Y)
                self._t = 0.1 if pr == 2 else 0.3
            else:                # y-pencil input -> op 3 (Y2X)
                self._t = 0.3 if pr == 2 else 0.1

        def time(self, n_warmup, n_trials):
            return [self._t] * max(n_trials, 1)

    monkeypatch.setattr(perf, "ScannedTimer", FakeScannedTimer)

    def winner(weights):
        built.clear()
        opts = cd.AutotuneOptions(
            n_warmup=1, n_trials=1, transpose_op_weights=weights,
            autotune_transpose_method=False,
            pr_range=(2, 4), pc_range=(2, 4))
        res = autotune(cd.GridConfig(gdims=(16, 16, 16), pdims=(0, 0)),
                       options=opts)
        # zero-weight ops are never compiled: ONE timer per candidate grid
        assert len(built) == 2
        return res.best_pdims, res.best_time_s

    p_fwd, t_fwd = winner((1.0, 0.0, 0.0, 0.0))
    p_bwd, t_bwd = winner((0.0, 0.0, 0.0, 1.0))
    assert p_fwd == (2, 4) and p_bwd == (4, 2)
    assert abs(t_fwd - 0.1) < 1e-9 and abs(t_bwd - 0.1) < 1e-9


def test_per_op_weights_exact_sum(monkeypatch):
    # within-pair-differing weights score the true sum(w_i * t_i) over all
    # four ops (not a pair mean): fake per-build-order times 0.1/0.2/0.3/0.4
    # with weights (8,4,2,1) -> 8*.1+4*.2+2*.3+1*.4 = 2.6
    from cudecomp_tpu import performance as perf

    built = []

    class FakeScannedTimer:
        def __init__(self, fn, x, iters):
            built.append(1)
            self._t = 0.1 * len(built)

        def time(self, n_warmup, n_trials):
            return [self._t] * max(n_trials, 1)

    monkeypatch.setattr(perf, "ScannedTimer", FakeScannedTimer)
    from cudecomp_tpu.autotune import _time_roundtrip
    cfg = cd.GridConfig(gdims=(16, 16, 16), pdims=(2, 4))
    grid = cd.make_grid(cfg, devices=jax.devices()[:8])
    times, skipped = _time_roundtrip(grid, jnp.float32, (8.0, 4.0, 2.0, 1.0),
                                     n_warmup=1, n_trials=2,
                                     skip_after_first_above=None)
    assert not skipped and len(built) == 4
    assert all(abs(t - 2.6) < 1e-9 for t in times)


def test_trial_op_payload_validation():
    with pytest.raises(ValueError, match="4 per-op"):
        cd.AutotuneOptions(transpose_input_halo_extents=((1, 1, 1),))


def test_trial_op_payload_padding_and_chain_validation():
    # review fix: padded trial payloads must work (buffer shape includes
    # input padding), and a non-chaining payload set raises a clear error
    # up front instead of skipping every candidate
    he = ((1, 1, 1),) * 4
    pads = ((1, 0, 0),) * 4
    opts = cd.AutotuneOptions(n_warmup=1, n_trials=1,
                              transpose_input_halo_extents=he,
                              transpose_output_halo_extents=he,
                              transpose_input_padding=pads,
                              transpose_output_padding=pads)
    cfg = cd.GridConfig(gdims=(16, 16, 16), pdims=(0, 0))
    res = autotune(cfg, options=opts)
    assert res.best_time_s > 0

    bad = cd.AutotuneOptions(n_warmup=1, n_trials=1,
                             transpose_input_halo_extents=((1, 1, 1),) * 4)
    with pytest.raises(ValueError, match="do not chain"):
        autotune(cfg, options=bad)


def test_grid_mode_halo_respects_fixed_method():
    # review fix: with autotune_halo_method=False the halo-driven grid
    # sweep must use (and keep) the explicitly configured halo method
    opts = cd.AutotuneOptions(n_warmup=1, n_trials=1, grid_mode="halo",
                              halo_extents=(1, 1, 1))
    cfg = cd.GridConfig(gdims=(16, 16, 16), pdims=(0, 0),
                        halo_method=HaloMethod.PPERMUTE)
    res = autotune(cfg, options=opts)
    assert res.grid.config.halo_method == HaloMethod.PPERMUTE
    assert {t.method for t in res.halo_trials} == {"ppermute"}


def test_payload_options_validation_message():
    # review fix: a single triple reports the helpful 4-per-op error, not
    # a TypeError from element conversion
    with pytest.raises(ValueError, match="4 per-op"):
        cd.AutotuneOptions(transpose_input_halo_extents=(1, 1, 1))


def test_halo_padding_payload():
    # cudecomp.h:218 parity: halo autotuning trials carry the padding
    # payload the application will use
    cfg = GridConfig(gdims=(16, 16, 16), pdims=(2, 2))
    opts = AutotuneOptions(n_warmup=0, n_trials=1,
                           autotune_halo_method=True,
                           halo_extents=(1, 1, 1),
                           halo_padding=(0, 1, 0))
    result = autotune(cfg, devices=jax.devices()[:4], options=opts)
    assert result.best_halo_method is not None
    with pytest.raises(ValueError):
        AutotuneOptions(halo_padding=(1, 2))
