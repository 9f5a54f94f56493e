"""Sweep runner — YAML-configured cartesian sweeps with CSV capture.

Analog of the reference's ``tests/test_runner.py`` (214 LoC) and
``benchmark/benchmark_runner.py`` (222 LoC): reads a YAML config describing a
cartesian product of (grid sizes x pdims x methods x layouts x dtypes x
halo/padding variants), runs each case (correctness check and/or timing)
in-process on the available devices, and writes one CSV row per case,
including autotuner trial dumps when requested.

Usage:
    python benchmarks/run_sweep.py benchmarks/sweep_config.yaml [-o out.csv]

Correctness oracle: the global-linear-index field (the reference suite's
``initializePencil`` pattern) through the full transpose round trip.
"""

from __future__ import annotations

import argparse
import csv
import itertools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import yaml


def parse_case_matrix(cfg):
    keys = ["gdims", "pdims", "method", "dtype", "axis_contiguous",
            "halo_extents", "padding"]
    lists = {k: cfg.get(k, [None]) for k in keys}
    for combo in itertools.product(*(lists[k] for k in keys)):
        yield dict(zip(keys, combo))


def run_case(case, n_warmup, n_trials, check, iters=8):
    import jax
    import cudecomp_tpu as cd
    from cudecomp_tpu.utils import testing as T

    gdims = tuple(case["gdims"])
    pdims = tuple(case["pdims"]) if case["pdims"] else (0, 0)
    kw = {}
    if case["axis_contiguous"]:
        kw["transpose_axis_contiguous"] = (True, True, True)
    if case["method"]:
        kw["transpose_method"] = case["method"]
    cfg = cd.GridConfig(gdims=gdims, pdims=pdims, **kw)
    opts = cd.AutotuneOptions(n_warmup=1, n_trials=2)
    grid = cd.make_grid(cfg, autotune_options=opts if pdims == (0, 0) else None)

    dtype = np.dtype(case["dtype"] or "float32")
    he = tuple(case["halo_extents"] or (0, 0, 0))
    pad = tuple(case["padding"] or (0, 0, 0))

    row = dict(gdims="x".join(map(str, gdims)), pdims=f"{grid.pdims}",
               method=grid.config.transpose_method.value, dtype=str(dtype),
               axis_contiguous=bool(case["axis_contiguous"]),
               halo_extents="x".join(map(str, he)),
               padding="x".join(map(str, pad)), status="ok", error="",
               roundtrip_ms="", a2a_ms="", local_ms="", timing="")

    x_global = T.global_index_field(gdims, dtype=dtype)
    buf = cd.scatter_global(grid, x_global, 0, halo_extents=he, padding=pad)

    def roundtrip(b):
        y = cd.transpose_x_to_y(grid, b, input_halo_extents=he,
                                input_padding=pad)
        z = cd.transpose_y_to_z(grid, y)
        y2 = cd.transpose_z_to_y(grid, z)
        return cd.transpose_y_to_x(grid, y2, output_halo_extents=he,
                                   output_padding=pad)

    if check:
        out = jax.jit(roundtrip)(buf)
        got = cd.gather_global(grid, out, 0, halo_extents=he, padding=pad)
        if not np.allclose(got, x_global):
            row["status"] = "FAIL"
            row["error"] = "roundtrip mismatch"
            return row

    # forced-completion timing: no-halo cases go through segment_roundtrip
    # (per-op scans on one chip, where a chained round trip folds to the
    # identity; chained scan + exchange-only segmentation on meshes); cases
    # with halos/padding use the scanned chained round trip directly
    from cudecomp_tpu import performance as perf
    if he == (0, 0, 0) and pad == (0, 0, 0):
        seg = perf.segment_roundtrip(
            grid, dtype, iters=iters, n_warmup=n_warmup, n_trials=n_trials,
            record=False)
        row["roundtrip_ms"] = f"{seg['total_ms']:.4f}"
        row["a2a_ms"] = f"{seg['a2a_ms']:.4f}"
        row["local_ms"] = f"{seg['local_ms']:.4f}"
        row["timing"] = "segment"
    else:
        ts = perf.time_scanned(roundtrip, buf, iters=iters,
                               n_warmup=n_warmup, n_trials=n_trials)
        row["roundtrip_ms"] = f"{1e3 * min(ts):.4f}"
        row["timing"] = "scanned_chain"
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("-o", "--output", default="sweep_results.csv")
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU with 8 virtual devices")
    args = ap.parse_args()

    if args.cpu:
        # APPEND to any existing XLA_FLAGS: setdefault would silently
        # drop the 8-virtual-device flag and every multi-device case
        # would error on the 1-device cpu platform
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        print(f"error: empty or non-mapping config {args.config}",
              file=sys.stderr)
        return 2

    n_warmup = cfg.get("n_warmup", 2)
    n_trials = cfg.get("n_trials", 5)
    check = cfg.get("check_correctness", True)
    iters = cfg.get("iters", 8)

    rows = []
    for case in parse_case_matrix(cfg):
        try:
            row = run_case(case, n_warmup, n_trials, check, iters)
        except Exception as e:  # record and continue, like test_runner.py
            row = dict(gdims="x".join(map(str, case["gdims"])),
                       pdims=str(case["pdims"]), method=str(case["method"]),
                       dtype=str(case["dtype"]),
                       axis_contiguous=bool(case["axis_contiguous"]),
                       halo_extents=str(case["halo_extents"]),
                       padding=str(case["padding"]),
                       status="ERROR", error=str(e)[:200], roundtrip_ms="",
                       a2a_ms="", local_ms="", timing="")
        print(f"{row['gdims']:>12s} pdims={row['pdims']:8s} "
              f"{row['method']:12s} {row['dtype']:10s} -> {row['status']} "
              f"{row['roundtrip_ms']}", flush=True)
        rows.append(row)

    if not rows:
        print("error: config produced zero cases (empty matrix key?)",
              file=sys.stderr)
        return 2
    with open(args.output, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    n_bad = sum(r["status"] != "ok" for r in rows)
    print(f"\n{len(rows)} cases, {n_bad} failures -> {args.output}")
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
