"""Taylor-Green validation against the reference's literature data.

Runs the spectral TG solver at Re=1600 (the reference configuration,
examples/cc/taylor_green/README.md:8-21) on one device, samples kinetic
energy / enstrophy every 0.1 flow-time units (the cadence of the
reference's own output, data/tg_n512_output.txt), writes the curves to
CSV, and quantifies the deviation against:

  * van Rees et al. 512^3 spectral reference data
    (data/spectral_Re1600_512.gdiag: t, E, -dE/dt, enstrophy), and
  * the reference solver's own 512^3 run (flow time / ke / enstrophy
    lines in data/tg_n512_output.txt),

with the resolution-mismatch caveat: this run is at N^3 (64/128/256), so
deviations near the dissipation peak (t ~ 9) measure RESOLUTION, not
solver correctness — the same N-dependence the van Rees paper shows.

    TG_REFERENCE_DATA=<cuDecomp checkout>/examples/cc/taylor_green/data \
        python scripts/validate_tg.py [N] [t_end]

The reference data files ship with NVIDIA/cuDecomp, not with this repo.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

REF_DATA = os.environ.get("TG_REFERENCE_DATA", "")


def load_gdiag(path=os.path.join(REF_DATA, "spectral_Re1600_512.gdiag")):
    """van Rees spectral data: t, energy, dissipation (-dE/dt), enstrophy."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            rows.append([float(v) for v in line.split()])
    a = np.asarray(rows)
    return a[:, 0], a[:, 1], a[:, 2], a[:, 3]


def load_ref_run(path=os.path.join(REF_DATA, "tg_n512_output.txt")):
    """Reference solver's own 512^3 curves: flow time, ke, enstrophy."""
    ts, kes, zs = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("flow time:"):
                parts = line.split()
                ts.append(float(parts[2]))
                kes.append(float(parts[4]))
                zs.append(float(parts[6]))
    return np.asarray(ts), np.asarray(kes), np.asarray(zs)


def main(N=128, t_end=20.0, sample_dt=0.1, out_csv=None):
    import cudecomp_tpu as cd
    from cudecomp_tpu.config import GridConfig
    from cudecomp_tpu.models.taylor_green import TaylorGreenSolver

    re = 1600.0
    # reference runs dt = 1e-3 at 512^3 (20000 steps / 20 flow time,
    # README.md:13); scale with the grid spacing (CFL-equivalent)
    dt = 1e-3 * 512.0 / N
    n_sub = max(1, round(sample_dt / dt))
    dt = sample_dt / n_sub

    cfg = GridConfig(gdims=(N, N, N), pdims=(1, 1))
    grid = cd.make_grid(cfg, devices=jax.devices()[:1])
    solver = TaylorGreenSolver(grid=grid, nu=1.0 / re)
    uh, f = solver.setup()

    @jax.jit
    def advance(s):
        def body(c, _):
            return solver.step(c, f, dt), ()
        out, _ = lax.scan(body, s, None, length=n_sub)
        return out, solver.energy(out, f), solver.enstrophy(out, f)

    @jax.jit
    def diag(s):
        return solver.energy(s, f), solver.enstrophy(s, f)

    ke0, z0 = (float(v) for v in diag(uh))
    rows = [(0.0, ke0, z0)]
    print(f"N={N} Re={re:.0f} dt={dt:.2e} ({n_sub} steps / {sample_dt} "
          f"flow time)", flush=True)
    print(f"t=0.00 ke={ke0:.8f} enstrophy={z0:.8f}", flush=True)
    t0 = time.perf_counter()
    n_samples = int(round(t_end / sample_dt))
    for i in range(1, n_samples + 1):
        uh, ke, z = advance(uh)
        ke, z = float(ke), float(z)
        t = i * sample_dt
        rows.append((t, ke, z))
        if i % 10 == 0:
            el = time.perf_counter() - t0
            print(f"t={t:5.2f} ke={ke:.8f} enstrophy={z:.8f} "
                  f"[{el:6.1f}s wall]", flush=True)

    a = np.asarray(rows)
    nu = 1.0 / re
    diss = 2.0 * nu * a[:, 2]

    out_csv = out_csv or f"docs/tg_validation_n{N}.csv"
    with open(out_csv, "w") as fo:
        fo.write("t,kinetic_energy,enstrophy,dissipation\n")
        for (t, ke, z), d in zip(rows, diss):
            fo.write(f"{t},{ke},{z},{d}\n")
    print(f"wrote {out_csv}", flush=True)

    # ---- deviation vs van Rees spectral 512^3 -----------------------------
    tg, Eg, Dg, Zg = load_gdiag()
    ke_ref = np.interp(a[:, 0], tg, Eg)
    d_ref = np.interp(a[:, 0], tg, Dg)
    for name, ours, ref in (("kinetic energy", a[:, 1], ke_ref),
                            ("dissipation", diss, d_ref)):
        for lo, hi in ((0.0, 5.0), (0.0, 10.0), (0.0, t_end)):
            m = (a[:, 0] >= lo) & (a[:, 0] <= hi)
            dev = np.abs(ours[m] - ref[m])
            rel = dev / np.maximum(np.abs(ref[m]), 1e-12)
            print(f"vs van Rees 512^3 | {name:15s} t in [{lo:4.1f},{hi:4.1f}]"
                  f": max abs {dev.max():.3e}  max rel {rel.max():.3%}",
                  flush=True)

    # ---- deviation vs the reference solver's own 512^3 run ---------------
    tr, ker, zr = load_ref_run()
    if len(tr):
        m = a[:, 0] <= tr.max()
        ke_r = np.interp(a[m, 0], tr, ker)
        z_r = np.interp(a[m, 0], tr, zr)
        dev_ke = np.abs(a[m, 1] - ke_r).max()
        dev_z = np.abs(a[m, 2] - z_r).max()
        print(f"vs reference tg 512^3 | max abs dev: ke {dev_ke:.3e}  "
              f"enstrophy {dev_z:.3e}", flush=True)

    # ---- comparison plot (tg_results_comparison.png analog) ---------------
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axs = plt.subplots(1, 2, figsize=(11, 4))
        axs[0].plot(tg, Eg, "k-", lw=1.2,
                    label="van Rees et al. 512$^3$ spectral")
        axs[0].plot(a[:, 0], a[:, 1], "r--", lw=1.2,
                    label=f"cudecomp_tpu {N}$^3$")
        axs[0].set_xlabel("flow time")
        axs[0].set_ylabel("kinetic energy")
        axs[0].legend()
        axs[1].plot(tg, Dg, "k-", lw=1.2,
                    label="van Rees et al. 512$^3$ spectral")
        axs[1].plot(a[:, 0], diss, "r--", lw=1.2,
                    label=f"cudecomp_tpu {N}$^3$ (2$\\nu$ enstrophy)")
        axs[1].set_xlabel("flow time")
        axs[1].set_ylabel("dissipation rate")
        axs[1].legend()
        fig.suptitle(f"Taylor-Green Re=1600: cudecomp_tpu {N}^3 vs "
                     f"published reference")
        fig.tight_layout()
        png = f"docs/tg_validation_n{N}.png"
        fig.savefig(png, dpi=120)
        print(f"wrote {png}", flush=True)
    except ImportError:
        pass


if __name__ == "__main__":
    kw = {}
    if len(sys.argv) > 1:
        kw["N"] = int(sys.argv[1])
    if len(sys.argv) > 2:
        kw["t_end"] = float(sys.argv[2])
    main(**kw)
