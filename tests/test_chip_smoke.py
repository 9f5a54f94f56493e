"""chip_smoke.py's phases at 16^3-32^3 on the virtual CPU mesh, each
against its own plain reference, and the script's refusal to report
success without a GPU.  The full-size phases run on GPUs only, through
``python chip_smoke.py`` (one card) and ``python chip_smoke.py --four``."""

import json

import numpy as np
import pytest
import jax

import chip_smoke as cs
from cudecomp_tpu.config import TransposeMethod

A2A = TransposeMethod.ALL_TO_ALL


def _ok(rec):
    assert rec["ok"], json.dumps(rec)
    assert rec["checks"] and all(c["err"] <= c["tol"] for c in rec["checks"])
    return rec


def _one():
    return jax.devices()[:1]


def _four():
    return jax.devices()[:4]


@pytest.mark.parametrize("ac", [False, True])
def test_phase_c2c(ac):
    rec = _ok(cs.phase_c2c(n=16, n_ref=16, ac=ac, devices=_one()))
    assert len(rec["checks"]) == 2
    assert rec["compile_s"] >= 0 and rec["peak_gib"] is not None


def test_phase_c2c_complex128():
    rec = _ok(cs.phase_c2c(n=16, n_ref=0, dtype=np.complex128, tol=1e-10,
                           devices=_one()))
    assert rec["checks"][0]["tol"] == 1e-10


def test_phase_r2c():
    _ok(cs.phase_r2c(n=16, n_ref=16, devices=_one()))


@pytest.mark.parametrize("ac", [False, True])
def test_phase_transpose(ac):
    rec = _ok(cs.phase_transpose(n=16, n_ref=16, ac=ac, devices=_one()))
    assert [c["err"] for c in rec["checks"]] == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("pdims", [(1, 1), (2, 2)])
def test_phase_halo_stencil(pdims):
    rec = _ok(cs.phase_halo_stencil(n=16, pdims=pdims,
                                    devices=jax.devices()))
    assert rec["placed_on_all_devices"]


def test_phase_poisson():
    rec = _ok(cs.phase_poisson(n=16, devices=_one()))
    assert rec["checks"][1]["iters"] > 0


def test_phase_taylor_green():
    _ok(cs.phase_taylor_green(n=16, devices=_one()))


@pytest.mark.parametrize("pdims,method", [
    ((1, 4), A2A), ((2, 2), A2A), ((4, 1), A2A),
    ((2, 2), TransposeMethod.RING), ((2, 2), TransposeMethod.RING_PIPELINED)])
def test_phase_four_c2c(pdims, method):
    rec = _ok(cs.phase_four_c2c(gdims=(32, 32, 16), pdims=pdims,
                                method=method, devices=_four()))
    assert rec["placed_on_all_devices"]


@pytest.mark.parametrize("pdims", [(1, 4), (2, 2), (4, 1)])
def test_phase_four_forward_vs_one(pdims):
    rec = _ok(cs.phase_four_forward_vs_one(n=16, pdims=pdims,
                                           devices=_four()))
    assert rec["placed_on_all_devices"]


@pytest.mark.parametrize("pdims", [(1, 4), (2, 2), (4, 1)])
def test_phase_four_transpose(pdims):
    rec = _ok(cs.phase_four_transpose(gdims=(32, 32, 16), pdims=pdims,
                                      devices=_four()))
    assert rec["placed_on_all_devices"]


@pytest.mark.parametrize("pdims", [(1, 4), (2, 2), (4, 1)])
def test_phase_four_uneven(pdims):
    rec = _ok(cs.phase_four_uneven(gdims=(9, 10, 11), pdims=pdims,
                                   devices=_four()))
    assert rec["placed_on_all_devices"]


def test_phase_failure_is_reported():
    # a check above its tolerance fails the phase (and so the run)
    rec = cs.phase_c2c(n=16, n_ref=0, tol=-1.0, devices=_one())
    assert not rec["ok"] and not rec["checks"][0]["ok"]


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_without_gpu(argv, capsys):
    # on the CPU the script exits non-zero and never reports success
    rc = cs.main(argv)
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok": true' not in out


@pytest.fixture
def gpu_host():
    """Skip unless this host has an NVIDIA GPU.  This process is held to
    the CPU mesh, so the card is driven by a child process."""
    import shutil
    import subprocess
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True
                                     ).returncode != 0:
        pytest.skip("no NVIDIA GPU on this host (chip_smoke.py runs there)")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_host):
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                         env=env, capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-4000:]
    last = json.loads(run.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
