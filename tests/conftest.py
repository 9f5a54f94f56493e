"""Test configuration: 8 CPU-emulated devices, float64 enabled.

The multi-device analog of the reference's 4-rank MPI test harness
(``tests/ctest/CMakeLists.txt:102-115``): all collective paths run on a
virtual CPU mesh; the same code runs unchanged on GPU meshes.  Tests
that need a GPU carry the ``gpu`` marker and skip here.

Note: jax may already be imported (pytest plugins) and JAX_PLATFORMS may
point at a real accelerator, so we force the platform via jax.config (works
any time before backend initialization) rather than env vars alone.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert len(jax.devices()) == 8, (
    "tests require 8 CPU-emulated devices; backend was initialized too early: "
    f"{jax.devices()}")
