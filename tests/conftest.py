"""Test configuration: run the suite on a virtual 8-device CPU mesh in f64.

Regression parity against the reference golden files requires float64; the
GPU is exercised by chip_smoke.py and by the tests marked ``gpu``, which run
on the card with ``MPP_TEST_DEVICE=gpu python -m pytest -m gpu tests/``.
Multi-chip sharding tests use the 8 virtual CPU devices
(xla_force_host_platform_device_count).
"""
import os
import sys

if os.environ.get("MPP_TEST_DEVICE") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Make the repo root importable regardless of pytest invocation directory.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_ROOT = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_ROOT)
