"""Test configuration: 8 virtual CPU devices + float64.

The suite runs on the CPU: multi-device tests simulate a GPU mesh via
``xla_force_host_platform_device_count`` (SURVEY.md section 4); parity
tests against the float64 MATLAB reference require x64.  The platform is
switched via jax.config (jax may already be imported), and XLA_FLAGS is
set before the CPU backend is instantiated.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them unless JAX's first device is a GPU.  On the
card they run with

    CAL_TEST_PLATFORM=default python -m pytest tests/ -m gpu -p no:xdist

(``CAL_TEST_PLATFORM=default`` keeps JAX's own platform choice instead
of the CPU.)
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

_platform = os.environ.get("CAL_TEST_PLATFORM", "cpu")
if _platform != "default":
    jax.config.update("jax_platforms", _platform)
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first JAX device, or a skip when it is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
