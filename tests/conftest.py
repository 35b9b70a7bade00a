"""Test harness configuration.

Tests run on CPU (``JAX_PLATFORMS=cpu`` unless the caller sets it) with 8
virtual devices, so the multi-device sharding paths are exercised without
a GPU host (SURVEY.md section 4: multi-device tests via
xla_force_host_platform_device_count).  The XLA flag must be set before
jax is imported.  Tests marked ``gpu`` skip on the CPU; on a GPU host run
them with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pathlib

import pytest

SCENES = pathlib.Path(__file__).resolve().parent.parent / "scenes"


@pytest.fixture(scope="session")
def reference_scenes():
    """The in-tree scenes: benchmark.json is the reference's benchmark
    scene; sphere_grid.json stands in for its ~100-sphere simple.json."""
    return SCENES


@pytest.fixture
def gpu():
    """Skips the test unless JAX's first device is a GPU."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (python chip_smoke.py covers the "
                    "same checks on the card)")
