"""Test configuration: force an 8-device virtual CPU mesh before jax import.

Multi-chip sharding tests run on host-platform virtual devices
(``--xla_force_host_platform_device_count=8``), per SURVEY.md §4's
"same loss on 1 vs N devices" strategy.
"""

import os

# CPU unless the caller names a platform (``JAX_PLATFORMS=cuda pytest -m
# gpu`` runs the card-only tests on a GPU machine)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402  (import after env setup)
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)
# reduced-precision matmul defaults (TF32 on GPUs) would mask precision
# bugs in invertibility tests; pin to full f32.
jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture
def gpu():
    """Skip unless JAX finds a GPU. Decided inside the fixture, never at
    import time: pytest-xdist workers must all collect the same tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this on the card")
