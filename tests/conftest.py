"""Test configuration.

By default the tests run on the host CPU, split into 8 virtual devices so
that the sharded paths run too (see dryrun_multichip in __graft_entry__.py).
Tests marked `gpu` need the card and skip there; chip_smoke.py runs them on
the GPU it holds by setting GEOFLOW_CARD_TESTS=1 before it calls pytest in
its own process, and then the platform is left as it is.
"""
import os

import pytest

ON_CARD = os.environ.get("GEOFLOW_CARD_TESTS") == "1"

# Must be set before jax is imported anywhere. Overwrite, don't setdefault:
# the tests must not take a card that a benchmark may hold.
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

from geoflowslam.utils.compile_log import enable_persistent_cache  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)
# CPU compiles of the larger programs take tens of seconds; keep them
enable_persistent_cache(min_compile_secs=1.0)


@pytest.fixture
def card():
    """The GPU under test; `gpu`-marked tests skip without one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    return dev


@pytest.fixture
def host():
    """The host CPU backend, where the plain reference runs."""
    return jax.devices("cpu")[0]
