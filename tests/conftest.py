import os
import pathlib

# Tests run on a virtual 8-device CPU mesh so multi-device sharding
# logic is exercised without accelerators. Must be set before importing
# jax.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return DATA


@pytest.fixture(scope="session")
def golden_dir() -> pathlib.Path:
    return DATA / "golden"
