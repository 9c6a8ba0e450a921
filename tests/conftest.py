import os
import sys

# the suite runs device fidelities on the CPU mesh by design: silence the
# CLI's cpu-backend performance warning (it would pollute stderr-parsed
# reports); a dedicated test re-enables it to assert it fires
os.environ.setdefault("PHENIQS_QUIET_CPU_DEVICE", "1")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

REFERENCE = "/root/reference"


@pytest.fixture(scope="session")
def reference_root():
    if not os.path.isdir(REFERENCE):
        pytest.skip("reference repository not mounted")
    return REFERENCE


@pytest.fixture(scope="session")
def bdggg(reference_root):
    return os.path.join(reference_root, "test", "BDGGG")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips elsewhere."
        " Run on the card with: python -m pytest -m gpu tests/",
    )
    if config.getoption("markexpr") == "gpu":
        return  # the card-only selection runs on JAX's default backend
    # everything else runs on a virtual 8-device CPU mesh (the sharding
    # tests need the devices). Backends initialize lazily, so this takes
    # effect as long as it runs before the first jax.devices()/jit.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (for tests marked ``gpu``)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: python -m pytest -m gpu tests/")
