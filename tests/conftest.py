import os
import sys

# Tests run on a virtual 8-device CPU mesh with float64 enabled so golden
# numbers from the reference (10-digit norms) are reproducible; GPU runs use
# float32 via Config.dtype.  Tests marked ``gpu`` start their own child
# process on the card (tests/test_gpu.py).
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one (run on the "
        "card with `python -m pytest -m gpu tests/`)")
