"""Test harness config: CPU backend with 8 virtual devices + persistent
compile cache (utils/cache.py: JAX_COMPILATION_CACHE_DIR, else
<repo>/.jax_cache).

Must run before any jax import (pytest loads conftest first; test modules
import miniwfa_tpu/jax lazily inside their own module scope).
"""

import os

# the suite runs on the CPU backend with 8 virtual devices; tests marked
# `gpu` need a card and skip there (run them with JAX_PLATFORMS=cuda)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from miniwfa_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import json  # noqa: E402
import pytest  # noqa: E402

_GOLDENS = None


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on the CPU backend")


@pytest.fixture()
def gpu():
    """Skip unless JAX sees a GPU.  Decided here, at run time, never at
    import or collection time: every xdist worker must collect the same
    tests."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (JAX finds none)")
    return devs


@pytest.fixture(scope="session")
def goldens():
    global _GOLDENS
    if _GOLDENS is None:
        path = os.path.join(os.path.dirname(__file__), "data", "goldens.json")
        with open(path) as f:
            _GOLDENS = json.load(f)
    return _GOLDENS
