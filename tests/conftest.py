"""Test env: force an 8-device virtual CPU mesh before JAX initializes.

Multi-chip sharding tests run on `--xla_force_host_platform_device_count=8`
CPU devices (the fake-backend capability the reference lacks, SURVEY.md §4).
Pallas kernels run here in interpret mode (passed explicitly), and their
GPU lowering is checked with `lower(lowering_platforms=("cuda",))`, which
needs no card. Tests that need a card carry the `gpu` marker and take the
`gpu` fixture, which skips them where JAX has no GPU.
"""

import os

# CPU unless the caller lists platforms itself: on a GPU machine,
# `JAX_PLATFORMS=cpu,cuda python -m pytest tests -m gpu` keeps the CPU
# default (and its 8-device mesh) and lets the `gpu` fixture find the card
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count=8" not in flags:
    # strip any OTHER preset count (e.g. =2 left over from a
    # jax.distributed debug session) — the suite NEEDS 8 devices
    flags = " ".join(t for t in flags.split()
                     if "host_platform_device_count" not in t)
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent compilation cache (the integrator jits are expensive on CPU):
# JAX_COMPILATION_CACHE_DIR if set, else <checkout>/.jax_cache
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2")

import jax  # noqa: E402
import pytest  # noqa: E402

from raytracing_rust_tpu.backend import init_compile_cache  # noqa: E402

init_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU (skips where JAX has none)")


@pytest.fixture
def gpu():
    """Skip unless JAX can see a GPU; decided per test, never at import."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a CUDA GPU (JAX_PLATFORMS=cpu,cuda on a card)")
    return devs[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound the live-executable count to ~one module's worth.

    The full suite accumulates hundreds of XLA:CPU executables; past a
    threshold the NEXT backend compile segfaults inside XLA (observed at
    test_sharding after ~150 tests — every sub-half of the suite passes,
    only the whole set crashes). Dropping compiled programs between
    modules keeps the process under the cliff; the persistent on-disk
    cache above makes the re-compiles cheap."""
    yield
    jax.clear_caches()
