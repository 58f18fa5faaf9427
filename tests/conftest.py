"""Test harness config: force the CPU backend with 8 virtual devices.

The suite runs on the CPU, also on a machine with a GPU: multi-device
sharding paths (pjit/shard_map over a Mesh) are exercised on a virtual
8-device CPU mesh, and Pallas kernels run in interpret mode.  Backend
selection is lazy, so overriding the config here (before any computation)
is effective.  Tests that need the card itself carry the ``gpu`` marker
and decide inside the ``gpu_device`` fixture whether one is present; the
GPU path as a whole is driven by ``python chip_smoke.py`` on the card.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# MAM3_TEST_GPU=1 (with ``-m gpu``) lets the card-only tests see the GPU
jax.config.update("jax_platforms",
                  "cuda,cpu" if os.environ.get("MAM3_TEST_GPU") else "cpu")
# NO persistent compile cache: XLA:CPU AOT serialization targets the
# *compile* machine's feature set; loading such an executable on a host
# with a narrower ISA (feature-mismatch warning at startup) segfaults in
# get_executable_and_time.  In-memory jit caching is unaffected; the
# suite just re-traces per process.


import gc  # noqa: E402

import pytest  # noqa: E402


def _rss_gb() -> float:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * 4096 / 2 ** 30
    except OSError:
        return 0.0


@pytest.fixture(scope="session")
def native_libs():
    """Build native/*.so with native/build.sh when they are missing (they
    are build outputs, not kept in git)."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    libs = [os.path.join(root, "native", n)
            for n in ("libvocab.so", "libloader.so")]
    if not all(os.path.exists(p) for p in libs):
        subprocess.run(["bash", os.path.join(root, "native", "build.sh")],
                       check=True, capture_output=True, timeout=600)


@pytest.fixture
def gpu_device():
    """The first GPU, or skip: decided here, when a test runs -- never
    while modules are imported or collected, so every worker collects the
    same tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU: MAM3_TEST_GPU=1 pytest -m gpu tests/")
    return devs[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules when memory grows.

    The suite accumulates hundreds of XLA:CPU executables across ~30
    modules; past ~90 tests the backing compiler has been seen to abort
    mid-compile (SIGABRT in backend_compile_and_load).  Dropping the jit
    caches at module boundaries once RSS passes a threshold keeps the
    process footprint bounded without re-tracing on small green runs.
    """
    yield
    if _rss_gb() > 2.0:
        gc.collect()
        jax.clear_caches()
