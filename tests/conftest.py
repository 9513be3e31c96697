"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding tests need multiple devices; parity math is platform-independent.
JAX_PLATFORMS defaults to cpu here; tests marked ``gpu`` run only where
the first device is a GPU (e.g. ``JAX_PLATFORMS=cuda python -m pytest -m
gpu tests/test_chip_smoke.py``) and skip elsewhere. ``python chip_smoke.py``
runs the same content on the card.
"""
import os
import resource

# The XLA CPU compiler's recursive passes can overflow the default 8 MB
# main-thread stack when compiling the largest fused programs (the
# shard_map'd rollout scan) late in a long single-process suite —
# observed as a deterministic SIGSEGV/SIGABRT inside
# backend_compile_and_load. Linux grows the main stack on demand up to
# RLIMIT_STACK, so raising the soft limit to the hard limit prevents it.
try:
    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    resource.setrlimit(resource.RLIMIT_STACK, (_hard, _hard))
except (ValueError, OSError):
    pass

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(__file__), "..", ".jax_cache"))

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
# effective even when jax was imported before the variable was set
jax.config.update(
    "jax_compilation_cache_dir",
    os.environ["JAX_COMPILATION_CACHE_DIR"])


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running parity replays")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped where JAX has none")


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's first device is a GPU
    (decided per test, never at import or collection time)."""
    if request.node.get_closest_marker("gpu") is not None:
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_cpu_client_state():
    """Drop compiled executables between test MODULES.

    A single long pytest process accumulates hundreds of XLA CPU
    executables; past a threshold the CPU client's compiler begins to
    SIGSEGV/SIGABRT on otherwise-fine programs (observed twice at
    different, individually-green compile sites; every module passes in
    its own process). Clearing JAX's in-memory caches per module bounds
    that state — recompiles across modules come from the on-disk
    compilation cache, so the cost is seconds."""
    yield
    import jax

    jax.clear_caches()
    # module-level caches holding compiled programs
    from eldorado_tpu import vec as _vec
    from eldorado_tpu.parallel import runner as _runner
    _vec._KERNEL_CACHE.clear()
    _runner._sharded_kernel_programs.cache_clear()
    _runner._build_rollout.cache_clear()
    _runner._build_sample.cache_clear()
    _runner._build_step.cache_clear()


def pytest_collection_modifyitems(config, items):
    if config.getoption("-m", default=""):
        return
    import pytest
    skip = pytest.mark.skip(reason="slow: run with -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
