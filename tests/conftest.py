"""Test rig: virtual 8-device CPU mesh (the analogue of the reference's
mpiexec -n N single-host CI, /root/reference/test/runtests.jl:16-34) and
x64 for the reference's Float64 tolerances."""

import os

os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \
    " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Persistent XLA compile cache for the suite: the device-engine tests are
# compile-bound (level-unrolled executables), and XLA:CPU AOT results
# reload fine on the machine that compiled them (measured 37.5 -> 4.9 s on
# a device ldlt scenario; the cpu_aot_loader feature-mismatch ERROR log is
# cosmetic — the pseudo-features +prefer-no-scatter/gather never appear in
# host feature detection). Keyed per machine via the library fingerprint.
from hpclinalg.config import (  # noqa: E402
    _machine_fingerprint,
    _make_cache_writes_atomic,
    _sweep_corrupt_entries,
)

_tests_cache = f"/tmp/hpclinalg_xla_cache_tests_{_machine_fingerprint()}"
_make_cache_writes_atomic()
_sweep_corrupt_entries(_tests_cache)
jax.config.update("jax_compilation_cache_dir", _tests_cache)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import hpclinalg as hl  # noqa: E402


# Parameterized backend matrix, mirroring test/test_utils.jl:62-83
# (CPU_CONFIGS = {Float64, ComplexF64} x CPU; shard counts stand in for the
# reference's 2-process MPI runs).
CONFIGS = [
    (np.float64, 1, "f64-serial"),
    (np.float64, 4, "f64-4shards"),
    (np.complex128, 4, "c128-4shards"),
    (np.float64, 8, "f64-8shards"),
]


@pytest.fixture(params=CONFIGS, ids=[c[2] for c in CONFIGS])
def cfg(request):
    dtype, nshards, _name = request.param
    return hl.backend_auto(nshards=nshards, dtype=dtype), dtype


@pytest.fixture
def be4():
    return hl.backend_auto(nshards=4)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True)
def _cache_guard():
    """Leak guard analogue of check_cache_sizes! in the reference tests."""
    yield
    sizes = hl.cache_sizes()
    for name, nentries in sizes.items():
        assert nentries < 600, f"plan cache {name} leaked: {sizes}"


@pytest.fixture
def be8():
    return hl.backend_auto(nshards=8)
