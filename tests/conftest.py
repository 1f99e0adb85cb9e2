"""Test harness configuration.

Unit tests run on the host CPU (`JAX_PLATFORMS=cpu`) with a virtual 8-device
mesh (the analogue of the reference's oversubscribed `mpirun -np N` CI runs,
SURVEY.md §4) and float64 enabled (the reference is double everywhere).
Tests that need a GPU carry the `gpu` marker and skip here; `chip_smoke.py`
is the end-to-end run on the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the test suite re-jits the same kernels in
# every pytest process; caching compilations cuts suite wall-clock a lot.
# The directory is keyed by the HOST CPU's feature set: XLA:CPU caches AOT
# machine code, and loading artifacts compiled on a different machine type
# (this environment migrates across VMs between sessions) can SIGILL or
# SIGSEGV mid-suite (observed 2026-08-19: stale +amx artifacts crashed
# test_fused_nk_sharded with exit 139).
def _cpu_fingerprint():
    import hashlib
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha1(
                        " ".join(sorted(line.split()[2:])).encode()
                    ).hexdigest()[:12]
    except OSError:
        pass
    import platform
    return platform.machine()


# JAX_COMPILATION_CACHE_DIR, when set, is the only cache directory used;
# otherwise the suite keeps its CPU-fingerprinted one.
from paropt_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

try:
    enable_compilation_cache(
        fallback=os.path.join(os.path.dirname(__file__),
                              ".jax_cache-" + _cpu_fingerprint()))
    # cache every program, however quick to compile
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
except Exception:
    pass


# The suite compiles hundreds of XLA:CPU executables in ONE process; each
# maps its code sections, and the process hits vm.max_map_count (65530
# default) late in a cold-cache run — LLVM then aborts with "Cannot
# allocate memory" at ~5 GB RSS on a 125 GB box (observed 2026-08-19,
# exits 134/139 in test_sharding). Two mitigations: raise the knob when
# permitted, and drop compiled executables between test MODULES (the
# persistent cache makes any reload cheap).
try:
    with open("/proc/sys/vm/max_map_count", "w") as f:
        f.write("1048576")
except OSError:
    pass


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_executables_per_module():
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU JAX sees; skips the test when there is none.  Decided
    here, at run time, never while test modules are imported."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU (run chip_smoke.py on the card)")
    return gpus[0]
