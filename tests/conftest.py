"""Test configuration: force an 8-virtual-device CPU mesh.

Tests run on CPU (full-precision f64, deterministic) with 8 virtual devices so
multi-device sharding paths compile and execute without accelerator
hardware.  Tests marked ``gpu`` run their work in a child process on the
card and skip where JAX finds none (the ``gpu_env`` fixture); chip_smoke.py
drives the GPU path end to end.

Must run before any jax client initialization: pytest imports conftest first,
and the flags below are applied before the backend is instantiated.
"""

import os
import subprocess
import sys

import pytest

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
# hermetic suite: no opportunistic catalog/ephemeris downloads mid-test
os.environ.setdefault("OUTFIT_NO_DOWNLOAD", "1")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite is compile-heavy (~190 jitted
# kernels).  CPU artifacts are keyed by a host-CPU fingerprint: another
# machine's XLA:CPU AOT artifacts can SIGILL this one (utils/compile_cache.py).
from outfit_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=0.5)
try:
    # the default policy caches accelerator backends only; tests run on CPU
    jax.config.update(
        "jax_persistent_cache_enable_xla_caches", "xla_gpu_per_fusion_autotune_cache_dir"
    )
except Exception:
    pass


# --- memory-mapping guard -----------------------------------------------
# Every live XLA:CPU executable holds dozens of memory mappings (JIT code
# pages).  The suite compiles/deserializes hundreds of 8-device executables,
# and the process crosses the kernel's vm.max_map_count (default 65530)
# about 70% of the way through — at which point an mmap failure inside
# executable deserialization segfaults/aborts the whole run (observed as
# deterministic rc=139/rc=134 at the same test).  Dropping compiled
# executables bounds the live set; the persistent compile cache makes the
# subsequent reloads cheap.

from outfit_tpu.utils.runtime import clear_executables_if_crowded  # noqa: E402


def pytest_runtest_teardown(item, nextitem):
    clear_executables_if_crowded()


@pytest.fixture(scope="session")
def gpu_env():
    """Environment for a child process that runs on the GPU.  Skips the
    test when JAX in such a child finds no GPU.  Decided here, when a test
    asks for it, and never while test modules are imported: workers that
    collected different tests would make pytest-xdist run none."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    p = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    if p.returncode != 0 or p.stdout.strip() != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    return env
