"""Persistent XLA compilation cache at a fixed path.

The directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is set, used
exactly as given; otherwise ``<checkout>/.jax_cache/``.  The path is part
of the cache key, so it must not move between runs.

Without the environment variable, the CPU backend's artifacts go in a
per-host subdirectory keyed by a digest of the CPU model and feature
flags: XLA:CPU compiles ahead of time for the build host's features, and
loading those executables on a host that lacks them logs "could lead to
execution errors such as SIGILL" and can crash.
"""

from __future__ import annotations

import hashlib
import os
import platform

#: default cache root: ``.jax_cache`` at the top of the checkout
#: (listed in .gitignore)
CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def _host_fingerprint() -> str:
    """Short digest of the CPU identity (machine arch + model + flags)."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    parts.append(line.strip())
                    if len(parts) >= 3:
                        break
    except OSError:
        parts.append(platform.processor() or "unknown")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:10]


def cache_dir(fingerprint: bool) -> str:
    """The cache directory this process uses (see the module doc)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if fingerprint:
        return os.path.join(CACHE_ROOT, f"cpu-{_host_fingerprint()}")
    return CACHE_ROOT


def enable_compile_cache(
    min_compile_secs: float = 1.0, fingerprint: bool | None = None
) -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`.

    ``fingerprint=None`` (auto) keys the directory by host only when the
    default backend is the CPU; GPU executables do not depend on the host
    CPU.  Auto mode initializes the JAX backend; pass an explicit bool to
    avoid that.  Returns the directory.
    """
    import jax

    if fingerprint is None:
        fingerprint = jax.default_backend() == "cpu"
    d = cache_dir(fingerprint)
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return d
