"""outfit_tpu — batch-first orbit determination and propagation on JAX/XLA.

A ground-up JAX/XLA rebuild of the capabilities of the Rust crate
``FusRoman/Outfit`` (see SURVEY.md): Gauss initial
orbit determination, differential orbit correction (weighted least squares with
chi-squared outlier rejection), universal-variable two-body and DOP853 N-body
propagation with state-transition matrices, JPL ephemerides, IAU-1980 Earth
orientation, and apparent-position/ephemeris generation.

Design posture (differs radically from the reference's scalar Rust):
  * every kernel is batched (leading batch axes) and jit/vmap/pjit-ready,
  * control flow is fixed-trip masked iteration instead of early exit,
  * errors are data (status codes / NaN masks), not exceptions, inside kernels,
  * host-side Python handles parsing and I/O; device-side JAX handles math.

f64 note: the reference's numerical contracts (1e-9..1e-11 oracles) require
double precision, so importing this package enables ``jax_enable_x64``.
"""

from jax import config as _jax_config

_jax_config.update("jax_enable_x64", True)
# Default-precision f32 matmuls may run at reduced precision (TF32 on the
# GPU's tensor cores); the mixed-precision IOD path needs true-f32
# contractions (they are 3x3 einsums — full precision is free) or the rho
# solve loses ~5 digits.
_jax_config.update("jax_default_matmul_precision", "highest")

from outfit_tpu import constants  # noqa: E402,F401
from outfit_tpu.constants import (  # noqa: E402,F401
    AU,
    GAUSS_GRAV,
    GAUSS_GRAV_SQUARED,
    RADEG,
    RADH,
    RADSEC,
    SECONDS_PER_DAY,
    T2000,
    VLIGHT_AU,
)

__version__ = "0.2.0"

# --- curated top-level facade (parity: the reference's pub-use facade,
# src/lib.rs:326-434) --------------------------------------------------------
# Resolved lazily (PEP 562): `import outfit_tpu` stays light, and the heavy
# pipeline modules only load when a facade name is touched.
_FACADE = {
    # orbital element representations
    "KeplerianElements": "outfit_tpu.elements.types",
    "EquinoctialElements": "outfit_tpu.elements.types",
    "CometaryElements": "outfit_tpu.elements.types",
    "EquinoctialLimits": "outfit_tpu.elements.types",
    "OrbitalElements": "outfit_tpu.elements.types",
    # errors
    "OutfitError": "outfit_tpu.errors",
    # IOD entry points / key types
    "fit_full_iod": "outfit_tpu.iod.api",
    "fit_full_iod_parallel": "outfit_tpu.iod.api",
    "fit_full_iod_stream": "outfit_tpu.iod.api",
    "fit_iod": "outfit_tpu.iod.api",
    "FitResult": "outfit_tpu.iod.api",
    "GaussResult": "outfit_tpu.iod.api",
    "FullOrbitResult": "outfit_tpu.iod.api",
    "IODRMS": "outfit_tpu.iod.api",
    "IODParams": "outfit_tpu.iod.params",
    # differential correction
    "fit_lsq": "outfit_tpu.lsq.api",
    "fit_lsq_stream": "outfit_tpu.lsq.api",
    "fit_lsq_stream_escalating": "outfit_tpu.lsq.api",
    "fit_lsq_escalating": "outfit_tpu.lsq.api",
    "LsqResult": "outfit_tpu.lsq.api",
    "LsqTable": "outfit_tpu.lsq.table",
    "DifferentialCorrectionOutput": "outfit_tpu.lsq.api",
    "DifferentialCorrectionConfig": "outfit_tpu.lsq.config",
    # JPL ephemerides
    "JPLEphem": "outfit_tpu.ephem.api",
    "Body": "outfit_tpu.ephem.bodies",
    # ephemeris generation facade
    "AberrationOrder": "outfit_tpu.ephemeris.config",
    "EphemerisConfig": "outfit_tpu.ephemeris.config",
    "ApparentPosition": "outfit_tpu.ephemeris.compute",
    "BodyGeometry": "outfit_tpu.ephemeris.compute",
    "EphemerisEntry": "outfit_tpu.ephemeris.result",
    "EphemerisResult": "outfit_tpu.ephemeris.result",
    "EphemerisMode": "outfit_tpu.ephemeris.request",
    "EphemerisRequest": "outfit_tpu.ephemeris.request",
    "ObserverRequest": "outfit_tpu.ephemeris.request",
    "Position": "outfit_tpu.ephemeris.request",
    "Geometry": "outfit_tpu.ephemeris.request",
    "Combined": "outfit_tpu.ephemeris.request",
    "compute_ephemeris": "outfit_tpu.ephemeris.api",
    "FullOrbitResultExt": "outfit_tpu.ephemeris.api",
    # observation ingestion (photom surface)
    "ObsDataset": "outfit_tpu.observations",
    "ErrorModel": "outfit_tpu.observations",
    "Observer": "outfit_tpu.observations.observatories",
    "get_observatory": "outfit_tpu.observations.observatories",
    # time
    "Ut1Provider": "outfit_tpu.time.scales",
}

__all__ = sorted(
    list(_FACADE)
    + [
        "AU",
        "GAUSS_GRAV",
        "GAUSS_GRAV_SQUARED",
        "RADEG",
        "RADH",
        "RADSEC",
        "SECONDS_PER_DAY",
        "T2000",
        "VLIGHT_AU",
        "constants",
    ]
)


def __getattr__(name):
    mod = _FACADE.get(name)
    if mod is None:
        raise AttributeError(f"module 'outfit_tpu' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value  # cache for subsequent lookups
    return value


def __dir__():
    return __all__
