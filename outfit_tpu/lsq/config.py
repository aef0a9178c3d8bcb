"""Differential-correction configuration.

Parity: ``DifferentialCorrectionConfig`` (``diff_cor.rs:78-192``) and
``OutlierRejectionConfig`` (``outlier_rejection.rs:49-80``), identical
defaults.  Frozen -> hashable -> jit-static.
"""

from dataclasses import dataclass
from typing import Tuple

from outfit_tpu.elements.types import EquinoctialLimits
from outfit_tpu.propagator.config import PropagatorKind


@dataclass(frozen=True)
class OutlierRejectionConfig:
    chi_squared_rejection_threshold: float = 25.0
    chi_squared_recovery_threshold: float = 9.0


@dataclass(frozen=True)
class DifferentialCorrectionConfig:
    max_newton_iterations: int = 30
    max_outlier_rejection_passes: int = 10
    convergence_threshold: float = 1e-4
    convergence_before_rejection_threshold: float = 2.0
    rms_stagnation_ratio: float = 0.98
    rms_divergence_ratio: float = 1.5
    max_stagnation_iterations: int = 3
    enable_outlier_rejection: bool = True
    outlier_rejection: OutlierRejectionConfig = OutlierRejectionConfig()
    orbital_limits: EquinoctialLimits = EquinoctialLimits()
    free_elements: Tuple[bool, bool, bool, bool, bool, bool] = (True,) * 6
    propagator: PropagatorKind = PropagatorKind.two_body()

    #: "f64" = every Newton iteration in float64 (reference parity);
    #: "mixed" = an f32 pre-warm phase (no outlier decisions, guarded
    #: advances only) runs the orbit to ~1e-3 correction norm at native f32
    #: rate, then the f64 loop finishes from the warmed elements with f64
    #: residuals and f32 Jacobians (it owns convergence, outliers, and
    #: covariance).  The approximate Jacobian moves that loop's fixed point
    #: off the f64 optimum: up to ~6e-3 of a formal sigma on noisy 12-obs
    #: arcs, so mixed elements match f64 to a hundredth of a sigma, not to
    #: rtol 1e-8.  Whether it pays where f64 is native is ROADMAP C2.
    precision: str = "f64"

    #: iteration cap for the f32 pre-warm phase (mixed only).
    prewarm_max_iterations: int = 12

    #: Newton iterations exempt from the divergence ratio check (no reference
    #: counterpart; default 0 = exact reference behavior, diff_cor.rs:356).
    #: From a Gauss seed the first full Newton step routinely overshoots the
    #: RMS transiently (e.g. 1.8 -> 7.7 -> 0.02 -> 1e-10); a grace of 2
    #: recovers those fits instead of falling back to the IOD orbit.
    divergence_grace_iterations: int = 0

    # --- serde-feature analogue (Cargo.toml:67,81): round-trippable dicts ---
    def to_dict(self) -> dict:
        from dataclasses import asdict

        d = asdict(self)
        d["outlier_rejection"] = asdict(self.outlier_rejection)
        d["orbital_limits"] = self.orbital_limits._asdict()
        d["propagator"] = self.propagator.to_dict()
        d["free_elements"] = list(self.free_elements)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DifferentialCorrectionConfig":
        d = dict(d)
        if isinstance(d.get("outlier_rejection"), dict):
            d["outlier_rejection"] = OutlierRejectionConfig(**d["outlier_rejection"])
        if isinstance(d.get("orbital_limits"), dict):
            d["orbital_limits"] = EquinoctialLimits(**d["orbital_limits"])
        if isinstance(d.get("propagator"), dict):
            d["propagator"] = PropagatorKind.from_dict(d["propagator"])
        if "free_elements" in d:
            d["free_elements"] = tuple(d["free_elements"])
        return cls(**d)
