"""Error taxonomy.

Parity: ``OutfitError`` (``src/outfit_errors.rs:145-296``), a single enum of
~46 variants.  The batch-first design splits the taxonomy by layer:

* **inside batched kernels** errors are DATA — integer status codes and
  validity masks — so lanes fail independently without aborting the batch
  (the reference stores ``Err`` values per trajectory,
  ``obs_dataset_api.rs:66-68``; masks are the vectorized equivalent).
  Reference variants that name in-kernel failures therefore have NO
  exception class here; they map to status codes / masks instead:

  - ``NewtonRaphsonKeplerConvergence`` / ``BrentDekkerKeplerConvergence``
    -> ``kepler.universal.STATUS_*`` codes,
  - ``SingularDirectionMatrix`` / ``GaussNoRootsFound`` /
    ``PolynomialRootFindingFailed`` / ``SpuriousRootDetected`` /
    ``DegenerateState`` / ``VelocityCorrectionError`` -> candidate
    validity masks in ``iod.gauss``,
  - ``NBodyPropagationFailed`` -> non-finite state masks in
    ``propagator.nbody``,
  - ``RmsComputationFailed`` / ``NonFiniteScore`` -> inf lane scores in
    ``iod.scoring``.

* **at the host API boundary** errors are the exceptions below (every class
  has at least one raise site) or structured error strings on
  per-trajectory results (``FitResult.error`` / ``LsqResult.error`` /
  ``EphemerisEntry.error``), built via the result-error classes so the
  strings match the reference's variant formats.
"""


class OutfitError(Exception):
    """Base class for host-side errors."""


# -- raised at the host API boundary -----------------------------------------


class InvalidRefSystem(OutfitError, ValueError):
    """Invalid rotation-axis index / non-converging rotpn chain
    (ref_system.rs RefSystem errors)."""


class InvalidIODParameter(OutfitError, ValueError):
    """IODParams / config validation failure (mirrors the reference's
    builder validation errors, initial_orbit_determination/mod.rs:544-624)."""


class InvalidErrorModel(OutfitError, ValueError):
    """Unknown astrometric error-model name (photom ObsErrorModel parse)."""


class TrajectoryIdNotFound(OutfitError, KeyError):
    """Requested trajectory id is not present in the dataset."""


class UnknownObservatory(OutfitError, KeyError):
    """MPC observatory code absent from the catalog (photom fails loudly;
    a silent geocenter fallback would move the observer by up to ~6400 km)."""


class InvalidJPLStringFormat(OutfitError, ValueError):
    """Ephemeris source string is not 'scheme:NAME'
    (download_jpl_file.rs:87-126)."""


class JPLFileNotFound(OutfitError, FileNotFoundError):
    """Resolved ephemeris path does not exist (no-network build)."""


class InvalidJPLEphemFileVersion(OutfitError, ValueError):
    """Ephemeris binary has an unsupported format / layout."""


class InvalidSpkDataType(OutfitError, ValueError):
    """DAF/SPK segment data type is not Type 2 / Type 3."""


class EphemerisBodyNotSupported(OutfitError, KeyError):
    """No ephemeris segment/table for the requested body."""


# -- per-trajectory result errors (stored as strings, never raised from the
#    batch pipelines; constants.rs stores Err values the same way) ------------


class NoFeasibleTriplets(OutfitError):
    def __init__(self, span, n_obs, dt_min, dt_max):
        super().__init__(
            f"NoFeasibleTriplets(span={span:.3f}, n_obs={n_obs}, "
            f"dt_min={dt_min}, dt_max={dt_max})"
        )


class NoViableOrbit(OutfitError):
    def __init__(self, attempts, cause=None):
        msg = f"NoViableOrbit(attempts={attempts})"
        if cause:
            msg = f"NoViableOrbit(cause={cause}, attempts={attempts})"
        super().__init__(msg)
        self.cause = cause
        self.attempts = attempts


class BizarreOrbit(OutfitError):
    """Elements left the EquinoctialLimits box (equinoctial_element.rs
    :258-268); LSQ status code 2."""


class DifferentialCorrectionDiverged(OutfitError):
    """RMS grew past the divergence ratio (diff_cor.rs:336-388); LSQ
    status code 3."""


class DifferentialCorrectionFailed(OutfitError):
    """Normal-equation inversion failed (least_square.rs:329-341); LSQ
    status code 4."""


class InvalidOrbit(OutfitError):
    """Ephemeris request on a non-elliptical orbit (e >= 1 precheck,
    observation_ephemeris.rs:288-296)."""
