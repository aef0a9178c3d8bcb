"""IOD configuration.

Parity: ``IODParams`` (``src/initial_orbit_determination/mod.rs:224-343``)
with identical defaults.  Frozen dataclass -> hashable -> jit-static.
"""

from dataclasses import dataclass

_EPS = 2.220446049250313e-16


@dataclass(frozen=True)
class IODParams:
    # --- triplet generation / Monte Carlo ---
    n_noise_realizations: int = 20
    noise_scale: float = 1.0
    extf: float = -1.0
    dtmax: float = 30.0
    dt_min: float = 0.03
    dt_max_triplet: float = 150.0
    optimal_interval_time: float = 20.0
    max_obs_for_triplets: int = 100
    max_triplets: int = 10
    gap_max: float = 8.0 / 24.0

    #: device-batch size hint in LANES (parity: IODParams.batch_size,
    #: mod.rs:169-171).  0 = the whole dataset as one batch (default);
    #: > 0 = trajectories are grouped into chunks of at most this many
    #: lanes (a trajectory is never split), bounding device memory.
    batch_size: int = 0

    # --- physical plausibility / filtering ---
    max_ecc: float = 5.0
    max_perihelion_au: float = 1.0e3
    min_rho2_au: float = 0.01

    # --- Gauss polynomial / solver controls ---
    aberth_max_iter: int = 50
    aberth_eps: float = 1.0e-6
    kepler_eps: float = 1e3 * _EPS
    max_tested_solutions: int = 3
    r2_min_au: float = 0.05
    r2_max_au: float = 200.0

    # --- numerical tolerances / iterations ---
    newton_eps: float = 1.0e-10
    newton_max_it: int = 50
    root_imag_eps: float = 1.0e-6

    # --- device execution policy (no reference counterpart) ---
    #: "f64" = everything in float64;
    #: "mixed" = f32 root-finding/correction/scoring + f64 polish of the
    #: per-lane selected candidate, at seed-grade accuracy (the LSQ stage
    #: always refines in f64 regardless).  Whether it pays where f64 is
    #: native is ROADMAP C2.
    precision: str = "f64"

    #: f64 correction iterations in the mixed-precision polish pass.
    polish_max_it: int = 12

    #: opt-in SELECTION-window subsampling (0 = off, reference-parity
    #: selection).  When > 0, the per-candidate RMS used to SELECT among
    #: the max_tested_solutions Gauss candidates (and among Monte-Carlo
    #: lanes) is computed on a uniform-with-edges subsample of at most
    #: this many window observations; the selected winner is then
    #: rescored on the FULL window (the mixed-precision f64 polish
    #: already does this; the f64 path adds a winner-only full rescore),
    #: so the REPORTED RMS is always the full-window value.  On real
    #: survey arcs (mean ~76 obs) candidate scoring is a large share of
    #: the IOD dispatch;
    #: subsampling trades it for a possible selection-order deviation on
    #: near-tie candidates (either member of such a tie is an equally
    #: good seed — the LSQ stage refines whichever wins).  Arcs whose
    #: window is already <= the subsample produce BITWISE-identical
    #: results (tests/test_iod.py::TestSelectionSubsample).
    #: EXTRA FAILURE MODE (f64 path): when the subsample-selected winner
    #: scores non-finite on the full-window rescore (its orbit fails to
    #: propagate to an out-of-subsample epoch), the trajectory is
    #: reported FAILED even though a different candidate might have
    #: scored finite on the full window — the winner-only rescore cannot
    #: re-rank.  Such orbits are near-degenerate seeds; full scoring
    #: (subsample off) is the recovery path if they matter.
    selection_subsample: int = 0

    def __str__(self) -> str:
        """Pretty printer (parity: IODParams Display, mod.rs:632-789)."""
        lines = ["IODParams {"]
        for section, keys in [
            ("triplets / Monte-Carlo", ["n_noise_realizations", "noise_scale",
             "extf", "dtmax", "dt_min", "dt_max_triplet",
             "optimal_interval_time", "max_obs_for_triplets", "max_triplets",
             "gap_max", "batch_size"]),
            ("physical filters", ["max_ecc", "max_perihelion_au", "min_rho2_au",
             "r2_min_au", "r2_max_au"]),
            ("solvers", ["aberth_max_iter", "aberth_eps", "kepler_eps",
             "max_tested_solutions", "newton_eps", "newton_max_it",
             "root_imag_eps"]),
            ("device execution", ["precision", "polish_max_it",
             "selection_subsample"]),
        ]:
            lines.append(f"  # {section}")
            for k in keys:
                lines.append(f"  {k}: {getattr(self, k)}")
        lines.append("}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        """Serde-feature analogue (Cargo.toml:67,81): round-trippable dict."""
        from dataclasses import asdict

        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "IODParams":
        return cls(**d)

    def validated(self) -> "IODParams":
        """Parity: IODParamsBuilder::build() validation (:544-624)."""
        from outfit_tpu.errors import InvalidIODParameter

        if self.dt_min <= 0 or self.dt_max_triplet <= self.dt_min:
            raise InvalidIODParameter("require 0 < dt_min < dt_max_triplet")
        if self.noise_scale < 0 or self.max_triplets < 1:
            raise InvalidIODParameter("noise_scale >= 0 and max_triplets >= 1 required")
        if self.r2_min_au <= 0 or self.r2_max_au <= self.r2_min_au:
            raise InvalidIODParameter("require 0 < r2_min_au < r2_max_au")
        if self.precision not in ("f64", "mixed"):
            raise InvalidIODParameter("precision must be 'f64' or 'mixed'")
        if self.batch_size < 0:
            raise InvalidIODParameter("batch_size must be >= 0 (0 = single batch)")
        if self.selection_subsample < 0 or self.selection_subsample == 1:
            raise InvalidIODParameter(
                "selection_subsample must be 0 (off) or >= 2"
            )
        return self
