"""ONE-dispatch bulk ephemeris generation over whole fit-result sets.

The reference's bulk entry (``FullOrbitResultExt::compute_ephemerides``,
``src/ephemeris/batch.rs:73``) iterates trajectories — fine on a CPU,
but a per-orbit device dispatch costs a host round trip plus
per-dispatch kernel latency, so a 100k-orbit survey catalog the
reference's way is dominated by dispatch overhead.  Batch-first shape:
when every trajectory shares
one request grid (the survey case — same observers, same epochs), stack
the orbit rows and evaluate ALL of them in ONE ``compute_apparent``
call over a ``(n_orbits, n_pairs)`` batch, returning columnar arrays.

``compute_ephemerides_for_results`` (api.py) remains the
reference-parity per-trajectory path; this module is the batch-first
alternative, ~``n_orbits``x fewer dispatches.

Rows whose fit failed, whose orbit is non-elliptic, or whose observer is
unknown ride along as masked lanes (benign elements, ``ok=False``) so
one bad row never costs a recompile or a batch abort — the same
errors-as-data posture as the fit kernels.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from outfit_tpu.elements.types import EquinoctialElements
from outfit_tpu.ephemeris.api import EphemerisValue, _request_pairs
from outfit_tpu.ephemeris.compute import (
    ApparentPosition,
    BodyGeometry,
    compute_apparent,
)
from outfit_tpu.ephemeris.request import (
    Combined,
    EphemerisRequest,
    Geometry,
    Position,
)
from outfit_tpu.ephemeris.result import EphemerisEntry, EphemerisResult
from outfit_tpu.errors import InvalidOrbit
from outfit_tpu.time.scales import Ut1Provider

__all__ = ["EphemerisTable", "compute_ephemerides_batch"]

#: position/geometry column names, in NamedTuple field order
_POS_FIELDS = ("ra", "dec", "geocentric_distance", "heliocentric_distance")
_GEOM_FIELDS = (
    "phase_angle", "solar_elongation", "radial_velocity", "d_ra_dt",
    "d_dec_dt",
)


@dataclass
class EphemerisTable:
    """Columnar bulk-ephemeris results: every array is
    ``(n_trajectories, n_pairs)`` in (dataset order) x (request pair
    order).  ``result(tid)`` materializes one row as the
    ``EphemerisResult`` the per-orbit API returns (parity/migration
    path); ``to_dataframe()`` is the survey-scale hand-off."""

    traj_ids: List[str]
    #: flattened request pairs, column order of every array
    epochs: np.ndarray  # (P,)
    observers: list  # (P,) Observer per pair
    ra: np.ndarray  # (T, P) radians
    dec: np.ndarray
    geocentric_distance: np.ndarray  # AU
    heliocentric_distance: np.ndarray
    phase_angle: np.ndarray  # radians
    solar_elongation: np.ndarray
    radial_velocity: np.ndarray  # AU/day
    d_ra_dt: np.ndarray  # radians/day
    d_dec_dt: np.ndarray
    ok: np.ndarray  # (T, P) bool
    #: per-trajectory error string for rows that never dispatched
    #: (failed fit / non-elliptic orbit); propagation failures are
    #: per-entry ``ok=False`` with finite=False lanes
    row_errors: Dict[str, str] = field(default_factory=dict)
    #: per-pair unknown-observatory flag (those columns are errors on
    #: every row)
    unknown_observer: Optional[np.ndarray] = None
    #: the request's output kind (Position/Geometry/Combined), used by
    #: ``result`` materialization
    output: str = Combined
    #: lazily built {traj_id: row} map; never set directly
    _tid_index: Optional[Dict[str, int]] = field(
        default=None, repr=False, compare=False
    )

    def __len__(self) -> int:
        return len(self.traj_ids)

    @property
    def n_pairs(self) -> int:
        return len(self.epochs)

    def result(self, traj_id) -> EphemerisResult:
        """Materialize one row as the per-orbit API's EphemerisResult."""
        # O(1) via a lazily built id->row map (traj_ids is immutable after
        # construction): a per-lookup list.index would make the advertised
        # per-orbit migration loop O(T^2) over survey catalogs
        if self._tid_index is None:
            self._tid_index = {t: k for k, t in enumerate(self.traj_ids)}
        try:
            i = self._tid_index[traj_id]
        except KeyError:
            raise KeyError(traj_id) from None
        err = self.row_errors.get(traj_id)
        entries = []
        for j in range(self.n_pairs):
            o, t = self.observers[j], float(self.epochs[j])
            if err is not None:
                entries.append(EphemerisEntry(t, o, error=err))
            elif self.unknown_observer is not None and self.unknown_observer[j]:
                entries.append(
                    EphemerisEntry(t, o, error=f"UnknownObservatory({o.code})")
                )
            elif self.ok[i, j]:
                pos = ApparentPosition(
                    *(float(getattr(self, f)[i, j]) for f in _POS_FIELDS)
                )
                geom = BodyGeometry(
                    *(float(getattr(self, f)[i, j]) for f in _GEOM_FIELDS)
                )
                if self.output == Position:
                    val = pos
                elif self.output == Geometry:
                    val = geom
                else:
                    val = EphemerisValue(pos, geom)
                entries.append(EphemerisEntry(t, o, value=val))
            else:
                entries.append(
                    EphemerisEntry(
                        t, o, error="PropagationFailed or non-finite result"
                    )
                )
        return EphemerisResult(entries)

    def __getitem__(self, traj_id) -> EphemerisResult:
        return self.result(traj_id)

    def to_dataframe(self):
        """Long-format pandas DataFrame: one row per (trajectory, pair),
        scalar columns (traj_id, epoch, observer code, ok, every
        position/geometry field)."""
        import pandas as pd

        T, P = self.ok.shape
        codes = np.array(
            [getattr(o, "code", "") or "" for o in self.observers], object
        )
        data = {
            "traj_id": np.repeat(np.asarray(self.traj_ids, object), P),
            "epoch": np.tile(self.epochs, T),
            "observer": np.tile(codes, T),
            "ok": self.ok.ravel(),
        }
        for f in _POS_FIELDS + _GEOM_FIELDS:
            data[f] = getattr(self, f).ravel()
        return pd.DataFrame(data)


def _get_batch_runner(ephem, propagator, aberration):
    """Compile-cached jitted core (one fused device dispatch): eager
    ``compute_apparent`` costs one dispatch PER OP; jitted it is one.  The cache lives ON the ephem object (tables are
    jit constants; the ``_get_runner`` pattern, lsq/api.py:160-183)."""
    store = getattr(ephem, "_ephem_batch_jit", None)
    if store is None:
        store = {}
        try:
            ephem._ephem_batch_jit = store
        except AttributeError:
            pass
    key = (propagator, aberration)
    if key not in store:

        def _run(ep_safe, eq_cols, epochs, obs_pos, obs_vel):
            T = ep_safe.shape[0]
            P = epochs.shape[0]
            eqb = EquinoctialElements(
                ep_safe[:, None], *(c[:, None] for c in eq_cols)
            )
            return compute_apparent(
                eqb,
                jnp.broadcast_to(epochs[None, :], (T, P)),
                obs_pos[None, :, :],
                obs_vel[None, :, :],
                propagator=propagator,
                aberration=aberration,
                ephem=ephem,
            )

        store[key] = jax.jit(_run)
    return store[key]


def _bucket_pow2(n: int, lo: int = 8) -> int:
    """Next power of two >= n (floored at ``lo``): the jitted runner's
    compile key is the (T, P) shape, so exact shapes would recompile per
    distinct request size, seconds each.
    Bucketing bounds total compiles at log2 of the largest size seen."""
    return max(lo, 1 << (int(n) - 1).bit_length())


def _run_batch_padded(runner, ep_safe, eq_safe, epochs, obs_pos, obs_vel,
                      pad_rows=True):
    """Call the jitted runner on bucket-padded shapes and slice back.

    The pair axis (and, for the bulk path, the orbit axis) is padded to
    a power-of-two bucket with EDGE values — real in-ephemeris-range
    epochs and real observer states duplicated from the last row — so
    padded lanes do benign finite work and cannot perturb live lanes
    (everything is elementwise per (orbit, pair)).  Returns numpy
    ``(position, geometry, ok)`` sliced to the true (T, P)."""
    T, P = ep_safe.shape[0], epochs.shape[0]
    Pb = _bucket_pow2(P)
    Tb = _bucket_pow2(T) if pad_rows else T
    epochs = np.asarray(epochs)
    obs_pos = np.asarray(obs_pos)
    obs_vel = np.asarray(obs_vel)
    if Pb != P:
        epochs = np.pad(epochs, (0, Pb - P), mode="edge")
        obs_pos = np.pad(obs_pos, ((0, Pb - P), (0, 0)), mode="edge")
        obs_vel = np.pad(obs_vel, ((0, Pb - P), (0, 0)), mode="edge")
    if Tb != T:
        ep_safe = np.pad(ep_safe, (0, Tb - T), mode="edge")
        eq_safe = np.pad(eq_safe, ((0, Tb - T), (0, 0)), mode="edge")
    out = runner(
        jnp.asarray(ep_safe),
        tuple(jnp.asarray(eq_safe[:, j]) for j in range(6)),
        jnp.asarray(epochs),
        jnp.asarray(obs_pos),
        jnp.asarray(obs_vel),
    )
    pos = ApparentPosition(
        *(np.asarray(f)[:T, :P] for f in out.position)
    )
    geom = BodyGeometry(*(np.asarray(f)[:T, :P] for f in out.geometry))
    return pos, geom, np.asarray(out.ok)[:T, :P]


def compute_ephemerides_batch(
    results,
    request: EphemerisRequest,
    ephem,
    ut1: Optional[Ut1Provider] = None,
) -> EphemerisTable:
    """Bulk ephemeris generation in ONE device dispatch (module doc).

    ``results``: a ``{traj_id: LsqResult}`` map (the ``fit_lsq`` return),
    an :class:`~outfit_tpu.lsq.table.LsqTable` (columnar service mode —
    consumed column-wise, no per-row materialization), or a
    ``{traj_id: (epoch, equinoctial_vector)}`` map of raw elements.
    Every trajectory is evaluated on the SAME request grid.
    """
    if ut1 is None:
        ut1 = Ut1Provider()

    # ---- collect orbit rows (columnar fast path for LsqTable) -----------
    row_errors: Dict[str, str] = {}
    if hasattr(results, "traj_ids") and hasattr(results, "equinoctial"):
        tids = list(results.traj_ids)
        eq_rows = np.asarray(results.equinoctial, np.float64).copy()
        ep_rows = np.asarray(results.epoch, np.float64).copy()
        fit_ok = np.asarray(results.ok, bool).copy()
        for i, tid in enumerate(tids):
            if not fit_ok[i]:
                row_errors[tid] = f"fit failed: {results.result(tid).error}"
    else:
        tids, eqs, eps, oks = [], [], [], []
        for tid, r in results.items():
            tids.append(tid)
            # raw elements: any 2-sequence (epoch, equinoctial_vector) —
            # tuple, list, or array pair (zip/JSON pipelines produce
            # lists; a tuple-only check silently misclassified those as
            # failed fits)
            if isinstance(r, (tuple, list)) or (
                isinstance(r, np.ndarray) and r.dtype == object
            ):
                if len(r) != 2:
                    raise TypeError(
                        f"results[{tid!r}]: raw-elements entry must be "
                        f"(epoch, equinoctial_vector), got length {len(r)}"
                    )
                ep_i, eq_i = r
                eqs.append(np.asarray(eq_i, np.float64))
                eps.append(float(ep_i))
                oks.append(True)
            elif not hasattr(r, "ok"):
                raise TypeError(
                    f"results[{tid!r}]: expected an LsqResult-like object "
                    "(with .ok/.equinoctial/.epoch) or a raw "
                    f"(epoch, equinoctial_vector) pair, got {type(r).__name__}"
                )
            elif getattr(r, "ok", False) and getattr(r, "equinoctial", None) is not None:
                eqs.append(np.asarray(r.equinoctial, np.float64))
                eps.append(float(r.epoch))
                oks.append(True)
            else:
                eqs.append(np.full(6, np.nan))
                eps.append(0.0)
                oks.append(False)
                row_errors[tid] = f"fit failed: {getattr(r, 'error', '?')}"
        eq_rows = np.asarray(eqs).reshape(len(tids), 6)
        ep_rows = np.asarray(eps)
        fit_ok = np.asarray(oks)

    T = len(tids)

    # non-elliptic precheck, vectorized (mod.rs:223 parity).  NaN ecc is
    # NOT flagged here — the per-orbit API's `ecc >= 1.0` passes NaN
    # through to the kernel, which reports PropagationFailed; the batch
    # path must classify identically.  Runs BEFORE the observer-state
    # device work so an all-dead batch costs zero dispatches
    with np.errstate(invalid="ignore"):
        ecc = np.hypot(eq_rows[:, 1], eq_rows[:, 2])
        bad_e = fit_ok & (ecc >= 1.0)
    for i in np.flatnonzero(bad_e):
        row_errors[tids[i]] = str(
            InvalidOrbit(f"InvalidOrbit(e={ecc[i]:.3f} >= 1)")
        )
    live = fit_ok & ~bad_e
    any_live = bool(live.any())

    flat = _request_pairs(request, ephem, ut1, with_states=any_live)
    if flat is None or T == 0:
        return EphemerisTable(
            traj_ids=tids, epochs=np.empty(0), observers=[],
            **{f: np.zeros((T, 0)) for f in _POS_FIELDS + _GEOM_FIELDS},
            ok=np.zeros((T, 0), bool), row_errors=row_errors,
            unknown_observer=np.zeros(0, bool),
            output=getattr(request, "output", Combined),
        )
    pairs, epochs, obs_pos, obs_vel, unknown = flat
    P = len(pairs)

    if not any_live:
        # every row is a failed fit / non-elliptic orbit: all entries are
        # errors, so no orbit evaluation and no observer-state dispatches
        # (values are unspecified where ok=False; NaN is the honest fill)
        return EphemerisTable(
            traj_ids=tids, epochs=epochs, observers=[o for o, _ in pairs],
            **{f: np.full((T, P), np.nan)
               for f in _POS_FIELDS + _GEOM_FIELDS},
            ok=np.zeros((T, P), bool), row_errors=row_errors,
            unknown_observer=unknown,
            output=getattr(request, "output", Combined),
        )

    # dead lanes ride along on a benign circular orbit; live rows keep
    # their values verbatim (including NaN) for per-orbit kernel parity
    benign = np.array([2.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    eq_safe = np.where(live[:, None], eq_rows, benign)
    ep_safe = np.where(live, ep_rows, 57000.0)

    runner = _get_batch_runner(
        ephem, request.config.propagator, request.config.aberration
    )
    pos, geom, ok_k = _run_batch_padded(
        runner, ep_safe, eq_safe, epochs, obs_pos, obs_vel, pad_rows=True
    )

    ok = ok_k & live[:, None] & ~unknown[None, :]
    cols = {f: getattr(pos, f) for f in _POS_FIELDS}
    cols.update({f: getattr(geom, f) for f in _GEOM_FIELDS})
    return EphemerisTable(
        traj_ids=tids,
        epochs=epochs,
        observers=[o for o, _ in pairs],
        **cols,
        ok=ok,
        row_errors=row_errors,
        unknown_observer=unknown,
        output=getattr(request, "output", Combined),
    )
