"""Ephemeris generation entry point.

Parity: ``OrbitalElements::compute`` (``src/ephemeris/mod.rs:189-290``):
convert to equinoctial once, e >= 1 precheck short-circuits every entry,
per-observer fixed cache, per-epoch computation with errors collected per
entry (never aborting).  All (observer, epoch) pairs of a request are
evaluated as ONE batched device call.
"""

from dataclasses import dataclass
from typing import Optional, Union

import jax.numpy as jnp
import numpy as np

from outfit_tpu.errors import InvalidOrbit
from outfit_tpu.elements.types import EquinoctialElements, KeplerianElements, keplerian_to_equinoctial
from outfit_tpu.ephemeris.compute import ApparentPosition, BodyGeometry, compute_apparent
from outfit_tpu.ephemeris.request import Combined, Geometry, Position, EphemerisRequest
from outfit_tpu.ephemeris.result import EphemerisEntry, EphemerisResult
from outfit_tpu.observer.geometry import (
    earth_fixed_position,
    earth_fixed_velocity,
    gast,
    helio_position,
    helio_velocity,
    pvobs,
)
from outfit_tpu.time.scales import Ut1Provider


@dataclass
class EphemerisValue:
    """Combined output value (Position + Geometry views)."""

    position: ApparentPosition
    geometry: BodyGeometry


def _request_pairs(request: EphemerisRequest, ephem, ut1, with_states=True):
    """Flatten a request into (observer, epoch) pairs + the observers'
    heliocentric states.  The observer-fixed vectors are computed ONCE per
    observer entry and broadcast over its epochs (ObserverFixedCache
    parity, mod.rs:258).  Returns ``None`` for an empty request, else
    ``(pairs, epochs, obs_pos, obs_vel, unknown)``.

    ``with_states=False`` skips the observer-state device work (gast /
    pvobs / heliocentric dispatches) and returns ``None`` states — for
    callers that only need the pair grid (e.g. every fit in a batch
    failed, so all entries are errors and no orbit will be evaluated)."""
    pairs = []
    fp_rows, fv_rows = [], []
    for entry in request.entries:
        o = entry.observer
        eps = list(entry.mode.epochs)
        if not eps:
            continue
        pairs.extend((o, t) for t in eps)
        if not with_states:
            continue
        fp_rows.append(
            np.broadcast_to(np.asarray(earth_fixed_position(o)), (len(eps), 3))
        )
        fv_rows.append(
            np.broadcast_to(np.asarray(earth_fixed_velocity(o)), (len(eps), 3))
        )
    if not pairs:
        return None

    # unknown observatory codes carry geocenter placeholder coordinates (up
    # to ~6400 km observer error) — per-entry error, never a silent geocenter
    # (same contract as the fit pipelines' per-trajectory UnknownObservatory)
    unknown = np.array([bool(getattr(o, "unknown", False)) for o, _ in pairs])

    epochs = np.array([t for _, t in pairs])
    if not with_states:
        return pairs, epochs, None, None, unknown
    fixed_pos = np.concatenate(fp_rows, axis=0)
    fixed_vel = np.concatenate(fv_rows, axis=0)

    g = gast(epochs, ut1)
    geo_pos, geo_vel = pvobs(
        jnp.asarray(epochs), jnp.asarray(fixed_pos), jnp.asarray(fixed_vel), g
    )
    obs_pos = helio_position(ephem, epochs, geo_pos)
    obs_vel = helio_velocity(ephem, epochs, geo_vel)
    return pairs, epochs, obs_pos, obs_vel, unknown


def compute_ephemeris(
    elements: Union[EquinoctialElements, KeplerianElements],
    request: EphemerisRequest,
    ephem,
    ut1: Optional[Ut1Provider] = None,
    _flat=None,
) -> EphemerisResult:
    """Compute apparent positions + geometry for every (observer, epoch).

    ``_flat``: precomputed :func:`_request_pairs` output — the bulk
    per-orbit loop shares one request's observer states across orbits."""
    if isinstance(elements, KeplerianElements):
        eq = keplerian_to_equinoctial(elements)
    else:
        eq = elements
    if ut1 is None:
        ut1 = Ut1Provider()

    # precheck (mod.rs:223): non-elliptic orbits error every entry —
    # BEFORE the observer-state device work, which would be discarded
    ecc = float(np.hypot(float(eq.h), float(eq.k)))
    if ecc >= 1.0:
        pairs = [
            (e.observer, t) for e in request.entries for t in e.mode.epochs
        ]
        return EphemerisResult(
            [
                EphemerisEntry(t, o, error=str(InvalidOrbit(f"InvalidOrbit(e={ecc:.3f} >= 1)")))
                for o, t in pairs
            ]
        )

    flat = _request_pairs(request, ephem, ut1) if _flat is None else _flat
    if flat is None:
        return EphemerisResult([])
    pairs, epochs, obs_pos, obs_vel, unknown = flat

    # one fused device dispatch through the compile-cached batch runner
    # (T=1 row) instead of one dispatch per op of an eager
    # compute_apparent (~40 ops; see ephemeris/batch.py).  The pair axis is bucket-padded so interactive callers with varying
    # epoch grids compile once per power-of-two bucket, not once per
    # exact pair count (_run_batch_padded)
    from outfit_tpu.ephemeris.batch import _get_batch_runner, _run_batch_padded

    runner = _get_batch_runner(
        ephem, request.config.propagator, request.config.aberration
    )
    ep1 = np.asarray([float(eq.reference_epoch)])
    eq1 = np.asarray(
        [[float(f) for f in (eq.semi_major_axis, eq.h, eq.k, eq.p, eq.q,
                             eq.mean_longitude)]]
    )
    pos1, geom1, ok1 = _run_batch_padded(
        runner, ep1, eq1, epochs, obs_pos, obs_vel, pad_rows=False
    )

    ok = ok1[0]
    # already numpy (one device->host transfer per output field, never one
    # per entry)
    pos_np = [f[0] for f in pos1]
    geom_np = [f[0] for f in geom1]
    kind = getattr(request, "output", Combined)
    entries = []
    for i, (o, t) in enumerate(pairs):
        if unknown[i]:
            # same text the fit pipelines emit (iod/api.py UnknownObservatory)
            entries.append(
                EphemerisEntry(t, o, error=f"UnknownObservatory({o.code})")
            )
        elif ok[i]:
            if kind == Position:
                val = ApparentPosition(*[float(f[i]) for f in pos_np])
            elif kind == Geometry:
                val = BodyGeometry(*[float(f[i]) for f in geom_np])
            else:
                val = EphemerisValue(
                    ApparentPosition(*[float(f[i]) for f in pos_np]),
                    BodyGeometry(*[float(f[i]) for f in geom_np]),
                )
            entries.append(EphemerisEntry(t, o, value=val))
        else:
            entries.append(
                EphemerisEntry(t, o, error="PropagationFailed or non-finite result")
            )
    return EphemerisResult(entries)


def compute_ephemerides_for_results(
    results,
    request: EphemerisRequest,
    ephem,
    ut1: Optional[Ut1Provider] = None,
):
    """Bulk ephemeris generation over a fit-result map.

    Parity: ``FullOrbitResultExt`` (``src/ephemeris/batch.rs:73``) — one
    EphemerisResult per trajectory id; failed fits yield all-error entries.
    For survey-scale catalogs prefer
    :func:`outfit_tpu.ephemeris.batch.compute_ephemerides_batch` (one
    device dispatch for ALL orbits).
    """
    if ut1 is None:
        ut1 = Ut1Provider()
    # the request's observer heliocentric states are orbit-independent:
    # compute them once, not once per trajectory — and not at all when
    # every fit failed (short-arc reject batches): those rows yield
    # all-error entries with zero device work
    any_ok = any(
        getattr(r, "ok", False) and getattr(r, "equinoctial", None) is not None
        for r in results.values()
    )
    flat = _request_pairs(request, ephem, ut1) if any_ok else None
    out = {}
    for tid, r in results.items():
        eqv = getattr(r, "equinoctial", None)
        if not getattr(r, "ok", False) or eqv is None:
            pairs = [
                (e.observer, t) for e in request.entries for t in e.mode.epochs
            ]
            out[tid] = EphemerisResult(
                [
                    EphemerisEntry(t, o, error=f"fit failed: {getattr(r, 'error', '?')}")
                    for o, t in pairs
                ]
            )
            continue
        eq = EquinoctialElements(
            jnp.float64(r.epoch), *map(jnp.float64, np.asarray(eqv))
        )
        out[tid] = compute_ephemeris(eq, request, ephem, ut1, _flat=flat)
    return out


#: Reference-name alias (``FullOrbitResultExt::compute_ephemerides``,
#: batch.rs:73) — the bulk-over-results entry point.
FullOrbitResultExt = compute_ephemerides_for_results
