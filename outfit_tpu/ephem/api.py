"""Ephemeris facade: source resolution and batched state queries.

Parity: ``JPLEphem`` (``src/jpl_ephem/mod.rs:95-287``) — source strings
("horizon:DE440", "naif:DE440"), ``earth_ephemeris`` (Earth - Sun with the
EMB/Moon EMRAT correction), ``body_ephemeris`` (heliocentric perturber
states).  Additions vs the reference:

* ``"analytic:builtin"`` — file-free Standish/lunar-theory source (no
  network; the reference downloads DE440 on first use),
* all queries are batched over epoch arrays and jit-compatible,
* the NAIF backend returns the *true* heliocentric Earth (the reference's
  NAIF path returns barycentric EMB, ``mod.rs:165-171``, which is
  inconsistent with its Horizon path; we treat that as a bug and correct it),
* velocities are AU/day from both backends (the reference's Horizon
  ``body_ephemeris`` multiplies by 86400 labeling AU/s -> AU/day,
  ``mod.rs:221``, double-scaling dormant in practice because perturber
  velocities are never consumed).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from outfit_tpu.ephem.analytic import EMRAT, build_analytic_tables
from outfit_tpu.ephem.bodies import Body
from outfit_tpu.ephem.chebyshev import BodyTable, interpolate_body

#: default coverage for the analytic source (MJD): 1960-01-01 .. 2060-01-01
_ANALYTIC_SPAN = (36934.0, 73459.0)


class JPLEphem:
    """Planetary ephemeris with device-resident Chebyshev tables.

    ``tables`` maps Body -> BodyTable.  Planet tables may be either
    SSB-centered (DE files) or heliocentric (analytic source, no SUN table);
    queries always return heliocentric states, subtracting the SUN table
    when present.
    """

    def __init__(
        self,
        tables="analytic:builtin",
        emrat: float = EMRAT,
        kind: str = "analytic",
        path: Optional[str] = None,
    ):
        """Accepts either a resolved ``{Body: BodyTable}`` dict or a source
        string (``"analytic:builtin"``, ``"horizon:DE440"``, ``"naif:DE440"``)
        — the string form mirrors the reference's ``Outfit::new("horizon:DE440",
        ...)`` ergonomics (download_jpl_file.rs:87-126) and delegates to
        :meth:`new`."""
        if isinstance(tables, str):
            resolved = JPLEphem.new(tables, path=path)
            self.tables = resolved.tables
            self.emrat = resolved.emrat
            self.kind = resolved.kind
            return
        self.tables = tables
        self.emrat = float(emrat)
        self.kind = kind

    # -- construction --------------------------------------------------------

    @classmethod
    def new(cls, source: str = "analytic:builtin", path: Optional[str] = None) -> "JPLEphem":
        """Resolve an ephemeris source.

        Accepted forms (parity: ``EphemFileSource`` download_jpl_file.rs:87-126,
        minus networking):

        * ``"analytic:builtin"`` — built-in analytic source,
        * ``"horizon:DE440"`` / ``"naif:DE440"`` — requires the binary file to
          exist locally (``path=`` or $OUTFIT_EPHEM_DIR/<name>); zero-egress
          environments cannot download.
        """
        scheme, _, name = source.partition(":")
        if scheme == "analytic":
            return cls.analytic()
        file_path = path or _resolve_local_file(scheme, name)
        if scheme == "horizon":
            from outfit_tpu.ephem.horizon import HorizonEphemeris

            h = HorizonEphemeris(file_path)
            return cls(h.tables(), emrat=h.emrat, kind="horizon")
        if scheme == "naif":
            from outfit_tpu.ephem.naif import NaifEphemeris

            n = NaifEphemeris(file_path)
            tables = {}
            pairs = {
                Body.EMB: (3, 0),
                Body.SUN: (10, 0),
                Body.MOON: (301, 3),
                Body.EARTH: (399, 3),
                Body.MERCURY_BARY: (1, 0),
                Body.VENUS_BARY: (2, 0),
                Body.MARS_BARY: (4, 0),
                Body.JUPITER_BARY: (5, 0),
                Body.SATURN_BARY: (6, 0),
                Body.URANUS_BARY: (7, 0),
                Body.NEPTUNE_BARY: (8, 0),
                Body.PLUTO_BARY: (9, 0),
            }
            for body, (t, c) in pairs.items():
                try:
                    tables[body] = n.segment_for(t, c).table
                except KeyError:
                    pass
            return cls(tables, emrat=EMRAT, kind="naif")
        from outfit_tpu.errors import InvalidJPLStringFormat

        raise InvalidJPLStringFormat(
            f"unknown ephemeris source {source!r} (expected 'analytic:builtin', "
            f"'horizon:NAME' or 'naif:NAME')"
        )

    @classmethod
    def analytic(cls, t_start: float = _ANALYTIC_SPAN[0], t_end: float = _ANALYTIC_SPAN[1]) -> "JPLEphem":
        """Built-in analytic source (cached on disk after first build)."""
        import numpy as np

        cache_dir = os.environ.get(
            "OUTFIT_EPHEM_DIR", os.path.expanduser("~/.cache/outfit_tpu")
        )
        cache = os.path.join(cache_dir, f"analytic_{t_start:.0f}_{t_end:.0f}.npz")
        if os.path.exists(cache):
            data = np.load(cache)
            tables = {}
            for body in Body:
                key = f"coeffs_{int(body)}"
                if key in data:
                    tables[Body(body)] = BodyTable(
                        float(data[f"t0_{int(body)}"]),
                        float(data[f"gran_{int(body)}"]),
                        data[key],
                    )
            return cls(tables, kind="analytic")
        tables = build_analytic_tables(t_start, t_end)
        try:
            os.makedirs(cache_dir, exist_ok=True)
            payload = {}
            for body, tb in tables.items():
                import numpy as np

                payload[f"coeffs_{int(body)}"] = np.asarray(tb.coeffs)
                payload[f"t0_{int(body)}"] = tb.t0
                payload[f"gran_{int(body)}"] = tb.granule_days
            np.savez(cache, **payload)
        except OSError:
            pass
        return cls(tables, kind="analytic")

    # -- queries (batched, jit-compatible) ------------------------------------

    def _interp(self, body: Body, mjd_tt, velocity=True):
        return interpolate_body(self.tables[body], mjd_tt, velocity)

    def _sun(self, mjd_tt, velocity=True):
        if Body.SUN in self.tables:
            return self._interp(Body.SUN, mjd_tt, velocity)
        return 0.0, (0.0 if velocity else None)

    def _moon_embrel(self, mjd_tt, velocity=True):
        """Moon state relative to the EMB, normalizing the per-backend table
        semantics: NAIF SPK segment (301 rel 3) is ALREADY Moon-rel-EMB,
        while Horizon body 9 / the analytic source store the GEOCENTRIC Moon
        (moon_rel_emb = moon_geo * (1 - f), f = 1/(1+EMRAT))."""
        moon_p, moon_v = self._interp(Body.MOON, mjd_tt, velocity)
        if self.kind == "naif":
            return moon_p, moon_v
        s = 1.0 - 1.0 / (1.0 + self.emrat)
        return moon_p * s, (moon_v * s if velocity else None)

    def earth_ephemeris(self, mjd_tt, velocity: bool = True):
        """True-Earth heliocentric state, equatorial J2000 (AU, AU/day).

        Parity: ``earth_ephemeris`` (mod.rs:145-174) Horizon semantics
        (Earth = EMB - Moon/(1+EMRAT), minus Sun) for every backend.
        """
        emb_p, emb_v = self._interp(Body.EMB, mjd_tt, velocity)
        sun_p, sun_v = self._sun(mjd_tt, velocity)
        if Body.EARTH in self.tables:  # NAIF Earth-rel-EMB segment
            off_p, off_v = self._interp(Body.EARTH, mjd_tt, velocity)
            pos = emb_p + off_p - sun_p
            vel = emb_v + off_v - sun_v if velocity else None
        else:
            # Earth = EMB - moon_rel_emb / EMRAT  (mass-ratio barycenter)
            moon_p, moon_v = self._moon_embrel(mjd_tt, velocity)
            pos = emb_p - moon_p / self.emrat - sun_p
            vel = emb_v - moon_v / self.emrat - sun_v if velocity else None
        return pos, vel

    def body_ephemeris(self, body: Body, mjd_tt):
        """Heliocentric state of a perturbing body (AU, AU/day).

        Parity: ``body_ephemeris`` (mod.rs:203-245); EMB maps to the
        Earth-Moon barycenter; Body.EARTH/MOON resolve the true bodies.
        """
        body = Body(body)
        sun_p, sun_v = self._sun(mjd_tt, True)
        if body == Body.SUN:
            import jax.numpy as jnp

            z = jnp.zeros(jnp.shape(jnp.asarray(mjd_tt)) + (3,))
            return z, z
        if body == Body.EARTH:
            return self.earth_ephemeris(mjd_tt, True)
        if body == Body.MOON:
            # heliocentric Moon = EMB + moon_rel_emb; _moon_embrel normalizes
            # the backend table semantics (NAIF 301-rel-3 is already EMB-
            # relative — applying the geocentric (1-f) factor to it put the
            # Moon ~4,600 km off on that backend)
            emb_p, emb_v = self._interp(Body.EMB, mjd_tt, True)
            moon_p, moon_v = self._moon_embrel(mjd_tt, True)
            return emb_p + moon_p - sun_p, emb_v + moon_v - sun_v
        pos, vel = self._interp(body, mjd_tt, True)
        return pos - sun_p, vel - sun_v

    @property
    def coverage(self):
        t0 = max(t.t0 for t in self.tables.values())
        t1 = min(t.t_end for t in self.tables.values())
        return t0, t1


def _resolve_local_file(scheme: str, name: str) -> str:
    """Find a local ephemeris binary.

    Precedence: explicit $OUTFIT_EPHEM_DIR candidates (pre-resolver layout,
    kept for compatibility), then the reference-parity resolver — the OS
    cache path ``<cache root>/outfit_cache/jpl_ephem/...`` with a download
    attempt on miss that degrades gracefully to ``JPLFileNotFound`` in
    zero-egress environments (resolver.py; download_jpl_file.rs:286-305)."""
    base = os.environ.get("OUTFIT_EPHEM_DIR", os.path.expanduser("~/.cache/outfit_tpu"))
    candidates = {
        ("horizon", "DE440"): ["linux_p1550p2650.440", "de440.bin", "DE440.bsp"],
        ("naif", "DE440"): ["de440.bsp", "de440s.bsp"],
    }.get((scheme, name), [name])
    for c in candidates:
        p = os.path.join(base, scheme, c)
        if os.path.exists(p):
            return p
        p = os.path.join(base, c)
        if os.path.exists(p):
            return p
    from outfit_tpu.ephem.resolver import resolve_ephemeris_file

    return resolve_ephemeris_file(f"{scheme}:{name}")
