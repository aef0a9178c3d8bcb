"""Per-dataset precomputed observer state arrays.

Parity: ``src/cache/`` — ``OutfitCache::build`` (mod.rs:144-166) builds,
once per dataset, the per-observer body-fixed cache and the per-observation
geocentric/heliocentric states; accessors are O(1) by observation index
(mod.rs:183-210).  Here the cache IS the device representation: dense
``[n_obs, 3]`` float64 arrays (SURVEY 2.9).
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from outfit_tpu.observer.geometry import (
    earth_fixed_position,
    earth_fixed_velocity,
    gast,
    helio_position,
    helio_velocity,
    pvobs,
)
from outfit_tpu.time.scales import Ut1Provider

def _build_jit_for(ephem, cache_velocity: bool):
    """Compile-cached jitted cache-build compute, stored ON the ephemeris
    object so its lifetime (and the closed-over compiled executables') is
    tied to the ephemeris, not the process — a module-level dict keyed by
    id(ephem) would leak every ephemeris ever used."""
    store = getattr(ephem, "_observer_cache_jit", None)
    if store is None:
        store = {}
        try:
            ephem._observer_cache_jit = store
        except AttributeError:
            pass  # exotic immutable ephem: fall through, re-jit per build
    return store


#: Chebyshev-Lobatto coefficients per frame-table granule
_N_COEFF = 14
#: frame-table granule width (days); a power of two, so the granule index
#: and the local coordinate of an epoch are exact in float64
_GRANULE_DAYS = 8.0
#: most granules in one table; longer spans double the granule width
_MAX_GRANULES = 4096


def _bucket_len(n: int, floor: int = 4) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _frame_table(g0, gran, n_gran):
    """Chebyshev coefficients of the slow frame chain on the absolute
    granules ``[(g0 + i) * gran, (g0 + i + 1) * gran)``, ``i < n_gran``.

    Channels: the 9 components of rotpn(Equt(of-date) -> Eclm(J2000))
    plus the equation of the equinoxes.  Returns (G, 10, C).
    """
    from outfit_tpu.frames import RefEpoch, RefSystem, equequ, rotpn

    C = _N_COEFF
    k = np.arange(C)
    nodes01 = 0.5 * (1.0 - np.cos(np.pi * k / (C - 1)))  # ascending in t
    # node times from the ABSOLUTE granule index: a granule's coefficients
    # do not depend on which granule the table starts at
    g_abs = g0 + jnp.arange(n_gran, dtype=jnp.float64)
    tk = gran * (g_abs[:, None] + jnp.asarray(nodes01)[None, :])
    m_slow = rotpn(
        RefSystem.equt(RefEpoch.of_date(tk)), RefSystem.eclm(RefEpoch.j2000())
    )  # (G, C, 3, 3)
    eqq = equequ(tk)  # (G, C)
    chan = jnp.concatenate(
        [m_slow.reshape(n_gran, C, 9), eqq[..., None]], axis=-1
    )  # (G, C, 10)

    # first-kind Chebyshev-Lobatto fit (static transform; see
    # chebyshev.fit_body_table) — samples flipped to align with
    # x_m = cos(pi m / (C-1))
    T = np.cos(np.pi * np.outer(np.arange(C), k) / (C - 1))
    w = np.ones(C)
    w[0] = w[-1] = 0.5
    scale = np.full(C, 2.0 / (C - 1))
    scale[0] = scale[-1] = 1.0 / (C - 1)
    Tw = jnp.asarray(T * w * scale[:, None])  # (j, m)
    samples = chan[:, ::-1, :]  # (G, m, 10)
    # (G, 10, j) = sum_m Tw[j, m] * samples[g, m, c]  (elementwise contraction)
    coeffs = jnp.sum(
        Tw[None, :, None, :] * jnp.swapaxes(samples, 1, 2)[:, None, :, :],
        axis=-1,
    )  # (G, j, 10) -> transpose to (G, 10, j)
    return jnp.swapaxes(coeffs, 1, 2)


def _frame_interp(coeffs, mjd, g0, gran):
    """Evaluate the frame table at ``mjd``: (M_slow (..., 3, 3), equequ)."""
    n_gran, _, C = coeffs.shape
    x = mjd / gran  # exact: gran is a power of two
    g = jnp.floor(x)
    idx = jnp.clip((g - g0).astype(jnp.int32), 0, n_gran - 1)
    tau = 2.0 * (x - g) - 1.0
    t_prev = jnp.ones_like(tau)
    t_cur = tau
    ts = [t_prev, t_cur]
    for _ in range(2, C):
        t_next = 2.0 * tau * t_cur - t_prev
        ts.append(t_next)
        t_prev, t_cur = t_cur, t_next
    tb = jnp.stack(ts[:C], axis=-1)  # (..., C)
    ch = coeffs[idx]  # (..., 10, C)
    vals = jnp.sum(ch * tb[..., None, :], axis=-1)  # (..., 10)
    m_slow = vals[..., :9].reshape(vals.shape[:-1] + (3, 3))
    return m_slow, vals[..., 9]


def _cache_compute(mjd, tut, fp, fv, g0, gran, ephem, cache_velocity, n_gran):
    from outfit_tpu.frames.ref_system import rotmt
    from outfit_tpu.time import gmst
    from outfit_tpu.utils.linalg import matmul_small

    coeffs = _frame_table(g0, gran, n_gran)
    m_slow, eqq = _frame_interp(coeffs, mjd, g0, gran)
    g = gmst(tut) + eqq
    rot_earth = rotmt(-g, 2)  # body-fixed -> true equator of date
    m = matmul_small(m_slow, rot_earth)
    geo_pos = jnp.sum(m * fp[..., None, :], -1)
    geo_vel = jnp.sum(m * fv[..., None, :], -1)
    if not cache_velocity:
        geo_vel = jnp.zeros_like(geo_vel)
    hp = helio_position(ephem, mjd, geo_pos)
    hv = helio_velocity(ephem, mjd, geo_vel)
    return geo_pos, geo_vel, hp, hv


class ObserverCache(NamedTuple):
    """Dense per-observation observer states.

    geocentric states in ecliptic J2000; heliocentric in equatorial J2000
    (matching the reference's frames, observer_centric_cache.rs:45-91).

    The device arrays are stored PADDED to the power-of-two bucket of the
    observation count (``n`` real rows): slicing them eagerly at build time
    costs one dispatch per array, and the fitting pipelines gather by index
    from the padded base arrays anyway (``device_base_arrays``).  The unpadded views are properties.
    """

    n: int  # real observation count
    mjd_tt: np.ndarray  # (n,) host-resident epochs
    geo_pos_pad: jnp.ndarray  # (nb, 3) AU, padded
    geo_vel_pad: jnp.ndarray  # (nb, 3) AU/day, padded
    helio_pos_pad: jnp.ndarray  # (nb, 3) AU, padded
    helio_vel_pad: jnp.ndarray  # (nb, 3) AU/day, padded

    @property
    def geo_pos_ecl(self):
        return self.geo_pos_pad[: self.n]

    @property
    def geo_vel_ecl(self):
        return self.geo_vel_pad[: self.n]

    @property
    def helio_pos_equ(self):
        return self.helio_pos_pad[: self.n]

    @property
    def helio_vel_equ(self):
        return self.helio_vel_pad[: self.n]

    @classmethod
    def build(cls, dataset, ephem, ut1: Ut1Provider = None, cache_velocity: bool = True):
        """Build from an ObsDataset + ephemeris.  Parity: OutfitCache::build.

        The device compute (GMST/nutation/rotpn chain + ephemeris lookup for
        every observation) runs as ONE jitted call on power-of-two padded
        shapes — eager per-primitive dispatch cost dominated host prep at
        survey scale otherwise.  UT1 table interpolation stays host-side.
        """
        import jax

        if ut1 is None:
            ut1 = Ut1Provider()
        if len(dataset.mjd_tt) == 0:  # no observations (observer list may
            # still be nonempty, e.g. ds.subset([]) copies it wholesale)
            z = jnp.zeros((0, 3))
            return cls(0, jnp.zeros(0), z, z, z, z)
        # per-observer fixed vectors, gathered per observation
        fixed_pos = np.stack(
            [np.asarray(earth_fixed_position(o)) for o in dataset.observers]
        )
        fixed_vel = np.stack(
            [np.asarray(earth_fixed_velocity(o)) for o in dataset.observers]
        )
        oi = np.asarray(dataset.observer_index)

        n = len(dataset.mjd_tt)
        nb = 8
        while nb < n:
            nb *= 2
        pad = nb - n
        mjd_np = np.concatenate([dataset.mjd_tt, np.full(pad, dataset.mjd_tt[0])])
        tut = ut1.tt_mjd_to_ut1(mjd_np)
        # upload the small per-OBSERVER tables + int32 indices; the
        # per-observation gather happens on device (instead of uploading
        # materialized (n, 3) arrays)
        n_ob = _bucket_len(len(dataset.observers))
        fp_tab = np.zeros((n_ob, 3))
        fp_tab[: len(dataset.observers)] = fixed_pos
        fv_tab = np.zeros((n_ob, 3))
        fv_tab[: len(dataset.observers)] = fixed_vel
        oi_pad = np.concatenate([oi, np.zeros(pad, np.int64)]).astype(np.int32)

        # frame table: the slow frame chain (106-term nutation + precession,
        # shortest period 13.7 d) is evaluated at Chebyshev-Lobatto nodes on
        # 8-day granules and interpolated per observation — ~1e-13 matrix
        # accuracy at ~1/150th of the transcendental work.  The granules sit
        # on a FIXED absolute grid (multiples of the granule width), so an
        # observation's frame depends on its own epoch only, never on the
        # other observations of the dataset (batch-isolation contract).  G
        # is bucketed so span never recompiles.
        gran = _GRANULE_DAYS
        lo, hi = float(dataset.mjd_tt.min()), float(dataset.mjd_tt.max())
        while np.floor(hi / gran) - np.floor(lo / gran) + 1 > _MAX_GRANULES:
            gran *= 2.0
        g0 = float(np.floor(lo / gran))
        n_gran = _bucket_len(int(np.floor(hi / gran) - g0) + 1, floor=8)

        store = _build_jit_for(ephem, cache_velocity)
        key = (bool(cache_velocity), n_gran)
        fn = store.get(key)
        if fn is None:
            fn = store[key] = jax.jit(
                lambda times, ftabs, oi, g0, gran: _cache_compute(
                    times[0], times[1], ftabs[0][oi], ftabs[1][oi], g0, gran,
                    ephem, cache_velocity, n_gran
                )
            )

        # batched uploads: each jnp.asarray is a separate transfer
        geo_pos, geo_vel, hp, hv = fn(
            jnp.asarray(np.stack([mjd_np, tut])),
            jnp.asarray(np.stack([fp_tab, fv_tab])),
            jnp.asarray(oi_pad),
            jnp.float64(g0),
            jnp.float64(gran),
        )
        return cls(n, np.asarray(dataset.mjd_tt), geo_pos, geo_vel, hp, hv)
