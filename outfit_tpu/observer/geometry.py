"""Observer state geometry (batched, jittable).

Behavioral parity with ``src/observer_extension.rs``:

* ``earth_fixed_position`` (:159-171): parallax constants -> body-fixed AU,
* ``earth_fixed_velocity`` (:173-178): omega_earth x r,
* ``pvobs`` (:180-221): body-fixed state rotated by GAST about Z then by
  rotpn(Equt(of-date) -> Eclm(J2000)) — geocentric ecliptic-J2000 state,
* ``helio_position/velocity`` (:223-255): Earth JPL state (equatorial
  J2000) + rotated geocentric vector.

Our frame matrices are stored passive (see frames.ref_system), so the
chain is applied directly without the reference's transposes (:205-208).
"""

import jax.numpy as jnp
import numpy as np

from outfit_tpu.constants import (
    EARTH_ROTATION,
    ERAU,
    ROT_ECLMJ2000_TO_EQUMJ2000,
)
from outfit_tpu.frames import RefEpoch, RefSystem, equequ, rotmt, rotpn
from outfit_tpu.time import gmst
from outfit_tpu.time.scales import Ut1Provider, tt_mjd_to_utc


def earth_fixed_position(observer):
    """Body-fixed observer position in AU (batched over observer arrays).

    Host-side numpy on purpose: every caller loops over concrete Observer
    objects (catalog floats), and a jnp version costs one device round-trip
    per observer per np.asarray.
    """
    lon = np.asarray(observer.longitude)
    rc = np.asarray(observer.rho_cos_phi)
    rs = np.asarray(observer.rho_sin_phi)
    return np.stack(
        [ERAU * rc * np.cos(lon), ERAU * rc * np.sin(lon), ERAU * rs], axis=-1
    )


def earth_fixed_velocity(observer):
    """Body-fixed velocity from Earth rotation, AU/day (host-side numpy,
    see earth_fixed_position)."""
    r = earth_fixed_position(observer)
    omega = np.asarray(EARTH_ROTATION)
    return np.cross(np.broadcast_to(omega, r.shape), r)


def gast(mjd_tt, ut1: Ut1Provider):
    """Greenwich apparent sidereal time (radians) at TT epochs.

    UT1 resolution is host-side numpy (table interpolation); the returned
    value feeds jittable code.  Parity: pvobs :189-195.
    """
    tut = ut1.tt_mjd_to_ut1(np.asarray(mjd_tt))
    return gmst(jnp.asarray(tut)) + equequ(jnp.asarray(mjd_tt))


def pvobs(mjd_tt, observer_fixed_pos, observer_fixed_vel, gast_rad):
    """Geocentric observer state in ecliptic J2000.

    ``mjd_tt``: (...,) epochs; ``observer_fixed_pos/vel``: (..., 3) per-epoch
    body-fixed states (already gathered per observation); ``gast_rad``: (...,)
    precomputed GAST.  Returns (pos, vel) each (..., 3) in AU, AU/day.
    """
    rot_earth = rotmt(-jnp.asarray(gast_rad), 2)  # body-fixed -> true equator
    rot_frame = rotpn(
        RefSystem.equt(RefEpoch.of_date(jnp.asarray(mjd_tt))),
        RefSystem.eclm(RefEpoch.j2000()),
    )
    from outfit_tpu.utils.linalg import matmul_small

    m = matmul_small(rot_frame, rot_earth)
    dx = jnp.sum(m * observer_fixed_pos[..., None, :], -1)
    dv = jnp.sum(m * observer_fixed_vel[..., None, :], -1)
    return dx, dv


def helio_position(ephem, mjd_tt, geo_pos_ecl):
    """Heliocentric observer position, equatorial mean J2000 (AU)."""
    earth_pos, _ = ephem.earth_ephemeris(jnp.asarray(mjd_tt), velocity=False)
    rot = jnp.asarray(ROT_ECLMJ2000_TO_EQUMJ2000)
    return earth_pos + jnp.sum(rot * geo_pos_ecl[..., None, :], -1)


def helio_velocity(ephem, mjd_tt, geo_vel_ecl):
    """Heliocentric observer velocity, equatorial mean J2000 (AU/day)."""
    _, earth_vel = ephem.earth_ephemeris(jnp.asarray(mjd_tt), velocity=True)
    rot = jnp.asarray(ROT_ECLMJ2000_TO_EQUMJ2000)
    return earth_vel + jnp.sum(rot * geo_vel_ecl[..., None, :], -1)
