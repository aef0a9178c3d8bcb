"""N-body propagation of equinoctial elements with STM-propagated Jacobians.

Behavioral parity with ``EquinoctialElements::propagate_nbody``
(``equinoctial_element.rs:908-968``) and the dynamics of
``src/propagator/nbody.rs``:

* 42-component augmented state [r, v, Phi(6x6)] in the ecliptic J2000
  heliocentric frame,
* Newtonian perturber accelerations with the Sun's direct term providing
  the Keplerian central force; perturber positions FROZEN at t0 by default
  (nbody.rs:73-87 snapshot semantics) or, with
  ``NBodyConfig(frozen_perturbers=False)``, interpolated from the ephemeris
  tables at every integrator stage time (an extension over the reference —
  removes the ~30-day arc-length accuracy limit of the snapshot),
* variational equations dPhi/dt = A Phi, A = [[0, I], [da/dr, 0]],
* element Jacobians J(t1) = Phi(t1) @ J0 with J0 from the analytic
  two-body Jacobians at t0,
* dt < 1e-14 short-circuit.

Two deliberate corrections vs the reference (both dormant there because its
N-body oracles are self-generated):

1. indirect term sign: the heliocentric frame correction is
   a_ind = -GM_i r_i/|r_i|^3 (the reference adds +GM_i r_i/|r_i|^3,
   nbody.rs:139-147 — opposite to the standard heliocentric EOM),
2. perturber frame: JPL states are equatorial J2000 and are rotated into
   the ecliptic integration frame here (the reference feeds them in
   unrotated, build_perturber_snapshots).
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from outfit_tpu.constants import ROT_EQUMJ2000_TO_ECLMJ2000
from outfit_tpu.elements.twobody import propagate_twobody
from outfit_tpu.elements.types import EquinoctialElements
from outfit_tpu.ephem.bodies import Body, gm_au3_day2
from outfit_tpu.propagator.config import NBodyConfig
from outfit_tpu.propagator.dop853 import dop853_integrate


class NBodyResult(NamedTuple):
    position: jnp.ndarray  # (..., 3) ecliptic J2000, AU
    velocity: jnp.ndarray  # (..., 3) AU/day
    dpos_delem: jnp.ndarray  # (..., 6, 3)
    dvel_delem: jnp.ndarray  # (..., 6, 3)
    status: jnp.ndarray  # 0 ok
    n_steps: jnp.ndarray  # accepted DOP853 steps per lane (bench metric)


def _perturber_gms(config: NBodyConfig) -> jnp.ndarray:
    gms = []
    for b in config.perturbing_bodies:
        body = Body(b)
        gm = gm_au3_day2(body)
        if gm is None:
            raise ValueError(f"no GM for perturbing body {body!r}")
        gms.append(gm)
    return jnp.asarray(np.array(gms))


def _perturber_positions(ephem, config: NBodyConfig, t_mjd):
    """Heliocentric ECLIPTIC perturber positions at epoch(s) ``t_mjd``.

    ``t_mjd`` may be batched (...,); returns (..., P, 3).  Traceable: the
    ephemeris table lookup is a gather+dot, so this can run inside the
    integrator's jitted right-hand side.
    """
    rot = jnp.asarray(ROT_EQUMJ2000_TO_ECLMJ2000)
    positions = []
    for b in config.perturbing_bodies:
        body = Body(b)
        if body == Body.SUN:
            p = jnp.zeros(jnp.shape(jnp.asarray(t_mjd)) + (3,))
        else:
            p_equ, _ = ephem.body_ephemeris(body, t_mjd)
            p = jnp.sum(rot * p_equ[..., None, :], -1)
        positions.append(p)
    return jnp.stack(positions, axis=-2)


def perturber_snapshots(ephem, config: NBodyConfig, t0_mjd):
    """Heliocentric ECLIPTIC positions + GMs of the perturbers at epoch t0.

    ``t0_mjd`` may be batched (...,); returns (pos (..., P, 3), gm (P,)).
    """
    return _perturber_positions(ephem, config, t0_mjd), _perturber_gms(config)


def _acceleration_and_gradient(r, pert_pos, gm):
    """Total heliocentric acceleration + gravity gradient da/dr.

    r (..., 3); pert_pos (..., P, 3); gm (P,).  Sun lanes (|r_i| ~ 0) skip
    the indirect term (nbody.rs:156-163 guard).
    """
    d = r[..., None, :] - pert_pos  # (..., P, 3)
    d2 = jnp.sum(d * d, axis=-1)
    dn = jnp.sqrt(d2)
    dm3 = 1.0 / (d2 * dn)
    # contractions over the (small) perturber axis are broadcast-multiply +
    # sum, not einsum — tiny-dim dot_generals lower to padded matrix-unit
    # products (see utils.linalg.matvec_small)
    acc_direct = -jnp.sum((gm * dm3)[..., None] * d, axis=-2)

    rp2 = jnp.sum(pert_pos * pert_pos, axis=-1)
    rpn = jnp.sqrt(rp2)
    is_sun = rpn <= 1e-10
    rpm3 = jnp.where(is_sun, 0.0, 1.0 / jnp.where(is_sun, 1.0, rp2 * rpn))
    # correct heliocentric indirect term: -GM_i r_i / |r_i|^3
    acc_indirect = -jnp.sum((gm * rpm3)[..., None] * pert_pos, axis=-2)

    eye = jnp.eye(3)
    dm5 = dm3 / d2
    w = gm * 3.0 * dm5  # (..., P)
    grad = jnp.sum(
        w[..., None, None] * d[..., :, None] * d[..., None, :], axis=-3
    ) - jnp.sum(gm * dm3, axis=-1)[..., None, None] * eye
    return acc_direct + acc_indirect, grad


def propagate_nbody(
    eq: EquinoctialElements,
    t1_mjd_tt,
    ephem,
    config: NBodyConfig = NBodyConfig(),
) -> NBodyResult:
    """Propagate equinoctial elements under N-body dynamics with Jacobians.

    Batched over the elements' leading shape; ``t1`` broadcastable.
    """
    t0r = jnp.asarray(eq.reference_epoch, jnp.float64)
    t1r = jnp.asarray(t1_mjd_tt, jnp.float64)
    batch = jnp.broadcast_shapes(jnp.shape(t0r), jnp.shape(t1r))
    t0 = jnp.broadcast_to(t0r, batch)
    t1 = jnp.broadcast_to(t1r, batch)
    eq = EquinoctialElements(*[jnp.broadcast_to(f, batch) for f in eq])

    # initial state + analytic element Jacobians at t0
    init = propagate_twobody(eq, 0.0, 0.0, compute_derivatives=True)
    j0 = jnp.concatenate([init.dpos_delem, init.dvel_delem], axis=-1)  # (...,6,6)
    # rows = elements, cols = (pos, vel); STM right-multiplies J0^T

    gm = _perturber_gms(config)
    if config.frozen_perturbers:
        # reference snapshot semantics (nbody.rs:73-87): positions at t0,
        # accurate for arcs of up to ~30 days
        pert_pos = _perturber_positions(ephem, config, t0)

    phi0 = jnp.broadcast_to(jnp.eye(6).reshape(36), batch + (36,))
    y0 = jnp.concatenate([init.position, init.velocity, phi0], axis=-1)

    def rhs(t, y):
        r = y[..., 0:3]
        v = y[..., 3:6]
        phi = y[..., 6:42].reshape(y.shape[:-1] + (6, 6))
        if config.frozen_perturbers:
            pp = pert_pos
        else:
            # time-varying perturbers: Chebyshev-table lookup at each
            # integration time — extends accuracy to arbitrarily long arcs
            # (an extension over the reference, which only has snapshots)
            pp = _perturber_positions(ephem, config, t)
        acc, grad = _acceleration_and_gradient(r, pp, gm)
        # A = [[0, I], [grad, 0]] exploited structurally: dPhi = A Phi means
        # rows 0-2 of dPhi are Phi rows 3-5, rows 3-5 are grad @ Phi[0:3]
        # (multiply+sum, not einsum — see above)
        dphi_bot = jnp.sum(
            grad[..., :, :, None] * phi[..., None, 0:3, :], axis=-2
        )
        dphi = jnp.concatenate([phi[..., 3:6, :], dphi_bot], axis=-2)
        return jnp.concatenate(
            [v, acc, dphi.reshape(y.shape[:-1] + (36,))], axis=-1
        )

    res = dop853_integrate(
        rhs, y0, t0, t1, rtol=config.rel_tol, atol=config.abs_tol,
        max_steps=config.max_steps,
    )

    pos1 = res.y[..., 0:3]
    vel1 = res.y[..., 3:6]
    phi1 = res.y[..., 6:42].reshape(batch + (6, 6))

    # J(t1) = Phi(t1) @ J0_state, with J0_state (6state x 6elem) = j0^T
    j_state = jnp.sum(
        phi1[..., None, :, :] * j0[..., :, None, :], axis=-1
    )  # (..., 6elem, 6state)
    dpos = j_state[..., 0:3]
    dvel = j_state[..., 3:6]

    # dt ~ 0 short-circuit (parity: equinoctial_element.rs:920-928)
    tiny = jnp.abs(t1 - t0) < 1e-14
    pos1 = jnp.where(tiny[..., None], init.position, pos1)
    vel1 = jnp.where(tiny[..., None], init.velocity, vel1)
    dpos = jnp.where(tiny[..., None, None], init.dpos_delem, dpos)
    dvel = jnp.where(tiny[..., None, None], init.dvel_delem, dvel)
    status = jnp.where(tiny, 0, res.status).astype(jnp.int32)
    n_steps = jnp.where(tiny, 0, res.n_steps).astype(jnp.int32)

    return NBodyResult(pos1, vel1, dpos, dvel, status, n_steps)
