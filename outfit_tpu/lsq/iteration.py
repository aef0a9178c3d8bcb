"""One Newton step of differential correction, batched over trajectories.

Behavioral parity:

* observation partials ``compute_obs_and_partials_2body``
  (``observation_ephemeris.rs:418-450``): two-body propagation with analytic
  6x3 element Jacobians, chain rule through the ecliptic->equatorial rotation
  and the position-dependence of the aberration correction (the reference
  ignores d(vel)/d(elem) inside the aberration term; reproduced),
* residuals with RA wrapping and debiasing (``single_iteration.rs:196-207``),
* ``solve_weighted_least_squares`` (``least_square.rs:225-310``): GtWG normal
  matrix, free-element row/col masking with unit diagonal, Cholesky-or-
  fallback inversion, normalised RMS, correction norm |dx|_C
  (``single_iteration.rs:257-260``).

Shapes: trajectories T, padded observations N.  Selection codes:
0 = Active, 1 = Rejected, 2 = ForcedOut, 3 = padding.
"""

from typing import NamedTuple

import jax.numpy as jnp

from outfit_tpu.constants import DPI, ROT_ECLMJ2000_TO_EQUMJ2000, VLIGHT_AU
from outfit_tpu.elements.twobody import propagate_twobody
from outfit_tpu.elements.types import EquinoctialElements

SEL_ACTIVE = 0
SEL_REJECTED = 1
SEL_FORCED_OUT = 2
SEL_PAD = 3

_EPS = float(jnp.finfo(jnp.float64).eps)


class ObsArrays(NamedTuple):
    """Padded per-trajectory observation data (T, N)."""

    mjd: jnp.ndarray
    ra: jnp.ndarray
    dec: jnp.ndarray
    sigma_ra: jnp.ndarray
    sigma_dec: jnp.ndarray
    helio_pos: jnp.ndarray  # (T, N, 3) observer heliocentric, equatorial J2000
    valid: jnp.ndarray  # (T, N) bool: real observation (not padding)
    #: per-observation astrometric bias (radians; e.g. star-catalog
    #: debiasing), subtracted from the residuals — parity with ObsFitData's
    #: bias field (obs_fit_data.rs:29-116, single_iteration.rs:196-207).
    #: None = unbiased (the common case; keeps older callers working).
    bias_ra: jnp.ndarray = None
    bias_dec: jnp.ndarray = None


class IterationResult(NamedTuple):
    corrected: jnp.ndarray  # (T, 6) corrected element vector
    correction_norm: jnp.ndarray  # (T,)
    normalised_rms: jnp.ndarray  # (T,)
    normal_matrix: jnp.ndarray  # (T, 6, 6)
    covariance: jnp.ndarray  # (T, 6, 6)
    inversion_ok: jnp.ndarray  # (T,)
    num_measurements: jnp.ndarray  # (T,) int
    residual_ra: jnp.ndarray  # (T, N)
    residual_dec: jnp.ndarray  # (T, N)
    d_ra: jnp.ndarray  # (T, N, 6)
    d_dec: jnp.ndarray  # (T, N, 6)
    obs_active: jnp.ndarray  # (T, N) bool — actually used this iteration
    kepler: jnp.ndarray  # (T, N, 3) (F, sin F, cos F) — warm start for the
    # next iteration's generalized Kepler solve (NaN on the N-body path)


def observation_partials(
    elements_vec, epoch, obs: ObsArrays, propagator=None, ephem=None,
    jacobian_dtype=None, kepler_warm=None,
):
    """Predicted (RA, Dec) + d/d(elem) for every (trajectory, observation).

    ``elements_vec`` (T, 6) equinoctial in ecliptic J2000; ``epoch`` (T,).
    Returns (ra, dec, d_ra (T,N,6), d_dec (T,N,6), prop_ok (T,N)).

    ``propagator`` selects two-body (default, analytic Jacobians) or N-body
    (DOP853 + STM; parity: ``compute_obs_and_partials_nbody``,
    observation_ephemeris.rs:452-486); N-body needs ``ephem``.

    ``jacobian_dtype=jnp.float32`` (two-body only) evaluates the predicted
    positions in full precision but the 6x3 element Jacobians in f32 —
    Gauss-Newton converges to the residual-defined fixed point with an
    approximate Jacobian, and the Jacobian chain is most of the
    per-iteration f64 arithmetic.
    """
    eq = EquinoctialElements(
        epoch[:, None],
        elements_vec[:, None, 0],
        elements_vec[:, None, 1],
        elements_vec[:, None, 2],
        elements_vec[:, None, 3],
        elements_vec[:, None, 4],
        elements_vec[:, None, 5],
    )
    if propagator is not None and propagator.nbody:
        from outfit_tpu.propagator.nbody import propagate_nbody

        nb = propagate_nbody(eq, obs.mjd, ephem, propagator.config)
        st_pos, st_vel = nb.position, nb.velocity
        st_dpos = nb.dpos_delem
        st_conv = nb.status == 0
        kepler = jnp.full(obs.mjd.shape + (3,), jnp.nan)
    elif jacobian_dtype is not None:
        st_f = propagate_twobody(
            eq, epoch[:, None], obs.mjd, compute_derivatives=False,
            kepler_warm=kepler_warm,
        )
        eq_lo = EquinoctialElements(*(
            f if i == 0 else f.astype(jacobian_dtype) for i, f in enumerate(eq)
        ))  # epoch stays f64 (dt is formed against f64 MJDs inside)
        # the Jacobian pass re-propagates the same elements in f32: reuse the
        # f64 Kepler solution instead of re-solving (the f32 solve's own
        # tolerance is larger than the cast error)
        st_j = propagate_twobody(
            eq_lo, epoch[:, None], obs.mjd, compute_derivatives=True,
            kepler_solution=(
                st_f.anomaly.astype(jacobian_dtype),
                st_f.anomaly_sin.astype(jacobian_dtype),
                st_f.anomaly_cos.astype(jacobian_dtype),
            ),
        )
        st_pos, st_vel = st_f.position, st_f.velocity
        st_dpos = st_j.dpos_delem.astype(st_pos.dtype)
        st_conv = st_f.converged & st_j.converged
        kepler = jnp.stack(
            [st_f.anomaly, st_f.anomaly_sin, st_f.anomaly_cos], axis=-1
        )
    else:
        st = propagate_twobody(
            eq, epoch[:, None], obs.mjd, compute_derivatives=True,
            kepler_warm=kepler_warm,
        )
        st_pos, st_vel, st_dpos, st_conv = (
            st.position, st.velocity, st.dpos_delem, st.converged
        )
        kepler = jnp.stack(
            [st.anomaly, st.anomaly_sin, st.anomaly_cos], axis=-1
        )

    # NOTE every contraction below is written as broadcast-multiply + sum,
    # NOT einsum/@: XLA lowers batched tiny-dim dot_generals (contraction 3
    # or 6) to padded matrix-unit products (see utils.linalg).
    rot = jnp.asarray(ROT_ECLMJ2000_TO_EQUMJ2000, jnp.asarray(st_pos).dtype)
    pos = jnp.sum(rot * st_pos[..., None, :], -1)  # (T, N, 3) equ
    vel = jnp.sum(rot * st_vel[..., None, :], -1)
    dpos = jnp.sum(rot * st_dpos[..., None, :], -1)  # (T, N, 6, 3)

    rel = pos - obs.helio_pos
    rel_norm = jnp.linalg.norm(rel, axis=-1)
    cor = rel - (rel_norm[..., None] / VLIGHT_AU) * vel
    x, y, z = cor[..., 0], cor[..., 1], cor[..., 2]
    rho_xy2 = x * x + y * y
    rho_xy = jnp.sqrt(rho_xy2)
    rho2 = rho_xy2 + z * z
    ra = jnp.arctan2(y, x) % DPI
    dec = jnp.arctan2(z, rho_xy)

    grad_ra = jnp.stack(
        [-y / rho_xy2, x / rho_xy2, jnp.zeros_like(x)], axis=-1
    )
    grad_dec = jnp.stack(
        [-z * x / (rho_xy * rho2), -z * y / (rho_xy * rho2), rho_xy / rho2],
        axis=-1,
    )
    ab = 1.0 / (rel_norm * VLIGHT_AU)
    d_ra_d_pos = grad_ra - (jnp.sum(grad_ra * vel, axis=-1) * ab)[..., None] * rel
    d_dec_d_pos = grad_dec - (jnp.sum(grad_dec * vel, axis=-1) * ab)[..., None] * rel

    d_ra = jnp.sum(dpos * d_ra_d_pos[..., None, :], -1)  # (T, N, 6)
    d_dec = jnp.sum(dpos * d_dec_d_pos[..., None, :], -1)

    prop_ok = st_conv & jnp.isfinite(ra) & jnp.isfinite(dec)
    return ra, dec, d_ra, d_dec, prop_ok, kepler


def _angular_diff(obs, calc):
    """(obs - calc) wrapped to (-pi, pi].  Parity: least_square.rs:188-199."""
    d = (obs - calc) % DPI
    return jnp.where(d > jnp.pi, d - DPI, d)


def single_iteration(
    elements_vec,
    epoch,
    selection,
    obs: ObsArrays,
    free_elements,
    propagator=None,
    ephem=None,
    jacobian_dtype=None,
    kepler_warm=None,
) -> IterationResult:
    """One batched Newton step.  Parity: ``single_iteration`` (:140-300)."""
    ra_c, dec_c, d_ra, d_dec, prop_ok, kepler = observation_partials(
        elements_vec, epoch, obs, propagator, ephem, jacobian_dtype, kepler_warm
    )

    active = (selection == SEL_ACTIVE) & obs.valid & prop_ok
    usable = obs.valid & prop_ok  # residuals/partials kept for rejected
    # observations too so the outlier step evaluates chi^2 against the
    # CURRENT orbit (the reference keeps stale rejection-time residuals for
    # rejected points, single_iteration.rs:73-85 — current-orbit residuals
    # make recovery behave as intended and are strictly more accurate)

    # debiased residuals (single_iteration.rs:196-207): the catalog bias is
    # subtracted from the observed angles before differencing
    obs_ra = obs.ra if obs.bias_ra is None else obs.ra - obs.bias_ra
    obs_dec = obs.dec if obs.bias_dec is None else obs.dec - obs.bias_dec
    res_ra = jnp.where(usable, _angular_diff(obs_ra, ra_c), 0.0)
    res_dec = jnp.where(usable, obs_dec - dec_c, 0.0)
    g_ra = jnp.where(usable[..., None], d_ra, 0.0)
    g_dec = jnp.where(usable[..., None], d_dec, 0.0)

    # only ACTIVE observations contribute to the fit (weights masked)
    w_ra = jnp.where(active, 1.0 / obs.sigma_ra**2, 0.0)
    w_dec = jnp.where(active, 1.0 / obs.sigma_dec**2, 0.0)

    gw_ra = g_ra * w_ra[..., None]
    gw_dec = g_dec * w_dec[..., None]
    # (T, N, 6, 1) x (T, N, 1, 6) -> sum over N: elementwise normal matrix
    normal = jnp.sum(
        gw_ra[..., :, None] * g_ra[..., None, :]
        + gw_dec[..., :, None] * g_dec[..., None, :],
        axis=1,
    )
    rhs = jnp.sum(
        gw_ra * res_ra[..., None] + gw_dec * res_dec[..., None], axis=1
    )
    q = jnp.sum(w_ra * res_ra**2 + w_dec * res_dec**2, axis=-1)
    m = (2 * jnp.sum(active, axis=-1)).astype(jnp.int32)

    # free-element mask: zero fixed rows/cols, unit diagonal
    free = jnp.asarray(free_elements, bool)
    fmask = free[:, None] & free[None, :]
    normal = jnp.where(fmask, normal, 0.0) + jnp.diag(
        jnp.where(free, 0.0, 1.0)
    ).astype(normal.dtype)
    rhs = jnp.where(free, rhs, 0.0)

    # inversion via unrolled Cholesky (utils.linalg); the normal matrix is
    # SPD whenever invertible.
    # The reference's QR fallback (least_square.rs:329-341) is deliberately
    # NOT mirrored: see the utils.linalg module docstring for the measured
    # batch-isolation violation it would introduce.
    from outfit_tpu.utils.linalg import cholesky_inverse6

    finite = jnp.isfinite(normal).all(axis=(-1, -2))
    normal_safe = jnp.where(finite[:, None, None], normal, jnp.eye(6, dtype=normal.dtype))
    cov, chol_ok = cholesky_inverse6(normal_safe)
    inv_ok = finite & chol_ok & jnp.isfinite(cov).all(axis=(-1, -2)) & (m >= 1)

    dx = jnp.sum(cov * rhs[:, None, :], -1)
    dx = jnp.where(free, dx, 0.0)
    dx = jnp.where(inv_ok[:, None], dx, 0.0)

    ndx = jnp.sum(normal * dx[:, None, :], -1)
    corr_norm = jnp.sqrt(jnp.maximum(jnp.sum(dx * ndx, -1), 0.0))
    rms = jnp.sqrt(q / jnp.maximum(m, 1))
    rms = jnp.where(m > 0, rms, 0.0)

    corrected = elements_vec + dx
    return IterationResult(
        corrected,
        corr_norm,
        rms,
        normal,
        cov,
        inv_ok,
        m,
        res_ra,
        res_dec,
        g_ra,
        g_dec,
        active,
        kepler,
    )
