"""Two-body propagation of equinoctial elements with analytic Jacobians.

Behavioral parity with ``EquinoctialElements::propagate_twobody``
(``src/orbit_type/equinoctial_element.rs:809-867``):

1. mean motion n = sqrt(mu/a^3); lambda(t1) = lambda0 + n (t1 - t0),
2. generalized Kepler equation F - k sin F + h cos F = lambda(t1), Newton
   from x0 = pi + varpi (tol 100*eps, max 25 iterations, :326-348),
3. position/velocity from the equinoctial (f, g, w) basis (:639-760),
4. optional analytic 6x3 Jacobians d(pos)/d(elem), d(vel)/d(elem)
   (``compute_derivative`` :442-584).

Batched: elements with any leading shape; (t1 - t0) broadcastable.  The
fixed-iteration masked Newton replaces the reference's early-exit loop.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from outfit_tpu.constants import DPI, GAUSS_GRAV_SQUARED
from outfit_tpu.elements.types import EquinoctialElements
from outfit_tpu.kepler.angles import principal_angle

_EPS = float(jnp.finfo(jnp.float64).eps)


class TwoBodyResult(NamedTuple):
    position: jnp.ndarray  # (..., 3)
    velocity: jnp.ndarray  # (..., 3)
    dpos_delem: jnp.ndarray  # (..., 6, 3)
    dvel_delem: jnp.ndarray  # (..., 6, 3)
    converged: jnp.ndarray  # bool
    anomaly: jnp.ndarray  # (...,) generalized eccentric longitude F
    anomaly_sin: jnp.ndarray  # sin F (rotation-carried, ~1 ulp)
    anomaly_cos: jnp.ndarray  # cos F


# Taylor coefficients of sin/cos for the clamped Newton step (|d| <= 1):
# truncation error d^19/19! <= 8.3e-18 (sin), d^20/20! <= 4.2e-19 (cos) —
# below one f64 ulp of the rotation update.
_SIN_C = [
    -1.0 / 6, 1.0 / 120, -1.0 / 5040, 1.0 / 362880, -1.0 / 39916800,
    1.0 / 6227020800, -1.0 / 1307674368000, 1.0 / 355687428096000,
]
_COS_C = [
    -1.0 / 2, 1.0 / 24, -1.0 / 720, 1.0 / 40320, -1.0 / 3628800,
    1.0 / 479001600, -1.0 / 87178291200, 1.0 / 20922789888000,
    -1.0 / 6402373705728000,
]


def _sincos_step(d):
    """sin/cos of a step clamped to |d| <= 1, by Taylor polynomial (Horner).

    ~18 fused mul-adds instead of two f64 transcendentals — the point of
    the rotation-Newton scheme below.
    """
    d2 = d * d
    s = _SIN_C[-1]
    for c in reversed(_SIN_C[:-1]):
        s = s * d2 + c
    s = d * (1.0 + d2 * s)
    c = _COS_C[-1]
    for cc in reversed(_COS_C[:-1]):
        c = c * d2 + cc
    c = 1.0 + d2 * c
    return s, c


def solve_generalized_kepler(
    eq: EquinoctialElements, mean_longitude_t1, max_iter=25, warm=None
):
    """Newton on F - k sin F + h cos F = lambda(t1), x0 = pi + varpi.

    Parity: ``solve_kepler_equation`` (equinoctial_element.rs:326-348), with
    a batch-friendly twist: the iteration is **trig-free**.  (sin F, cos F) are
    carried through the loop and advanced by rotating with the Newton step
    (sin/cos of the clamped step come from a degree-17/18 Taylor polynomial,
    exact to < 1e-17 for |step| <= 1), and the cold start x0 = pi + varpi
    has the closed form (sin, cos)(x0) = (-h/e, -k/e).  The f64 sin/cos
    therefore never runs.  For e < 1 the equation is strictly
    monotone (f' >= 1 - e > 0), so the step-clamped Newton converges
    globally.

    ``warm``: optional (F, sin F, cos F) triple from a previous solve at
    nearby elements (differential-correction iterations); F is remapped into
    the current [varpi, varpi + 2pi) window (sin/cos are 2pi-invariant).
    Non-finite warm entries fall back to the cold start per lane.

    Returns (F, sin F, cos F, converged).
    """
    eps = float(jnp.finfo(jnp.asarray(mean_longitude_t1).dtype).eps)
    tol = 100.0 * eps
    # Residual acceptance: |F - k sinF + h cosF - lam| <= 1e-12 rad is
    # ~1 mm on-orbit at a ~ 2.5 AU — three orders below the reference's
    # 1e-9 propagation contract.  Needed because f64 arithmetic without
    # exact rounding cannot always drive the Newton STEP below
    # 100*eps(f64): the iterate stalls at rounding level (residuals
    # <= 8.5e-14 on the "unconverged" lanes, identical to the converged
    # distribution), and
    # a step-only criterion would flag converged lanes as garbage — which
    # the inf-gated RMS scoring then turns into NoViableOrbit for ~45 %
    # of trajectories.  No-op on f32 (100*eps_f32 >> 1e-12) and on exact
    # CPU f64 (the step test fires first in all but rounding-stall lanes).
    res_tol = 1e-12

    e2 = eq.h**2 + eq.k**2
    circular = e2 <= 100.0 * _EPS
    varpi = jnp.where(circular, 0.0, principal_angle(jnp.arctan2(eq.h, eq.k)))
    inv_e = jnp.where(circular, 0.0, 1.0 / jnp.sqrt(jnp.where(circular, 1.0, e2)))
    # x0 = pi + varpi:  sin(x0) = -sin(varpi) = -h/e,  cos(x0) = -k/e
    f0 = jnp.broadcast_to(jnp.pi + varpi, jnp.shape(mean_longitude_t1))
    s0 = jnp.broadcast_to(-eq.h * inv_e, jnp.shape(mean_longitude_t1))
    c0 = jnp.broadcast_to(jnp.where(circular, -1.0, -eq.k * inv_e),
                          jnp.shape(mean_longitude_t1))
    if warm is not None:
        fw, sw, cw = warm
        ok = jnp.isfinite(fw) & jnp.isfinite(sw) & jnp.isfinite(cw)
        fw_safe = jnp.where(ok, fw, 0.0)
        fw_mapped = varpi + (fw_safe - varpi) % DPI
        f0 = jnp.where(ok, fw_mapped, f0)
        s0 = jnp.where(ok, sw, s0)
        c0 = jnp.where(ok, cw, c0)

    def body(carry):
        it, f, s, c, done = carry
        res = f - eq.k * s + eq.h * c - mean_longitude_t1
        der = 1.0 - eq.k * c - eq.h * s
        raw = -res / jnp.where(jnp.abs(der) > eps, der, eps)
        step = jnp.clip(raw, -1.0, 1.0)
        sd, cd = _sincos_step(step)
        fn = jnp.where(done, f, f + step)
        sn = jnp.where(done, s, s * cd + c * sd)
        cn = jnp.where(done, c, c * cd - s * sd)
        done = done | (jnp.abs(raw) <= tol) | (jnp.abs(res) <= res_tol)
        return it + 1, fn, sn, cn, done

    def cond(carry):
        it, _, _, _, done = carry
        return (it < max_iter) & ~jnp.all(done)

    _, f, s, c, done = jax.lax.while_loop(
        cond,
        body,
        (
            jnp.array(0, jnp.int32),
            f0,
            s0,
            c0,
            jnp.zeros(jnp.shape(mean_longitude_t1), bool),
        ),
    )
    # first-order renormalization of the rotation drift (|1 - (s^2+c^2)| is
    # ~1e-15 after <= max_iter rotations; one step of x *= (3 - n)/2 is exact
    # to O(drift^2))
    scale = 0.5 * (3.0 - (s * s + c * c))
    return f, s * scale, c * scale, done


def propagate_twobody(
    eq: EquinoctialElements,
    t0,
    t1,
    compute_derivatives: bool = True,
    mu: float = GAUSS_GRAV_SQUARED,
    kepler_warm=None,
    kepler_solution=None,
) -> TwoBodyResult:
    """Propagate equinoctial elements to t1 (Cartesian state + partials).

    ``kepler_warm``: optional (F, sin F, cos F) warm start for the
    generalized Kepler solve (see ``solve_generalized_kepler``) — used by
    the differential-correction loop, where successive Newton iterations
    move the elements by <1e-3 and the solve then needs 1-2 steps.

    ``kepler_solution``: optional (F, sin F, cos F) to *skip* the solve
    entirely — used by the mixed-precision Jacobian pass, which re-evaluates
    the same propagation in f32 and can reuse the f64 solution.
    """
    a = eq.semi_major_axis
    h, k, p, q = eq.h, eq.k, eq.p, eq.q
    # Epoch differences are taken at the epochs' own precision (f64 MJDs),
    # THEN cast to the elements' working dtype — f32 cannot hold an absolute
    # MJD to better than ~6 minutes, but holds a day-scale dt to ~1e-5 d.
    dt = jnp.broadcast_to(
        jnp.asarray(t1) - jnp.asarray(t0),
        jnp.broadcast_shapes(jnp.shape(a), jnp.shape(jnp.asarray(t1))),
    )
    wdtype = jnp.result_type(a, h, k)
    if jnp.issubdtype(wdtype, jnp.floating):
        dt = dt.astype(wdtype)

    n = jnp.sqrt(mu / a**3)
    lam1 = eq.mean_longitude + n * dt

    e2 = h * h + k * k
    varpi = jnp.where(e2 > 100.0 * _EPS, principal_angle(jnp.arctan2(h, k)), 0.0)
    lam1 = principal_angle(lam1)
    lam1 = jnp.where(lam1 < varpi, lam1 + DPI, lam1)

    if kepler_solution is not None:
        F, sF, cF = (jnp.broadcast_to(v, jnp.shape(lam1)).astype(wdtype)
                     for v in kepler_solution)
        converged = jnp.isfinite(F) & jnp.isfinite(sF) & jnp.isfinite(cF)
    else:
        F, sF, cF, converged = solve_generalized_kepler(
            eq, lam1, warm=kepler_warm
        )

    # --- in-plane coordinates ------------------------------------------------
    beta = 1.0 / (1.0 + jnp.sqrt(jnp.maximum(1.0 - e2, 0.0)))
    bhk = beta * h * k

    xe = a * ((1.0 - beta * h * h) * cF + bhk * sF - k)
    ye = a * ((1.0 - beta * k * k) * sF + bhk * cF - h)

    u = 1.0 + p * p + q * q
    inv_u = 1.0 / u
    common = 2.0 * p * q * inv_u
    f_vec = jnp.stack(
        [(1.0 - p * p + q * q) * inv_u, common, -2.0 * p * inv_u], axis=-1
    )
    g_vec = jnp.stack(
        [common, (1.0 + p * p - q * q) * inv_u, 2.0 * q * inv_u], axis=-1
    )

    pos = xe[..., None] * f_vec + ye[..., None] * g_vec

    r = jnp.sqrt(xe * xe + ye * ye)
    v_const = n * a * a / r
    v_xe = v_const * (bhk * cF - (1.0 - beta * h * h) * sF)
    v_ye = v_const * ((1.0 - beta * k * k) * cF - bhk * sF)
    vel = v_xe[..., None] * f_vec + v_ye[..., None] * g_vec

    if not compute_derivatives:
        zero = jnp.zeros(pos.shape[:-1] + (6, 3), pos.dtype)
        return TwoBodyResult(pos, vel, zero, zero, converged, F, sF, cF)

    # --- analytic partials (compute_derivative :442-584) ---------------------
    w_vec = jnp.stack(
        [2.0 * p * inv_u, -2.0 * q * inv_u, (1.0 - p * p - q * q) * inv_u],
        axis=-1,
    )
    inv_r = 1.0 / r
    inv_1b = 1.0 / (1.0 - beta)
    b3 = beta**3

    tmp1 = lam1 - F
    tmp2 = beta + h * h * b3 * inv_1b
    tmp3 = h * k * b3 * inv_1b
    tmp4 = beta * h - sF
    tmp5 = beta * k - cF
    tmp6 = beta + k * k * b3 * inv_1b
    tmp7 = 1.0 - r / a
    tmp8 = sF - h
    tmp9 = cF - k
    tmp10 = a * cF * inv_r
    tmp11 = a * sF * inv_r
    tmp12 = n * a * a * inv_r

    dtv = dt

    # position partials
    dpos1 = (pos - 1.5 * vel * dtv[..., None]) / a[..., None]
    dx1 = -a * (tmp1 * tmp2 + a * cF * tmp4 * inv_r)
    dx2 = a * (tmp1 * tmp3 - 1.0 + a * cF * tmp5 * inv_r)
    dpos2 = dx1[..., None] * f_vec + dx2[..., None] * g_vec
    dx1 = -a * (tmp1 * tmp3 + 1.0 - a * sF * tmp4 * inv_r)
    dx2 = a * (tmp1 * tmp6 - a * sF * tmp5 * inv_r)
    dpos3 = dx1[..., None] * f_vec + dx2[..., None] * g_vec
    dpos4 = (
        2.0
        * (q[..., None] * (ye[..., None] * f_vec - xe[..., None] * g_vec)
           - xe[..., None] * w_vec)
        * inv_u[..., None]
    )
    dpos5 = (
        2.0
        * (p[..., None] * (-ye[..., None] * f_vec + xe[..., None] * g_vec)
           + ye[..., None] * w_vec)
        * inv_u[..., None]
    )
    dpos6 = vel / n[..., None]

    # velocity partials
    dvel1 = -(vel - 3.0 * mu * pos * dtv[..., None] / (r**3)[..., None]) / (
        2.0 * a[..., None]
    )
    dv1 = tmp12 * (tmp7 * tmp2 + a * a * tmp8 * tmp4 * inv_r**2 + tmp10 * cF)
    dv2 = -tmp12 * (tmp7 * tmp3 + a * a * tmp8 * tmp5 * inv_r**2 - tmp10 * sF)
    dvel2 = dv1[..., None] * f_vec + dv2[..., None] * g_vec
    dv1 = tmp12 * (tmp7 * tmp3 + a * a * tmp9 * tmp4 * inv_r**2 - tmp11 * cF)
    dv2 = -tmp12 * (tmp7 * tmp6 + a * a * tmp9 * tmp5 * inv_r**2 + tmp11 * sF)
    dvel3 = dv1[..., None] * f_vec + dv2[..., None] * g_vec
    dvel4 = (
        2.0
        * (q[..., None] * (v_ye[..., None] * f_vec - v_xe[..., None] * g_vec)
           - v_xe[..., None] * w_vec)
        * inv_u[..., None]
    )
    dvel5 = (
        2.0
        * (p[..., None] * (-v_ye[..., None] * f_vec + v_xe[..., None] * g_vec)
           + v_ye[..., None] * w_vec)
        * inv_u[..., None]
    )
    dvel6 = -(n * a**3)[..., None] * pos * (inv_r**3)[..., None]

    dpos = jnp.stack([dpos1, dpos2, dpos3, dpos4, dpos5, dpos6], axis=-2)
    dvel = jnp.stack([dvel1, dvel2, dvel3, dvel4, dvel5, dvel6], axis=-2)
    return TwoBodyResult(pos, vel, dpos, dvel, converged, F, sF, cF)
