"""Universal Kepler solver and two-body propagation, batched and masked.

Behavioral parity with the reference:

* preliminary psi guesses: ``src/kepler/prelim_kepler/prelim_elliptic.rs:72``,
  ``prelim_hyperbolic.rs:47``, ``prelim_parabolic.rs:120`` (Cardano),
* safeguarded Newton: ``src/kepler/newton_solver.rs:151-352`` — residual
  f(psi) = r0*s1 + sig0*s2 + s3 - sqrt(mu)*dt, derivative guard, step clamp
  |step| <= 2*(1+|psi|), sign-change damping, residual/absolute/relative-step
  convergence criteria,
* bracketing fallback: replaces ``brent_dekker_solver.rs`` with a fixed-trip
  expanding-bracket bisection — valid because f'(psi) = r1(psi) > 0 (the
  propagated radius), so f is globally monotone and any sign-changing bracket
  contains the unique root,
* propagation: ``src/kepler/propagation.rs:114-207`` (Lagrange f-g),
* velocity correction: ``src/kepler/velocity.rs:94-209``.

Batch-first design: no early exits — every lane runs the same fixed-trip
loops with convergence masks; failures are status codes, not exceptions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from outfit_tpu.constants import GAUSS_GRAV_SQUARED
from outfit_tpu.kepler.angles import principal_angle
from outfit_tpu.kepler.stumpff import s_funct

# Python floats stay weakly typed in JAX expressions, so these never promote
# f32 lanes to f64 (the kernels are dtype-polymorphic: f64 by default, f32 for
# the mixed-precision fast path).
_EPS = float(jnp.finfo(jnp.float64).eps)


def _feps(x) -> float:
    """Machine epsilon of ``x``'s dtype as a weak Python float."""
    return float(jnp.finfo(jnp.asarray(x).dtype).eps)


def _conv(cfg: "SolverConfig", x) -> float:
    """Effective convergence tolerance: the configured value, floored at
    100*eps of the working dtype (so f32 lanes can actually converge)."""
    return max(cfg.convergency, 100.0 * _feps(x))

# -- status codes (errors-as-data inside batched kernels) --------------------
OK = 0
STATUS_NO_CONVERGENCE = 1
STATUS_DEGENERATE_STATE = 2
STATUS_ECC_REJECTED = 3
STATUS_UNSTABLE_G = 4


@dataclass(frozen=True)
class SolverConfig:
    """Static solver tuning (jit-static).  Parity: ``SolverParams``
    (``src/kepler/params.rs:24-44``) minus the warm-start field, which is a
    runtime array argument here."""

    convergency: float = 100.0 * float(_EPS)
    max_newton: int = 50
    max_iter_prelim: int = 20
    max_bisection: int = 120
    #: run the bracketing fallback on lanes where Newton failed (SolverKind::Auto)
    auto_fallback: bool = True


class KeplerParams(NamedTuple):
    """Batched universal-Kepler inputs (all arrays broadcastable).

    Parity: ``UniversalKeplerParams`` (``src/kepler/params.rs:94-109``);
    alpha is the reciprocal-semi-major-axis convention alpha = -1/a = 2E/mu.
    """

    dt: jnp.ndarray
    r0: jnp.ndarray
    sig0: jnp.ndarray
    mu: jnp.ndarray
    alpha: jnp.ndarray
    e0: jnp.ndarray


class KeplerSolution(NamedTuple):
    psi: jnp.ndarray
    s0: jnp.ndarray
    s1: jnp.ndarray
    s2: jnp.ndarray
    s3: jnp.ndarray
    converged: jnp.ndarray  # bool


# ---------------------------------------------------------------------------
# Preliminary guesses
# ---------------------------------------------------------------------------


def _prelim_elliptic(p: KeplerParams, cfg: SolverConfig):
    """psi guess for alpha < 0.  Parity: ``prelim_elliptic.rs:72-134``."""
    conv = _conv(cfg, p.dt)
    neg_alpha = jnp.maximum(-p.alpha, _EPS)  # safe for inactive lanes
    sqrt_na = jnp.sqrt(neg_alpha)
    a0 = 1.0 / neg_alpha
    n = jnp.sqrt(p.mu) * neg_alpha * sqrt_na  # sqrt(mu) * (-alpha)^{3/2}

    # eccentric anomaly at epoch from geometry
    cos_u0 = (1.0 - p.r0 / a0) / jnp.maximum(p.e0, _EPS)
    u0 = jnp.where(
        jnp.abs(cos_u0) <= 1.0,
        jnp.arccos(jnp.clip(cos_u0, -1.0, 1.0)),
        jnp.where(cos_u0 >= 1.0, 0.0, jnp.pi),
    )
    u0 = jnp.where(p.sig0 < 0.0, -u0, u0)
    u0 = principal_angle(u0)

    ell0 = principal_angle(u0 - p.e0 * jnp.sin(u0))
    target_m = ell0 + n * p.dt  # unwrapped: preserves multi-revolution arcs

    # Newton on Kepler's equation, start u = M (fixed-trip, masked stop)
    def body(_, carry):
        u, done = carry
        res = u - p.e0 * jnp.sin(u) - target_m
        dres = 1.0 - p.e0 * jnp.cos(u)
        step = -res / dres
        un = jnp.where(done, u, u + step)
        done = done | (jnp.abs(step) < conv * 1e3)
        return un, done

    u, _ = jax.lax.fori_loop(
        0, cfg.max_iter_prelim, body, (target_m, jnp.zeros_like(target_m, bool))
    )

    psi = (u - u0) / sqrt_na
    # nearly circular orbit special case
    psi_circ = n * p.dt / sqrt_na
    return jnp.where(p.e0 < conv, psi_circ, psi)


def _prelim_hyperbolic(p: KeplerParams, cfg: SolverConfig):
    """psi guess for alpha > 0.  Parity: ``prelim_hyperbolic.rs:47-140``."""
    conv = _conv(cfg, p.dt)
    alpha = jnp.maximum(p.alpha, _EPS)
    sqrt_a = jnp.sqrt(alpha)
    a0 = -1.0 / alpha
    n = jnp.sqrt(p.mu) * alpha * sqrt_a

    cosh_f0 = (1.0 - p.r0 / a0) / jnp.maximum(p.e0, _EPS)
    f0 = jnp.where(
        cosh_f0 > 1.0,
        jnp.log(jnp.maximum(cosh_f0, 1.0) + jnp.sqrt(jnp.maximum(cosh_f0 * cosh_f0 - 1.0, 0.0))),
        0.0,
    )
    f0 = jnp.where(p.sig0 < 0.0, -f0, f0)

    ell0 = p.e0 * jnp.sinh(f0) - f0
    target_m = ell0 + n * p.dt

    # Damped Newton on e*sinh(F) - F = M, start F = 0, with the reference's
    # halving safeguards (cross-zero damping, |F| >= 15 reduction).
    def body(_, carry):
        f, done = carry
        small = jnp.abs(f) < 15.0
        fs = jnp.clip(f, -15.0, 15.0)  # keep sinh finite in inactive math
        res = p.e0 * jnp.sinh(fs) - fs - target_m
        dres = p.e0 * jnp.cosh(fs) - 1.0
        step = -res / jnp.where(jnp.abs(dres) > _EPS, dres, _EPS)
        cand = f + step
        newton_f = jnp.where(f * cand < 0.0, 0.5 * f, cand)
        fn = jnp.where(small, newton_f, 0.5 * f)
        fn = jnp.where(done, f, fn)
        # step-size criterion, matching the elliptic branch (|iterate| would
        # freeze near F=0 and never engage at the common |F|>>conv roots)
        done = done | (jnp.abs(fn - f) < conv * 1e3)
        return fn, done

    f, _ = jax.lax.fori_loop(
        0, cfg.max_iter_prelim, body, (jnp.zeros_like(target_m), jnp.zeros_like(target_m, bool))
    )
    return (f - f0) / sqrt_a


def _prelim_parabolic(p: KeplerParams):
    """psi guess for alpha == 0 via Cardano on Barker's cubic.

    Parity: ``prelim_parabolic.rs:264-380`` (Cardano + 2 Newton polish steps,
    monotonic-branch root selection :438-478).
    """
    smdt = jnp.sqrt(p.mu) * p.dt  # scaled time of flight

    # monic cubic psi^3 + b psi^2 + c psi + d = 0  (leading coeff 1/6)
    b = 3.0 * p.sig0
    c = 6.0 * p.r0
    d = -6.0 * smdt
    shift = b / 3.0
    pp = c - b * shift
    qq = 2.0 * shift**3 - c * shift + d

    half_q = qq / 2.0
    disc = half_q * half_q + (pp / 3.0) ** 3

    # single-root branch (disc > 0)
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    root_single = jnp.cbrt(-half_q + sq) + jnp.cbrt(-half_q - sq) - shift

    # three-root branch (disc <= 0): trigonometric form
    pp_safe = jnp.minimum(pp, -_EPS)
    acos_arg = jnp.clip(
        (3.0 * qq) / (2.0 * pp_safe) * jnp.sqrt(-3.0 / pp_safe), -1.0, 1.0
    )
    base = jnp.arccos(acos_arg) / 3.0
    amp = 2.0 * jnp.sqrt(-pp_safe / 3.0)
    roots3 = jnp.stack(
        [
            amp * jnp.cos(base),
            amp * jnp.cos(base - 2.0 * jnp.pi / 3.0),
            amp * jnp.cos(base - 4.0 * jnp.pi / 3.0),
        ],
        axis=-1,
    ) - shift[..., None]

    def cubic(psi):
        res = psi**3 / 6.0 + p.sig0 / 2.0 * psi**2 + p.r0 * psi - smdt
        der = psi**2 / 2.0 + p.sig0 * psi + p.r0
        return res, der

    # select: prefer monotonic branch (f' >= 0), then closest to smdt/r0
    lin_est = smdt / jnp.maximum(p.r0, _EPS)
    der3 = roots3**2 / 2.0 + p.sig0[..., None] * roots3 + p.r0[..., None]
    dist = jnp.abs(roots3 - lin_est[..., None])
    any_mono = jnp.any(der3 >= 0.0, axis=-1)
    penal = jnp.where(
        any_mono[..., None] & (der3 < 0.0), jnp.inf, 0.0
    )
    pick = jnp.argmin(dist + penal, axis=-1)
    root_trig = jnp.take_along_axis(roots3, pick[..., None], axis=-1)[..., 0]

    psi = jnp.where(disc > 0.0, root_single, root_trig)
    # two unguarded Newton polish steps
    for _ in range(2):
        res, der = cubic(psi)
        psi = psi - res / jnp.where(jnp.abs(der) > _EPS, der, _EPS)
    return jnp.where(p.dt == 0.0, 0.0, psi)


def prelim_kepuni(p: KeplerParams, cfg: SolverConfig = SolverConfig()):
    """Initial universal-anomaly guess, dispatched on the sign of alpha.

    Parity: ``UniversalKeplerParams::prelim_kepuni``
    (``src/kepler/params.rs:185-191``).  All three branches are evaluated
    with masked-safe inputs and selected per lane.
    """
    psi_e = _prelim_elliptic(p, cfg)
    psi_h = _prelim_hyperbolic(p, cfg)
    psi_p = _prelim_parabolic(p)
    return jnp.where(p.alpha < 0.0, psi_e, jnp.where(p.alpha > 0.0, psi_h, psi_p))


# ---------------------------------------------------------------------------
# Newton solver + bracketing fallback
# ---------------------------------------------------------------------------


def _residual_and_derivative(psi, p: KeplerParams):
    s0, s1, s2, s3 = s_funct(psi, p.alpha)
    res = p.r0 * s1 + p.sig0 * s2 + s3 - jnp.sqrt(p.mu) * p.dt
    der = p.r0 * s0 + p.sig0 * s1 + s2
    return res, der, (s0, s1, s2, s3)


def _newton(psi0, p: KeplerParams, cfg: SolverConfig):
    """Masked safeguarded Newton with batch-converged early exit.

    Parity: ``run_newton`` (``newton_solver.rs:240-277``); the while_loop
    exits once every lane is done (typically 2-4 iterations warm-started,
    ~10 cold) instead of burning the fixed 50-iteration budget."""
    eps = _feps(p.dt)
    conv = _conv(cfg, p.dt)
    res_tol = 10.0 * eps * (1.0 + jnp.abs(jnp.sqrt(p.mu) * p.dt))

    def body(carry):
        it, psi, done = carry
        psi = jnp.where(jnp.isfinite(psi), psi, 0.5)
        res, der, _ = _residual_and_derivative(psi, p)

        res_ok = jnp.abs(res) <= res_tol
        der_bad = ~jnp.isfinite(der) | (jnp.abs(der) < 10.0 * eps)

        raw = -res / jnp.where(der_bad, 1.0, der)
        mx = 2.0 * (1.0 + jnp.abs(psi))
        step = jnp.clip(raw, -mx, mx)
        cand = psi + step
        cand = jnp.where(cand * psi < 0.0, 0.5 * psi, cand)  # sign-change damping

        new_psi = jnp.where(der_bad, 0.5 * psi, cand)
        # relative step criterion (newton_solver.rs:331-351); the absolute
        # form |step| <= conv is subsumed by conv*(1+|psi|)
        step_conv = (~der_bad) & (jnp.abs(step) <= conv * (1.0 + jnp.abs(new_psi)))

        psi_next = jnp.where(done | res_ok, psi, new_psi)
        done = done | res_ok | step_conv
        return it + 1, psi_next, done

    def cond(carry):
        it, _, done = carry
        return (it < cfg.max_newton) & ~jnp.all(done)

    done0 = jnp.zeros(jnp.shape(psi0), bool)
    _, psi, done = jax.lax.while_loop(
        cond, body, (jnp.array(0, jnp.int32), psi0, done0)
    )
    return psi, done


def _bisection_fallback(psi0, p: KeplerParams, cfg: SolverConfig, need):
    """Expanding-bracket + bisection on lanes where Newton failed.

    f(psi) is monotone increasing (f' = propagated radius r1 > 0), so a
    bracket with a sign change always contains the unique root.  Replaces the
    reference's Brent-Dekker fallback with the same contract (root to
    tolerance) in fixed trip count.
    """
    smdt = jnp.sqrt(p.mu) * p.dt

    def f(psi):
        _, s1, s2, s3 = s_funct(psi, p.alpha)
        return p.r0 * s1 + p.sig0 * s2 + s3 - smdt

    # expand a bracket around the guess
    psi0 = jnp.where(jnp.isfinite(psi0), psi0, 0.0)
    d0 = 1.0 + 0.1 * jnp.abs(psi0)

    def expand(_, carry):
        lo, hi, d, ok = carry
        flo, fhi = f(lo), f(hi)
        ok_now = (flo <= 0.0) & (fhi >= 0.0)
        lo_n = jnp.where(ok | ok_now, lo, jnp.where(flo > 0.0, lo - d, lo))
        hi_n = jnp.where(ok | ok_now, hi, jnp.where(fhi < 0.0, hi + d, hi))
        return lo_n, hi_n, d * 2.0, ok | ok_now

    lo, hi, _, bracketed = jax.lax.fori_loop(
        0, 64, expand, (psi0 - d0, psi0 + d0, d0, jnp.zeros(jnp.shape(psi0), bool))
    )

    def bisect(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        lo_n = jnp.where(fm <= 0.0, mid, lo)
        hi_n = jnp.where(fm <= 0.0, hi, mid)
        return lo_n, hi_n

    lo, hi = jax.lax.fori_loop(0, cfg.max_bisection, bisect, (lo, hi))
    root = 0.5 * (lo + hi)
    return jnp.where(need & bracketed, root, psi0), need & bracketed


def solve_kepuni(
    p: KeplerParams,
    cfg: SolverConfig = SolverConfig(),
    psi_guess=None,
) -> KeplerSolution:
    """Solve the universal Kepler equation for every lane.

    Parity: ``solve_kepuni_with_guess`` + ``SolverKind::Auto`` fallback
    (``newton_solver.rs:151``, ``params.rs:130-142``).  ``psi_guess`` may be
    an array (warm start) or None (use :func:`prelim_kepuni`).
    """
    if psi_guess is None:
        psi0 = prelim_kepuni(p, cfg)
    else:
        psi0 = jnp.broadcast_to(jnp.asarray(psi_guess), jnp.shape(p.dt))

    psi, converged = _newton(psi0, p, cfg)

    if cfg.auto_fallback:
        # run the (expensive) bracketing pass only when some lane failed —
        # lax.cond skips the untaken branch entirely at run time
        def with_fb(args):
            psi, converged = args
            psi_fb, fb_ok = _bisection_fallback(psi0, p, cfg, ~converged)
            return jnp.where(converged, psi, psi_fb), converged | fb_ok

        psi, converged = jax.lax.cond(
            jnp.all(converged), lambda a: a, with_fb, (psi, converged)
        )

    s0, s1, s2, s3 = s_funct(psi, p.alpha)
    return KeplerSolution(psi, s0, s1, s2, s3, converged)


# ---------------------------------------------------------------------------
# Two-body propagation (Lagrange f-g)
# ---------------------------------------------------------------------------


class PropagResult(NamedTuple):
    """Parity: ``UniversalPropagResult`` (``propagation.rs:13-32``)."""

    r1: jnp.ndarray  # (..., 3)
    v1: jnp.ndarray  # (..., 3)
    f_lag: jnp.ndarray
    g_lag: jnp.ndarray
    f_dot: jnp.ndarray
    g_dot: jnp.ndarray
    psi: jnp.ndarray
    status: jnp.ndarray  # int32, OK == 0


def initial_orbital_state(position, velocity, mu=GAUSS_GRAV_SQUARED):
    """(sig0, alpha, e) from a Cartesian state.

    Parity: ``initial_orbital_state`` (``propagation.rs:190-207``).
    """
    r0 = jnp.linalg.norm(position, axis=-1)
    v2 = jnp.sum(velocity * velocity, axis=-1)
    sig0 = jnp.sum(position * velocity, axis=-1) / jnp.sqrt(mu)
    alpha = (v2 - 2.0 * mu / r0) / mu
    h2 = jnp.sum(jnp.cross(position, velocity) ** 2, axis=-1)
    ecc = jnp.sqrt(jnp.maximum(1.0 + alpha * h2 / mu, 0.0))
    return r0, sig0, alpha, ecc


def propagate_universal(
    position,
    velocity,
    t0,
    t1,
    cfg: SolverConfig = SolverConfig(),
    psi_guess=None,
    mu=GAUSS_GRAV_SQUARED,
) -> PropagResult:
    """Propagate Cartesian states with the universal-variable formulation.

    Batched parity with ``propagate_universal`` (``propagation.rs:114-174``):
    position/velocity (..., 3), epochs broadcastable to (...).  Failures are
    reported in ``status``; failed lanes carry their (unreliable) values.
    """
    dtype = jnp.result_type(position, velocity)
    if not jnp.issubdtype(dtype, jnp.floating):
        dtype = jnp.float64
    eps = float(jnp.finfo(dtype).eps)
    position = jnp.asarray(position, dtype)
    velocity = jnp.asarray(velocity, dtype)
    r0, sig0, alpha, ecc = initial_orbital_state(position, velocity, mu)
    dt = (jnp.asarray(t1) - jnp.asarray(t0)).astype(dtype)
    dt = jnp.broadcast_to(dt, r0.shape)

    mu_arr = jnp.broadcast_to(jnp.asarray(mu, dtype), r0.shape)
    params = KeplerParams(dt=dt, r0=r0, sig0=sig0, mu=mu_arr, alpha=alpha, e0=ecc)
    sol = solve_kepuni(params, cfg, psi_guess)

    sqrt_mu = jnp.sqrt(mu_arr)
    r1 = r0 * sol.s0 + sig0 * sol.s1 + sol.s2

    f = 1.0 - sol.s2 / r0
    g = (r0 * sol.s1 + sig0 * sol.s2) / sqrt_mu
    r1_safe = jnp.where(jnp.abs(r1) > eps, r1, 1.0)
    f_dot = -(sqrt_mu / (r0 * r1_safe)) * sol.s1
    g_dot = 1.0 - sol.s2 / r1_safe

    pos1 = f[..., None] * position + g[..., None] * velocity
    vel1 = f_dot[..., None] * position + g_dot[..., None] * velocity

    status = jnp.where(
        r0 < eps,
        STATUS_DEGENERATE_STATE,
        jnp.where(
            ~sol.converged,
            STATUS_NO_CONVERGENCE,
            jnp.where(r1 < eps, STATUS_DEGENERATE_STATE, OK),
        ),
    ).astype(jnp.int32)

    return PropagResult(pos1, vel1, f, g, f_dot, g_dot, sol.psi, status)


# ---------------------------------------------------------------------------
# Lagrange f-g velocity correction
# ---------------------------------------------------------------------------


class VelocityCorrection(NamedTuple):
    v2_corrected: jnp.ndarray  # (..., 3)
    f: jnp.ndarray
    g: jnp.ndarray
    psi: jnp.ndarray
    status: jnp.ndarray


def velocity_correction(
    x1,
    x2,
    v2,
    dt,
    peri_max,
    ecc_max,
    chi_guess=None,
    eps=1e3 * float(_EPS),
    cfg: SolverConfig | None = None,
) -> VelocityCorrection:
    """Refine v2 from two positions via Lagrange f-g.

    Batched parity with ``velocity_correction_with_guess``
    (``src/kepler/velocity.rs:94-209``): solves the universal Kepler equation
    from the state at t2 over dt, then v2' = (x1 - f*x2)/g with
    f = 1 - s2/r2, g = dt - s3/sqrt(mu).  Degenerate angular momentum,
    non-convergence, and unstable g are reported via ``status``.

    NOTE: the reference DISCARDS the eccentricity-control acceptance flag
    here (velocity.rs:112-117 destructures ``(_, ecc, _, energy)``) — the
    peri_max/ecc_max bounds only shape ecc/energy extraction, they do NOT
    reject; dynamic acceptability of the corrected state is enforced by the
    Gauss loop separately (gauss.rs:1284-1418).  Early versions of this port
    rejected here too, which made the f-g correction stricter than the
    reference.
    """
    from outfit_tpu.elements.orb_elem import eccentricity_control

    if cfg is None:
        cfg = SolverConfig(convergency=eps)
    dtype = jnp.result_type(x1, x2, v2)
    if not jnp.issubdtype(dtype, jnp.floating):
        dtype = jnp.float64
    deps = float(jnp.finfo(dtype).eps)
    x1 = jnp.asarray(x1, dtype)
    x2 = jnp.asarray(x2, dtype)
    v2 = jnp.asarray(v2, dtype)

    mu = GAUSS_GRAV_SQUARED
    r2 = jnp.linalg.norm(x2, axis=-1)
    sig2 = jnp.sum(x2 * v2, axis=-1) / jnp.sqrt(mu)

    h = jnp.cross(x2, v2)
    h_norm = jnp.linalg.norm(h, axis=-1)
    # absolute guard (velocity.rs:118): 1e6*eps(f64) ~ 2.2e-10 — a physical
    # angular momentum in Gaussian units is ~1e-2, so this must NOT scale
    # with the working dtype (1e6*eps(f32) would reject every real orbit)
    degenerate = ~jnp.isfinite(h_norm) | (h_norm <= 1e6 * _EPS)

    _accepted, ecc, _q, energy = eccentricity_control(x2, v2, peri_max, ecc_max)

    dt = jnp.broadcast_to(jnp.asarray(dt, dtype), r2.shape)
    params = KeplerParams(
        dt=dt,
        r0=r2,
        sig0=sig2,
        mu=jnp.broadcast_to(jnp.asarray(mu), r2.shape),
        alpha=2.0 * energy / mu,
        e0=ecc,
    )
    sol = solve_kepuni(params, cfg, chi_guess)

    f = 1.0 - sol.s2 / r2
    g = dt - sol.s3 / jnp.sqrt(mu)

    g_min = 100.0 * deps * (1.0 + jnp.abs(dt))
    g_bad = ~jnp.isfinite(g) | (jnp.abs(g) < g_min)
    g_safe = jnp.where(g_bad, 1.0, g)

    v_corr = (x1 - f[..., None] * x2) / g_safe[..., None]

    status = jnp.where(
        degenerate,
        STATUS_DEGENERATE_STATE,
        jnp.where(
            ~sol.converged,
            STATUS_NO_CONVERGENCE,
            jnp.where(g_bad, STATUS_UNSTABLE_G, OK),
        ),
    ).astype(jnp.int32)

    return VelocityCorrection(v_corr, f, g, sol.psi, status)
