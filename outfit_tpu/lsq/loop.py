"""Nested Newton / outlier-rejection loops, batched over trajectories.

Behavioral parity with ``run_differential_correction``
(``diff_cor.rs:282-430``): the inner Newton loop with inversion / bizarre /
divergence / stagnation / convergence checks in the reference's exact order,
the outer projection-based chi-squared outlier-rejection loop
(``outlier_rejection.rs:118-227``) with its skip conditions, and the final
covariance rescale (``least_square.rs:371-391``).

Every trajectory carries its own loop-state lanes; terminal failures are
status codes (errors-as-data), frozen in place while other trajectories
continue.  The inner loop is a ``lax.while_loop`` (exits when every
trajectory's inner phase is done), the outer a fixed-trip ``fori``.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from outfit_tpu.elements.types import EquinoctialElements, is_bizarre
from outfit_tpu.lsq.config import DifferentialCorrectionConfig
from outfit_tpu.lsq.iteration import (
    SEL_ACTIVE,
    SEL_FORCED_OUT,
    SEL_REJECTED,
    ObsArrays,
    single_iteration,
)

_BIG = jnp.finfo(jnp.float64).max

STATUS_RUNNING = 0
STATUS_OK = 1
STATUS_BIZARRE = 2
STATUS_DIVERGED = 3
STATUS_INVERSION_FAILED = 4


class DiffCorResult(NamedTuple):
    elements: jnp.ndarray  # (T, 6) final equinoctial vector (ecliptic)
    status: jnp.ndarray  # (T,) STATUS_*
    normalised_rms: jnp.ndarray  # (T,)
    covariance: jnp.ndarray  # (T, 6, 6) rescaled
    normal_matrix: jnp.ndarray  # (T, 6, 6) rescaled
    selection: jnp.ndarray  # (T, N) final selection codes
    num_measurements: jnp.ndarray  # (T,)
    total_newton_iterations: jnp.ndarray  # (T,)


def _elements_bizarre(vec, limits):
    eq = EquinoctialElements(
        jnp.zeros(vec.shape[:-1]),
        vec[..., 0], vec[..., 1], vec[..., 2], vec[..., 3], vec[..., 4], vec[..., 5],
    )
    return is_bizarre(eq, limits)


def _prewarm_f32(elements0, epoch, obs, cfg, selection0, free, ephem):
    """f32 Newton pre-warm (mixed precision): iterate the fit at native f32
    rate until the correction norm reaches the f32 floor, with guarded
    advances only (a step is taken only if the inversion succeeded and the
    result is non-bizarre).  No statuses, no outlier decisions — the f64
    main loop owns all contracts; this phase only moves the starting point
    close to the chi-squared minimum so the f64 loop needs 2-3 iterations
    instead of ~10.  Returns (elements_f64, iterations_used)."""
    T = obs.mjd.shape[0]
    obs32 = ObsArrays(
        obs.mjd,  # absolute epochs stay f64 (f32 resolution is ~6 min)
        obs.ra.astype(jnp.float32),
        obs.dec.astype(jnp.float32),
        obs.sigma_ra.astype(jnp.float32),
        obs.sigma_dec.astype(jnp.float32),
        obs.helio_pos.astype(jnp.float32),
        obs.valid,
        # keep the catalog debiasing in the pre-warm: without it the f32
        # phase converges to the *biased* optimum and the f64 loop must
        # walk the elements back
        bias_ra=None if obs.bias_ra is None else obs.bias_ra.astype(jnp.float32),
        bias_dec=None if obs.bias_dec is None else obs.bias_dec.astype(jnp.float32),
    )
    # the correction norm is sigma-weighted (sqrt(dx^T N dx), N ~ 1/sigma^2),
    # so its f32 noise floor sits around 0.01-0.1: stop on the configured
    # threshold OR when the quadratic decrease plateaus (norm no longer
    # halving — the f32 floor has been hit)
    thr = max(cfg.convergence_threshold, 1e-3)

    def body(carry):
        it, el, prev_norm, done, kep = carry
        res = single_iteration(
            el, epoch, selection0, obs32, free, cfg.propagator, ephem,
            kepler_warm=(kep[..., 0], kep[..., 1], kep[..., 2]),
        )
        sane = (
            res.inversion_ok
            & jnp.isfinite(res.correction_norm)
            & ~_elements_bizarre(res.corrected, cfg.orbital_limits)
        )
        adv = ~done & sane
        el = jnp.where(adv[:, None], res.corrected, el)
        plateau = (it >= 2) & (res.correction_norm >= 0.5 * prev_norm)
        done = done | ~sane | (adv & ((res.correction_norm < thr) | plateau))
        return (
            it + 1, el, jnp.where(adv, res.correction_norm, prev_norm), done,
            res.kepler,
        )

    def cond(carry):
        it, _, _, done, _ = carry
        return (it < cfg.prewarm_max_iterations) & jnp.any(~done)

    el0 = jnp.asarray(elements0, jnp.float32)
    n_it, el, _, _, _ = jax.lax.while_loop(
        cond,
        body,
        (
            jnp.array(0, jnp.int32),
            el0,
            jnp.full(T, jnp.float32(jnp.finfo(jnp.float32).max)),
            jnp.zeros(T, bool),
            jnp.full(obs.mjd.shape + (3,), jnp.nan, jnp.float32),
        ),
    )
    bad = ~jnp.isfinite(el).all(axis=-1)
    el64 = jnp.where(
        bad[:, None], jnp.asarray(elements0, jnp.float64), el.astype(jnp.float64)
    )
    return el64, jnp.broadcast_to(n_it, (T,))


def run_differential_correction(
    elements0,
    epoch,
    obs: ObsArrays,
    cfg: DifferentialCorrectionConfig,
    selection0=None,
    ephem=None,
) -> DiffCorResult:
    """Batched differential correction.

    ``elements0`` (T, 6) equinoctial vectors (ecliptic J2000), ``epoch`` (T,),
    ``obs`` padded observation arrays; ``selection0`` optional initial
    selection codes (default: all valid observations Active).
    """
    if cfg.precision not in ("f64", "mixed"):
        raise ValueError(
            f"DifferentialCorrectionConfig.precision must be 'f64' or 'mixed', got {cfg.precision!r}"
        )
    T, N = obs.mjd.shape
    if selection0 is None:
        selection0 = jnp.where(obs.valid, SEL_ACTIVE, SEL_FORCED_OUT).astype(jnp.int32)

    free = jnp.broadcast_to(jnp.asarray(cfg.free_elements, bool), (6,))

    prewarm_iters = jnp.zeros(T, jnp.int32)
    if cfg.precision == "mixed" and not cfg.propagator.nbody:
        # two-body only: the N-body propagator (DOP853 + STM) is an f64
        # integrator; "mixed" with an N-body propagator simply runs the
        # standard f64 loop (documented in DifferentialCorrectionConfig)
        elements0, prewarm_iters = _prewarm_f32(
            elements0, epoch, obs, cfg, selection0, free, ephem
        )

    class _St(NamedTuple):
        elements: jnp.ndarray
        selection: jnp.ndarray
        status: jnp.ndarray
        # saved from the last advanced Newton step
        last_rms: jnp.ndarray
        last_cov: jnp.ndarray
        last_normal: jnp.ndarray
        last_m: jnp.ndarray
        last_res_ra: jnp.ndarray
        last_res_dec: jnp.ndarray
        last_dra: jnp.ndarray
        last_ddec: jnp.ndarray
        inv_ok_last: jnp.ndarray
        outer_done: jnp.ndarray
        total_newton: jnp.ndarray
        # (T, N, 3) generalized-Kepler (F, sin, cos) of the last evaluation —
        # warm start for the next iteration's solve (NaN = cold start)
        kepler: jnp.ndarray

    st0 = _St(
        elements=jnp.asarray(elements0, jnp.float64),
        selection=selection0,
        status=jnp.zeros(T, jnp.int32),
        last_rms=jnp.full(T, _BIG),
        last_cov=jnp.zeros((T, 6, 6)),
        last_normal=jnp.zeros((T, 6, 6)),
        last_m=jnp.zeros(T, jnp.int32),
        last_res_ra=jnp.zeros((T, N)),
        last_res_dec=jnp.zeros((T, N)),
        last_dra=jnp.zeros((T, N, 6)),
        last_ddec=jnp.zeros((T, N, 6)),
        inv_ok_last=jnp.zeros(T, bool),
        outer_done=jnp.zeros(T, bool),
        total_newton=prewarm_iters,
        kepler=jnp.full((T, N, 3), jnp.nan),
    )

    def inner_loop(st: _St):
        class _In(NamedTuple):
            st: _St
            prev_rms: jnp.ndarray
            stagn: jnp.ndarray
            inner_done: jnp.ndarray
            converged: jnp.ndarray
            it: jnp.ndarray

        running0 = (st.status == STATUS_RUNNING) & ~st.outer_done
        ist0 = _In(
            st,
            jnp.full(T, _BIG),
            jnp.zeros(T, jnp.int32),
            ~running0,
            jnp.zeros(T, bool),
            jnp.array(0),
        )

        def cond(i: _In):
            return (i.it < cfg.max_newton_iterations) & jnp.any(~i.inner_done)

        # mixed mode: f32 Jacobians inside the f64 loop (residuals stay f64;
        # the approximate Jacobian moves the fixed point off the f64
        # optimum by up to ~1e-2 of a formal sigma on ill-conditioned arcs;
        # the final full-f64 linearization refresh below restores exact
        # covariance/partials)
        jac_dtype = (
            jnp.float32
            if (cfg.precision == "mixed" and not cfg.propagator.nbody)
            else None
        )

        def body(i: _In):
            st = i.st
            act = ~i.inner_done
            res = single_iteration(
                st.elements, epoch, st.selection, obs, free, cfg.propagator,
                ephem, jac_dtype,
                kepler_warm=(
                    st.kepler[..., 0], st.kepler[..., 1], st.kepler[..., 2]
                ),
            )

            inv_fail = act & ~res.inversion_ok
            bizarre = (
                act & ~inv_fail & _elements_bizarre(res.corrected, cfg.orbital_limits)
            )
            had_prev = i.prev_rms < _BIG
            diverged = (
                act
                & ~inv_fail
                & ~bizarre
                & had_prev
                & (i.it >= cfg.divergence_grace_iterations)
                & (res.normalised_rms / i.prev_rms >= cfg.rms_divergence_ratio)
            )
            stagnated = (
                act
                & ~inv_fail
                & ~bizarre
                & ~diverged
                & had_prev
                & (res.normalised_rms / i.prev_rms >= cfg.rms_stagnation_ratio)
            )
            stagn = jnp.where(stagnated, i.stagn + 1, 0)
            stagn_break = stagnated & (stagn >= cfg.max_stagnation_iterations)

            advance = act & ~inv_fail & ~bizarre & ~diverged & ~stagn_break
            conv = advance & (res.correction_norm < cfg.convergence_threshold)

            status = jnp.where(
                inv_fail,
                STATUS_INVERSION_FAILED,
                jnp.where(
                    bizarre, STATUS_BIZARRE, jnp.where(diverged, STATUS_DIVERGED, st.status)
                ),
            ).astype(jnp.int32)

            a1 = advance[:, None]
            a2 = advance[:, None, None]
            st = st._replace(
                elements=jnp.where(a1, res.corrected, st.elements),
                status=status,
                last_rms=jnp.where(advance, res.normalised_rms, st.last_rms),
                last_cov=jnp.where(a2, res.covariance, st.last_cov),
                last_normal=jnp.where(a2, res.normal_matrix, st.last_normal),
                last_m=jnp.where(advance, res.num_measurements, st.last_m),
                last_res_ra=jnp.where(a1, res.residual_ra, st.last_res_ra),
                last_res_dec=jnp.where(a1, res.residual_dec, st.last_res_dec),
                last_dra=jnp.where(advance[:, None, None], res.d_ra, st.last_dra),
                last_ddec=jnp.where(advance[:, None, None], res.d_dec, st.last_ddec),
                inv_ok_last=jnp.where(advance, res.inversion_ok, st.inv_ok_last),
                total_newton=st.total_newton + act.astype(jnp.int32),
                # the solution at st.elements is a valid warm start whether or
                # not the step advanced (non-advancing lanes keep elements).
                # Gated on activity: a done lane's re-solve can dither by
                # ~1 ulp per extra trip other lanes force, and the carry
                # feeds the next outer pass and the final f64 refresh —
                # ungated it made results depend on batch composition.
                kepler=jnp.where(act[:, None, None], res.kepler, st.kepler),
            )
            done = i.inner_done | inv_fail | bizarre | diverged | stagn_break | conv
            return _In(
                st,
                jnp.where(advance, res.normalised_rms, i.prev_rms),
                stagn,
                done,
                i.converged | conv,
                i.it + 1,
            )

        out = jax.lax.while_loop(cond, body, ist0)
        return out.st, out.converged

    def outlier_step(st: _St):
        """Projection chi^2 update.  Parity: outlier_rejection.rs:118-227."""
        cov = st.last_cov
        var_ra = obs.sigma_ra**2
        var_dec = obs.sigma_dec**2
        # broadcast-multiply + sum, NOT einsum: batched 6-dim dot_generals
        # lower to padded matrix-unit products (see utils.linalg)
        gca = jnp.sum(cov[:, None] * st.last_dra[..., None, :], -1)
        gcd = jnp.sum(cov[:, None] * st.last_ddec[..., None, :], -1)
        # projection term applies to ACTIVE observations only — for rejected
        # points the reference's zero-partial placeholder reduces V to W^-1
        # (outlier_rejection.rs:135-150 via single_iteration's inactive path)
        was_active = st.selection == SEL_ACTIVE
        wa = was_active.astype(jnp.float64)
        paa = jnp.sum(st.last_dra * gca, axis=-1) * wa
        pdd = jnp.sum(st.last_ddec * gcd, axis=-1) * wa
        pad = jnp.sum(st.last_dra * gcd, axis=-1) * wa
        v00 = var_ra - paa
        v11 = var_dec - pdd
        v01 = -pad
        det = v00 * v11 - v01 * v01
        scale = jnp.maximum(jnp.abs(v00), jnp.abs(v11))
        singular = (jnp.abs(det) < jnp.finfo(jnp.float64).eps * scale**2) | (scale == 0.0)
        det_safe = jnp.where(singular, 1.0, det)
        # chi^2 = xi^T V^-1 xi with analytic 2x2 inverse
        xr, xd = st.last_res_ra, st.last_res_dec
        chi2 = (v11 * xr * xr - 2.0 * v01 * xr * xd + v00 * xd * xd) / det_safe

        sel = st.selection
        reject = (
            (sel == SEL_ACTIVE)
            & ~singular
            & (chi2 > cfg.outlier_rejection.chi_squared_rejection_threshold)
        )
        recover = (
            (sel == SEL_REJECTED)
            & ~singular
            & (chi2 <= cfg.outlier_rejection.chi_squared_recovery_threshold)
        )
        new_sel = jnp.where(
            reject, SEL_REJECTED, jnp.where(recover, SEL_ACTIVE, sel)
        ).astype(jnp.int32)
        changes = jnp.sum((reject | recover) & obs.valid, axis=-1)
        return new_sel, changes

    def outer_body(outer_pass, st: _St):
        st, inner_converged = inner_loop(st)
        running = st.status == STATUS_RUNNING

        if not cfg.enable_outlier_rejection:
            return st._replace(outer_done=st.outer_done | running)

        clean = (
            (outer_pass == 0)
            & (st.last_rms < cfg.convergence_before_rejection_threshold)
        )
        no_conv = ~inner_converged
        done_now = running & ~st.outer_done & (clean | no_conv)

        # the chi^2 projection einsums are only needed for lanes still in
        # play — cond-gate them so settled batches pay nothing
        need = running & ~st.outer_done & ~done_now

        def with_outliers(st):
            new_sel, changes = outlier_step(st)
            sel = jnp.where(need[:, None], new_sel, st.selection)
            stable = need & (changes == 0)
            return st._replace(
                selection=sel,
                outer_done=st.outer_done | done_now | stable,
            )

        def without(st):
            return st._replace(outer_done=st.outer_done | done_now)

        return jax.lax.cond(jnp.any(need), with_outliers, without, st)

    # while-loop outer phase: exits as soon as every trajectory is settled
    # (the reference's per-trajectory `break`; a fixed fori would re-enter
    # the pass body max_outlier_rejection_passes times even when all lanes
    # finished on pass 0-1)
    def outer_cond(carry):
        p, st = carry
        alive = (st.status == STATUS_RUNNING) & ~st.outer_done
        return (p < cfg.max_outlier_rejection_passes + 1) & jnp.any(alive)

    def outer_step(carry):
        p, st = carry
        return p + 1, outer_body(p, st)

    _, st = jax.lax.while_loop(
        outer_cond, outer_step, (jnp.array(0, jnp.int32), st0)
    )

    if cfg.precision == "mixed" and not cfg.propagator.nbody:
        # one full-f64 linearization at the converged elements: refreshes the
        # covariance, normal matrix, residuals, and normalised RMS that were
        # accumulated with f32 Jacobians (elements are not advanced here)
        res = single_iteration(
            st.elements, epoch, st.selection, obs, free, cfg.propagator, ephem,
            kepler_warm=(
                st.kepler[..., 0], st.kepler[..., 1], st.kepler[..., 2]
            ),
        )
        keep = (st.status == STATUS_RUNNING) & res.inversion_ok
        k1 = keep[:, None]
        k2 = keep[:, None, None]
        st = st._replace(
            last_rms=jnp.where(keep, res.normalised_rms, st.last_rms),
            last_cov=jnp.where(k2, res.covariance, st.last_cov),
            last_normal=jnp.where(k2, res.normal_matrix, st.last_normal),
            last_m=jnp.where(keep, res.num_measurements, st.last_m),
            last_res_ra=jnp.where(k1, res.residual_ra, st.last_res_ra),
            last_res_dec=jnp.where(k1, res.residual_dec, st.last_res_dec),
        )

    # final status: running lanes that completed the loops are OK
    status = jnp.where(st.status == STATUS_RUNNING, STATUS_OK, st.status).astype(
        jnp.int32
    )

    # covariance rescale (least_square.rs:371-391)
    n_free = int(sum(cfg.free_elements))
    m = st.last_m
    factor = jnp.sqrt(m / jnp.maximum(m - n_free, 1))
    mu = jnp.where(
        n_free < m,
        jnp.where(st.last_rms > 1.0, st.last_rms * factor, factor),
        1.0,
    )
    mu2 = (mu * mu)[:, None, None]
    cov = st.last_cov * mu2
    normal = st.last_normal / mu2

    rms_out = jnp.where(st.last_rms < _BIG, st.last_rms, jnp.inf)
    return DiffCorResult(
        st.elements, status, rms_out, cov, normal, st.selection, st.last_m,
        st.total_newton,
    )
