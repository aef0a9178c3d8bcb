"""Batched Gauss IOD core kernel.

Behavioral parity with ``src/initial_orbit_determination/gauss.rs``:

* ``gauss_prelim`` (:532-549): scaled time intervals, LOS unit matrix + inverse,
* ``coeff_eight_poly`` (:585-614): sparse degree-8 coefficients (c0, c3, c6),
* Descartes prefilter (:214-240, :1130-1135) as a lane mask,
* root solving via batched Aberth (roots.py), filters Re>0, |Im|<eps,
  r2 plausibility window (:1148-1150),
* ``position_vector_and_reference_epoch`` (:702-724) incl. light-time
  correction and the min-rho2 spurious-root rejection,
* ``gibbs_correction`` (:754-781),
* ``accept_root`` (:816-870) with eccentricity control,
* ``pos_and_vel_correction`` (:1284-1418): fixed-trip masked version of the
  two-sided Lagrange f-g refinement with chi warm-starts, averaged
  velocities, C-vector rebuild, dynamic acceptability, Frobenius
  convergence; iteration-level failures skip the commit (the reference's
  ``continue``), hard rejects clear the corrected flag.

Candidate axis: all 8 polynomial roots are carried with validity masks
instead of the reference's first-3-in-discovery-order early exit
(``max_tested_solutions``); selection happens at scoring time
(corrected-preferred, then min RMS), which subsumes the reference's policy.

Lane layout: every array has a leading lane axis L = (triplet x realization);
positions are row-major: ``pos[..., j, :]`` = vector at epoch j.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from outfit_tpu.constants import GAUSS_GRAV, ROT_EQUMJ2000_TO_ECLMJ2000, VLIGHT_AU
from outfit_tpu.elements.orb_elem import ccek1, eccentricity_control
from outfit_tpu.iod.params import IODParams
from outfit_tpu.iod.roots import aberth_deg8, descartes_upper_bound
from outfit_tpu.kepler.universal import SolverConfig, velocity_correction
from outfit_tpu.utils.linalg import matvec_small, rotate3

_EPS = float(jnp.finfo(jnp.float64).eps)


class GaussTriplets(NamedTuple):
    """Batched observation triplets (lane axis L).

    Parity: ``GaussObs`` (gauss.rs:150-157); obs_pos[l, j, :] is the observer
    heliocentric position at epoch j, equatorial J2000, AU.
    """

    ra: jnp.ndarray  # (L, 3) radians
    dec: jnp.ndarray  # (L, 3)
    time: jnp.ndarray  # (L, 3) MJD TT
    obs_pos: jnp.ndarray  # (L, 3, 3)


class GaussCandidates(NamedTuple):
    """Per-(lane, root) candidate states after accept + correction."""

    pos: jnp.ndarray  # (L, K, 3, 3) positions at the three epochs (equ J2000)
    vel: jnp.ndarray  # (L, K, 3) velocity at central epoch
    epoch: jnp.ndarray  # (L, K) light-time-corrected reference epoch (f64)
    valid: jnp.ndarray  # (L, K) accept_root passed
    corrected: jnp.ndarray  # (L, K) f-g correction committed and survived
    chi1: jnp.ndarray  # (L, K) final left universal-anomaly warm start
    chi2: jnp.ndarray  # (L, K) final right universal-anomaly warm start
    r2: jnp.ndarray  # (L, K) the degree-8 root (central heliocentric dist)


def unit_vectors(ra, dec):
    cd = jnp.cos(dec)
    return jnp.stack([cd * jnp.cos(ra), cd * jnp.sin(ra), jnp.sin(dec)], axis=-1)


def _inv3(m):
    """Closed-form batched 3x3 inverse (adjugate / det); returns (inv, det)."""
    a = m
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    adj = jnp.stack(
        [
            jnp.stack([c00, c10, c20], axis=-1),
            jnp.stack([c01, c11, c21], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1),
        ],
        axis=-2,
    )
    tiny = float(jnp.finfo(jnp.asarray(det).dtype).tiny)
    det_safe = jnp.where(jnp.abs(det) > tiny, det, 1.0)
    return adj / det_safe[..., None, None], det


def gauss_prelim(tri: GaussTriplets):
    """tau1/tau3, LOS matrix S (columns = unit vectors), S^-1, a, b vectors.

    The working dtype follows ``tri.ra`` (f32 in the mixed-precision path);
    ``tri.time`` stays f64 — absolute MJDs do not fit in f32 — and only the
    day-scale differences are cast down.
    """
    dtype = jnp.asarray(tri.ra).dtype
    t = tri.time
    tau1 = (GAUSS_GRAV * (t[..., 0] - t[..., 1])).astype(dtype)
    tau3 = (GAUSS_GRAV * (t[..., 2] - t[..., 1])).astype(dtype)
    tau13 = tau3 - tau1
    a = jnp.stack(
        [tau3 / tau13, -jnp.ones_like(tau1), -(tau1 / tau13)], axis=-1
    )
    b = jnp.stack(
        [
            a[..., 0] * (tau13**2 - tau3**2) / 6.0,
            jnp.zeros_like(tau1),
            a[..., 2] * (tau13**2 - tau1**2) / 6.0,
        ],
        axis=-1,
    )
    u = unit_vectors(tri.ra, tri.dec)  # (L, 3epoch, 3coord)
    s_mat = jnp.swapaxes(u, -1, -2)  # columns are unit vectors
    s_inv, det = _inv3(s_mat)
    nonsingular = jnp.abs(det) > 1e2 * float(jnp.finfo(dtype).eps)
    return tau1, tau3, s_mat, s_inv, a, b, u, nonsingular


def coeff_eight_poly(tri: GaussTriplets, s_mat, s_inv, a, b):
    """Sparse coefficients (c0, c3, c6).  Parity: gauss.rs:585-614."""
    # broadcast-multiply + sum, not einsum: tiny-dim dot_generals lower to
    # padded matrix-unit products (see utils.linalg.matvec_small)
    ra_vec = jnp.sum(a[..., None] * tri.obs_pos, axis=-2)
    rb_vec = jnp.sum(b[..., None] * tri.obs_pos, axis=-2)
    row1 = s_inv[..., 1, :]  # second row of S^-1
    a2star = jnp.sum(row1 * ra_vec, axis=-1)
    b2star = jnp.sum(row1 * rb_vec, axis=-1)
    p2 = tri.obs_pos[..., 1, :]
    r22 = jnp.sum(p2 * p2, axis=-1)
    s2 = s_mat[..., :, 1]
    s2r2 = jnp.sum(s2 * p2, axis=-1)
    c6 = -(a2star**2) - r22 - 2.0 * a2star * s2r2
    c3 = -2.0 * b2star * (a2star + s2r2)
    c0 = -(b2star**2)
    return c0, c3, c6


def _positions_from_cvec(tri, s_inv, u, c_vec, min_rho2):
    """rho solve + light-time epoch.  Parity: gauss.rs:702-724.

    c_vec: (..., 3).  Returns (pos (..., 3, 3), epoch, rho2_ok).
    """
    gcap = jnp.sum(c_vec[..., None] * tri.obs_pos, axis=-2)
    crhom = matvec_small(s_inv, gcap)
    rho = -crhom / c_vec
    rho2_ok = rho[..., 1] >= min_rho2
    pos = tri.obs_pos + rho[..., None] * u
    epoch = tri.time[..., 1] - rho[..., 1] / VLIGHT_AU
    return pos, epoch, rho2_ok


def gibbs_velocity(pos, tau1, tau3):
    """Gibbs velocity at the central epoch.  Parity: gauss.rs:754-781."""
    tau13 = tau3 - tau1
    r = jnp.linalg.norm(pos, axis=-1)  # (..., 3)
    rm3 = 1.0 / r**3
    d1 = tau3 * (rm3[..., 0] / 12.0 - 1.0 / (tau1 * tau13))
    d2 = (tau1 + tau3) * (rm3[..., 1] / 12.0 - 1.0 / (tau1 * tau3))
    d3 = -tau1 * (rm3[..., 2] / 12.0 + 1.0 / (tau3 * tau13))
    d = jnp.stack([-d1, d2, d3], axis=-1)
    return GAUSS_GRAV * jnp.sum(d[..., None] * pos, axis=-2)



def _fg_correction(
    tri_b: GaussTriplets,
    s_inv_b,
    u_b,
    dt01,
    dt21,
    pos,
    vel,
    epoch,
    chi1,
    chi2,
    alive0,
    params: IODParams,
    max_it: int,
):
    """Two-sided Lagrange f-g refinement (gauss.rs:1284-1418), shared by the
    main kernel (per-candidate axis) and the f64 polish pass (selected
    candidate only).  ``tri_b``/``s_inv_b``/``u_b`` must broadcast against the
    state batch shape; ``epoch`` stays f64 while positions/velocities run in
    ``pos.dtype``.  Returns (pos, vel, epoch, chi1, chi2, alive, committed).
    """
    dtype = jnp.asarray(pos).dtype
    feps = float(jnp.finfo(dtype).eps)
    # rel-step convergence floored at ~10 eps of the working dtype so f32
    # lanes can actually finish instead of burning the iteration budget
    done_eps = max(params.newton_eps, 10.0 * feps)

    # NR-only solver inside the correction loop — parity with the reference,
    # whose velocity_correction uses SolverType::default() = NewtonRaphson
    # with no Brent fallback (velocity.rs:131-138); also keeps the while-loop
    # body (and its compile time) small.  Warm-started chi makes NR reliable,
    # and the universal Kepler residual is monotone (unique root).
    vc_cfg = SolverConfig(convergency=params.kepler_eps, auto_fallback=False)

    def body(st):
        it, cpos, cvel, cepoch, chi1, chi2, alive, committed, done = st
        x1 = cpos[..., 0, :]
        x2 = cpos[..., 1, :]
        x3 = cpos[..., 2, :]
        # ONE stacked solve for both sides along the trailing batch axis
        # (L, 2K): halves the nested universal-Kepler while-loop count —
        # the loop body is latency-bound, not compute-bound — and the merged
        # loop exits at max(left, right) trips instead of left + right.
        # (The stack is along the trailing axis: tiny leading dims make
        # poor layouts inside while loops.)
        K = x1.shape[-2]
        x13 = jnp.concatenate([x1, x3], axis=-2)
        both = velocity_correction(
            x13,
            jnp.concatenate([x2, x2], axis=-2),
            jnp.concatenate([cvel, cvel], axis=-2),
            jnp.concatenate(
                [
                    jnp.broadcast_to(dt01, chi1.shape),
                    jnp.broadcast_to(dt21, chi2.shape),
                ],
                axis=-1,
            ),
            params.max_perihelion_au,
            params.max_ecc,
            chi_guess=jnp.concatenate([chi1, chi2], axis=-1),
            cfg=vc_cfg,
        )

        def _split(a):
            vec = a.ndim > chi1.ndim  # (..., 2K, 3) vs (..., 2K)
            return (a[..., :K, :], a[..., K:, :]) if vec else (a[..., :K], a[..., K:])

        parts = [_split(f) for f in both]
        left = type(both)(*(p[0] for p in parts))
        right = type(both)(*(p[1] for p in parts))
        iter_ok = (left.status == 0) & (right.status == 0)
        # freeze warm starts once a lane is done or dead (hard-rejected):
        # its returned chi must be the value at its own last active trip,
        # regardless of how many extra trips other lanes keep the batch
        # loop alive (batch-isolation contract)
        chi_upd = iter_ok & alive & ~done
        chi1n = jnp.where(chi_upd, left.psi, chi1)
        chi2n = jnp.where(chi_upd, right.psi, chi2)

        new_vel = 0.5 * (left.v2_corrected + right.v2_corrected)
        fl = left.f * right.g - right.f * left.g
        fl_ok = jnp.isfinite(fl) & (jnp.abs(fl) > feps)
        inv_f = 1.0 / jnp.where(fl_ok, fl, 1.0)
        cv = jnp.stack(
            [right.g * inv_f, -jnp.ones_like(inv_f), -left.g * inv_f], axis=-1
        )
        new_pos, new_epoch, rho_ok = _positions_from_cvec(
            tri_b, s_inv_b, u_b, cv, params.min_rho2_au,
        )
        acc_i, _, _, _ = eccentricity_control(
            new_pos[..., 1, :], new_vel, params.max_perihelion_au, params.max_ecc
        )
        # hard reject: dynamically unacceptable -> candidate loses correction.
        # ~done guard: a converged lane must not be re-judged on trips it
        # only runs because slower lanes keep the batch loop alive — without
        # it the corrected flag depends on batch composition.
        hard_reject = iter_ok & fl_ok & rho_ok & ~acc_i & ~done
        commit = iter_ok & fl_ok & rho_ok & acc_i & alive & ~done

        denom = jnp.sqrt(jnp.sum(new_pos**2, axis=(-1, -2)))
        rel_err = jnp.sqrt(
            jnp.sum((new_pos - cpos) ** 2, axis=(-1, -2))
        ) / jnp.where(denom > feps, denom, 1.0)

        cpos = jnp.where(commit[..., None, None], new_pos, cpos)
        cvel = jnp.where(commit[..., None], new_vel, cvel)
        cepoch = jnp.where(commit, new_epoch, cepoch)
        alive = alive & ~hard_reject
        committed = committed | commit
        # a lane that neither commits nor moves its warm starts is stationary
        # (same state -> same solve next trip): release it so one bad lane
        # cannot hold the whole latency-bound batch loop to max_it
        stalled = (
            alive
            & ~done
            & ~commit
            & (jnp.abs(chi1n - chi1) <= feps * (1.0 + jnp.abs(chi1)))
            & (jnp.abs(chi2n - chi2) <= feps * (1.0 + jnp.abs(chi2)))
        )
        done = done | (commit & (rel_err <= done_eps)) | stalled
        return (it + 1, cpos, cvel, cepoch, chi1n, chi2n, alive, committed, done)

    def cond(st):
        it, *_, alive, _committed, done = st
        # keep iterating while some candidate is alive and unconverged
        return (it < max_it) & jnp.any(alive & ~done)

    init = (
        jnp.array(0, jnp.int32),
        pos,
        vel,
        epoch,
        chi1,
        chi2,
        alive0,
        jnp.zeros_like(alive0),
        jnp.zeros_like(alive0),
    )
    _, cpos, cvel, cepoch, chi1, chi2, alive, committed, _ = jax.lax.while_loop(
        cond, body, init
    )
    return cpos, cvel, cepoch, chi1, chi2, alive, committed


def gauss_candidates(
    tri: GaussTriplets, params: IODParams, work_dtype=None
) -> GaussCandidates:
    """Roots -> accepted prelim states -> f-g corrected states, all masked.

    ``work_dtype`` selects the precision of the ITERATIVE stages (Aberth,
    the f-g correction loop); the one-shot prelim algebra (LOS matrix
    inverse, polynomial coefficients, singularity gate) always runs at the
    input precision — it is O(1) per lane and its conditioning (near-coplanar
    triplets have |det S| ~ 1e-5) is exactly what f32 cannot afford to lose.
    """
    dtype = jnp.dtype(work_dtype) if work_dtype is not None else jnp.asarray(tri.ra).dtype
    tau1, tau3, s_mat, s_inv, a, b, u, nonsing = gauss_prelim(tri)
    c0, c3, c6 = coeff_eight_poly(tri, s_mat, s_inv, a, b)

    if dtype != jnp.asarray(tri.ra).dtype:
        tau1, tau3, s_inv, u, a, b, c0, c3, c6 = (
            x.astype(dtype) for x in (tau1, tau3, s_inv, u, a, b, c0, c3, c6)
        )
        tri = GaussTriplets(
            tri.ra.astype(dtype),
            tri.dec.astype(dtype),
            tri.time,  # absolute MJDs stay f64
            tri.obs_pos.astype(dtype),
        )

    descartes_ok = descartes_upper_bound(c0, c3, c6) > 0

    roots = aberth_deg8(
        c0, c3, c6, params.aberth_max_iter, params.aberth_eps,
        active=descartes_ok & nonsing, sort=False,  # best-K re-ranks below
    )
    r2 = roots.real  # (L, 8)
    # real-root test: the reference's absolute 1e-6 cut assumes f64 Aberth;
    # in f32 a genuinely real root carries ~|z|*O(100 eps) imaginary noise,
    # so the threshold is floored at a relative dtype-scaled value
    feps = float(jnp.finfo(dtype).eps)
    imag_tol = jnp.maximum(
        params.root_imag_eps, 100.0 * feps * (1.0 + jnp.abs(r2))
    )
    root_ok = (
        (jnp.abs(roots.imag) < imag_tol)
        & (r2 > 0.0)
        & (r2 >= params.r2_min_au)
        & (r2 <= params.r2_max_au)
        & descartes_ok[..., None]
        & nonsing[..., None]
    )
    # --- candidate compaction: keep the best max_tested_solutions roots ----
    # (parity: the reference accumulates at most 3 solutions, gauss.rs:
    # max_tested_solutions; valid roots sorted by ascending r2 — the degree-8
    # polynomial has at most 3 positive real roots in practice, so this caps
    # the correction/scoring cost at no loss)
    n_keep = min(params.max_tested_solutions, 8)
    # top_k of the negated masked r2 = the n_keep smallest, ascending —
    # cheaper than a full argsort
    neg_r2, order = jax.lax.top_k(-jnp.where(root_ok, r2, jnp.inf), n_keep)
    r2 = -neg_r2
    root_ok = jnp.take_along_axis(root_ok, order, axis=-1)
    r2_safe = jnp.where(root_ok, r2, 1.0)

    # --- accept_root (prelim state per root) --------------------------------
    r2m3 = 1.0 / r2_safe**3
    c_vec = jnp.stack(
        [
            a[..., None, 0] + b[..., None, 0] * r2m3,
            -jnp.ones_like(r2m3),
            a[..., None, 2] + b[..., None, 2] * r2m3,
        ],
        axis=-1,
    )  # (L, 8, 3)

    tri8 = GaussTriplets(
        tri.ra[..., None, :],
        tri.dec[..., None, :],
        tri.time[..., None, :],
        tri.obs_pos[..., None, :, :],
    )
    pos, epoch, rho2_ok = _positions_from_cvec(
        tri8, s_inv[..., None, :, :], u[..., None, :, :], c_vec, params.min_rho2_au
    )
    t1_, t3_ = tau1[..., None], tau3[..., None]
    vel = gibbs_velocity(pos, t1_, t3_)
    acc, _, _, _ = eccentricity_control(
        pos[..., 1, :], vel, params.max_perihelion_au, params.max_ecc
    )
    valid = root_ok & rho2_ok & acc

    # --- pos_and_vel_correction (fixed-trip masked) -------------------------
    dt01 = (tri.time[..., 0] - tri.time[..., 1])[..., None]
    dt21 = (tri.time[..., 2] - tri.time[..., 1])[..., None]
    dt_ok = (jnp.abs(dt01) > _EPS) & (jnp.abs(dt21) > _EPS)

    chi0 = jnp.zeros(epoch.shape, r2.dtype)
    cpos, cvel, cepoch, chi1, chi2, alive, committed = _fg_correction(
        tri8, s_inv[..., None, :, :], u[..., None, :, :],
        dt01, dt21, pos, vel, epoch, chi0, chi0,
        valid & dt_ok, params, params.newton_max_it,
    )

    corrected = valid & alive & committed
    out_pos = jnp.where(corrected[..., None, None], cpos, pos)
    out_vel = jnp.where(corrected[..., None], cvel, vel)
    out_epoch = jnp.where(corrected, cepoch, epoch)
    return GaussCandidates(
        out_pos, out_vel, out_epoch, valid, corrected, chi1, chi2, r2
    )


def polish_selected(
    tri: GaussTriplets,
    r2,
    pos,
    vel,
    epoch,
    corrected,
    chi1,
    chi2,
    params: IODParams,
    max_it: int = 12,
):
    """f64 refinement of the per-lane SELECTED candidate (mixed-precision path).

    The f32 kernel decides WHICH root/candidate wins; this pass recovers f64
    accuracy for that one candidate per lane at ~1/(K * iters) of the full
    f64 correction cost:

    1. 3 Newton steps on the degree-8 polynomial (f64 coefficients) from the
       f32 root — quadratic convergence takes 1e-7 -> machine precision,
    2. f64 rebuild of the prelim state (rho solve + light-time + Gibbs),
    3. for corrected lanes: continue the two-sided f-g correction in f64 from
       the (cast) f32 fixed point with chi warm starts.

    ``tri`` must be the f64 triplets.  Returns (pos, vel, epoch, corrected).
    """
    tau1, tau3, s_mat, s_inv, a, b, u, _ = gauss_prelim(tri)
    c0, c3, c6 = coeff_eight_poly(tri, s_mat, s_inv, a, b)

    x = jnp.asarray(r2, jnp.float64)
    bad_root = ~jnp.isfinite(x) | (x <= 0.0)
    x = jnp.where(bad_root, 1.0, x)
    for _ in range(3):
        x2 = x * x
        x3 = x2 * x
        x5 = x3 * x2
        x6 = x3 * x3
        x7 = x6 * x
        x8 = x6 * x2
        pv = x8 + c6 * x6 + c3 * x3 + c0
        dpv = 8.0 * x7 + 6.0 * c6 * x5 + 3.0 * c3 * x2
        dpv = jnp.where(jnp.abs(dpv) > _EPS, dpv, 1.0)
        # clamp to stay on the positive branch of the same root
        x = x - jnp.clip(pv / dpv, -0.5 * x, 0.5 * x)

    r2m3 = 1.0 / x**3
    c_vec = jnp.stack(
        [
            a[..., 0] + b[..., 0] * r2m3,
            -jnp.ones_like(r2m3),
            a[..., 2] + b[..., 2] * r2m3,
        ],
        axis=-1,
    )
    pos0, epoch0, _ = _positions_from_cvec(tri, s_inv, u, c_vec, params.min_rho2_au)
    vel0 = gibbs_velocity(pos0, tau1, tau3)

    # corrected lanes resume from the f32 fixed point; prelim-only lanes take
    # the f64 prelim rebuild directly (the reference returns the prelim orbit
    # for them, gauss.rs:1238-1247)
    cmask = corrected
    init_pos = jnp.where(cmask[..., None, None], jnp.asarray(pos, jnp.float64), pos0)
    init_vel = jnp.where(cmask[..., None], jnp.asarray(vel, jnp.float64), vel0)
    init_epoch = jnp.where(cmask, jnp.asarray(epoch, jnp.float64), epoch0)

    dt01 = tri.time[..., 0] - tri.time[..., 1]
    dt21 = tri.time[..., 2] - tri.time[..., 1]
    chi1 = jnp.asarray(chi1, jnp.float64)
    chi2 = jnp.asarray(chi2, jnp.float64)

    cpos, cvel, cepoch, _, _, alive, committed = _fg_correction(
        tri, s_inv, u, dt01, dt21,
        init_pos, init_vel, init_epoch, chi1, chi2,
        cmask & ~bad_root, params, max_it,
    )
    refined = cmask & alive & committed
    out_pos = jnp.where(refined[..., None, None], cpos, init_pos)
    out_vel = jnp.where(refined[..., None], cvel, init_vel)
    out_epoch = jnp.where(refined, cepoch, init_epoch)
    # the corrected flag is the f32 pass's decision; a lane whose f64 resume
    # could not commit simply keeps the (cast) f32 fixed point
    return out_pos, out_vel, out_epoch, corrected


def candidates_to_elements(cands: GaussCandidates):
    """Central state -> ecliptic frame -> orbital elements per candidate.

    Parity: ``compute_orbit_from_state`` (gauss.rs:906-923) + ccek1.
    Returns (kind (L,8), elements (L,8,6)).
    """
    rot = jnp.asarray(ROT_EQUMJ2000_TO_ECLMJ2000, jnp.asarray(cands.vel).dtype)
    p_ecl = rotate3(rot, cands.pos[..., 1, :])
    v_ecl = rotate3(rot, cands.vel)
    return ccek1(p_ecl, v_ecl)
