"""Batched Aberth-Ehrlich root finder for the sparse Gauss degree-8 polynomial.

p(x) = x^8 + c6 x^6 + c3 x^3 + c0

Replaces the reference's external ``aberth`` crate (``gauss.rs:648-667``)
with a fixed-iteration simultaneous-root solver in complex128 over any batch
shape.  Root ordering is canonicalized by ascending real part (the crate's
discovery order is initialization-dependent and semantically meaningless).
"""

import jax
import jax.numpy as jnp
import numpy as np


def descartes_upper_bound(c0, c3, c6):
    """Upper bound on positive real roots via Descartes' rule of signs.

    Parity: ``descartes_upper_bound_deg8_sparse`` (``gauss.rs:214-240``).
    Sign sequence of [1, c6, c3, c0] by decreasing degree, zeros skipped.
    """
    signs = jnp.stack(
        [jnp.ones_like(c6), jnp.sign(c6), jnp.sign(c3), jnp.sign(c0)], axis=-1
    )

    def count(carry, s):
        prev, cnt = carry
        is_nonzero = s != 0
        change = is_nonzero & (s * prev < 0)
        prev_new = jnp.where(is_nonzero, s, prev)
        return (prev_new, cnt + change.astype(jnp.int32)), None

    init = (signs[..., 0], jnp.zeros(signs.shape[:-1], jnp.int32))
    (_, cnt), _ = jax.lax.scan(
        count, init, jnp.moveaxis(signs[..., 1:], -1, 0)
    )
    return cnt


class ComplexRoots:
    """(re, im) pair container mimicking the complex result surface.

    Complex arithmetic is carried as explicit float64 pairs, which lowers
    on every backend (whether complex128 is as fast on the GPU is
    ROADMAP C6).
    """

    def __init__(self, re, im):
        self.real = re
        self.imag = im

    @property
    def shape(self):
        return self.real.shape


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    d = br * br + bi * bi
    tiny = float(jnp.finfo(jnp.asarray(d).dtype).tiny)
    d = jnp.where(d > tiny, d, 1.0)
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def aberth_deg8(
    c0, c3, c6, max_iter: int = 50, eps: float = 1e-6, active=None, sort=True
):
    """All 8 complex roots of x^8 + c6 x^6 + c3 x^3 + c0, batched.

    Returns a :class:`ComplexRoots` with (..., 8) float64 ``real``/``imag``,
    sorted by real part ascending.

    ``active``: optional per-lane bool mask — inactive lanes (e.g. Descartes
    count 0, singular LOS matrix) are frozen immediately so their
    (potentially ill-conditioned) iterations never hold the batch-converged
    while loop open.  Parity: the reference skips Aberth entirely for
    Descartes-zero triplets (gauss.rs:1130-1135).
    """
    dtype = jnp.result_type(c0, c3, c6)
    if not jnp.issubdtype(dtype, jnp.floating):
        dtype = jnp.float64
    feps = float(jnp.finfo(dtype).eps)
    c0 = jnp.asarray(c0, dtype)
    c3 = jnp.asarray(c3, dtype)
    c6 = jnp.asarray(c6, dtype)
    shape = jnp.broadcast_shapes(c0.shape, c3.shape, c6.shape)
    c0, c3, c6 = (jnp.broadcast_to(c, shape)[..., None] for c in (c0, c3, c6))

    def p(zr, zi):
        z2r, z2i = _cmul(zr, zi, zr, zi)
        z3r, z3i = _cmul(z2r, z2i, zr, zi)
        z6r, z6i = _cmul(z3r, z3i, z3r, z3i)
        z8r, z8i = _cmul(z6r, z6i, z2r, z2i)
        return (
            z8r + c6 * z6r + c3 * z3r + c0,
            z8i + c6 * z6i + c3 * z3i,
        )

    def dp(zr, zi):
        z2r, z2i = _cmul(zr, zi, zr, zi)
        z4r, z4i = _cmul(z2r, z2i, z2r, z2i)
        z5r, z5i = _cmul(z4r, z4i, zr, zi)
        z7r, z7i = _cmul(z5r, z5i, z2r, z2i)
        return (
            8.0 * z7r + 6.0 * c6 * z5r + 3.0 * c3 * z2r,
            8.0 * z7i + 6.0 * c6 * z5i + 3.0 * c3 * z2i,
        )

    # Initial circle: radius from the geometric mean of root magnitudes
    # (|c0|^(1/8)), floored to avoid collapse; Bini-style angular offset.
    r = jnp.maximum(jnp.abs(c0[..., 0]) ** 0.125, 0.3)[..., None]
    k = np.arange(8)
    theta = 2.0 * np.pi * k / 8.0 + 0.4
    zr = r * jnp.asarray(np.cos(theta), dtype)  # keep the working dtype
    zi = r * jnp.asarray(np.sin(theta), dtype)

    eye = np.eye(8, dtype=bool)

    def body(carry):
        it, zr, zi, done = carry
        pr, pi = p(zr, zi)
        dpr, dpi = dp(zr, zi)
        nr, ni = _cdiv(pr, pi, dpr, dpi)  # Newton correction
        # sum over j != i of 1 / (z_i - z_j)
        dr = zr[..., :, None] - zr[..., None, :]
        di = zi[..., :, None] - zi[..., None, :]
        dr = jnp.where(eye, 1.0, dr)
        di = jnp.where(eye, 0.0, di)
        ir, ii = _cdiv(jnp.ones_like(dr), jnp.zeros_like(di), dr, di)
        sr = jnp.sum(jnp.where(eye, 0.0, ir), axis=-1)
        si = jnp.sum(jnp.where(eye, 0.0, ii), axis=-1)
        # w = newton / (1 - newton * sum)
        tr, ti = _cmul(nr, ni, sr, si)
        wr, wi = _cdiv(nr, ni, 1.0 - tr, -ti)
        # freeze converged roots (relative step at machine precision) to
        # avoid limit-cycle jitter; `eps` (the reference's aberth_eps) is an
        # upper bound only — Aberth is cubically convergent, so running the
        # full fixed iteration count gives full-precision roots.
        wmag = jnp.sqrt(wr * wr + wi * wi)
        zmag = jnp.sqrt(zr * zr + zi * zi)
        # freeze threshold: the caller's eps capped at ~machine precision of
        # f64 (450*eps(f64) ~= the historical 1e-13), but FLOORED at 30 eps
        # of the working dtype — in f32 a 1e-6 relative step (~8 eps) is
        # unreachable for clustered roots, which otherwise limit-cycle and
        # hold the whole batch at the full iteration budget.  The winning
        # root is re-Newtoned on f64 coefficients in the polish pass, so
        # 30 eps(f32) ~ 3.6e-6 relative is ample here.
        thr = max(min(eps, 450.0 * 2.220446049250313e-16), 30.0 * feps)
        conv = wmag <= thr * (1.0 + zmag)
        # STICKY freeze (done stays set once a root converges): without it a
        # frozen root can UNfreeze when the repulsion term from other still-
        # moving roots re-inflates its recomputed step — clustered roots of
        # noisy real-survey octics then limit-cycle and hold the whole
        # batch-converged loop at the full 50-trip budget.  A root frozen at
        # thr*(1+|z|) relative (~1e-13 in f64) is converged for every
        # downstream contract (oracles at 1e-9..1e-11; the mixed path
        # re-Newtons the winner on f64 coefficients anyway).  A stall
        # release for never-converging roots was tried and REVERTED: early
        # Aberth dynamics plateau legitimately while the constellation
        # reorganizes, and a 6-trip no-contraction release killed genuine
        # roots (tests/test_iod.py::TestRoots).
        done = done | conv
        step_ok = ~done
        return (
            it + 1,
            jnp.where(step_ok, zr - wr, zr),
            jnp.where(step_ok, zi - wi, zi),
            done,
        )

    def cond(carry):
        it, _, _, done = carry
        return (it < max_iter) & ~jnp.all(done)

    done0 = jnp.zeros(zr.shape, bool)
    if active is not None:
        done0 = done0 | ~active[..., None]
    _, zr, zi, _ = jax.lax.while_loop(
        cond, body, (jnp.array(0, jnp.int32), zr, zi, done0)
    )
    if not sort:
        # callers that re-rank the roots themselves (gauss_candidates keeps
        # the best-K by masked r2) can skip the canonical sort; the
        # fixed-circle initialization keeps the unsorted order deterministic
        return ComplexRoots(zr, zi)
    order = jnp.argsort(zr, axis=-1)
    return ComplexRoots(
        jnp.take_along_axis(zr, order, axis=-1),
        jnp.take_along_axis(zi, order, axis=-1),
    )
