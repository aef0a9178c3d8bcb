"""Small fixed-size linear algebra, unrolled as plain batched arithmetic.

The reference inverts 6x6 normal matrices with nalgebra Cholesky + QR
fallback (``least_square.rs:329-341``).  Here the Cholesky factorization,
triangular solves, and the SPD inverse are unrolled as elementwise batched
arithmetic that lowers on every backend, with a per-lane ``ok`` flag
instead of an exception (whether ``jnp.linalg`` is as fast on the GPU is
an open question, ROADMAP C6).

The QR fallback is a DELIBERATE deviation, kept out after measurement.
Normal matrices are sums of outer products accumulated in f64, hence PSD by
construction — Cholesky only rejects them once rounding makes a
near-singular one indefinite (condition number ~1e15+).  nalgebra's QR
"rescues" exactly those by returning an inverse with O(cond*eps) error and
letting the correction loop's bizarre/divergence checks judge the garbage
step.  A batched implementation was built and reverted: rescued steps
amplify XLA's ~1-ulp batch-shape lowering noise in the Jacobians by the
condition number, which broke the batch-isolation contract (a lane's
elements moved by 1e-2 depending on which other lanes shared the batch —
tests/test_lsq.py::TestLsqBatchIsolation).  The scalar reference never had
to state that contract; here INVERSION_FAILED -> fall-back-to-IOD is both
deterministic and statistically honest (a cond-1e15 covariance is
meaningless).
"""

import jax.numpy as jnp

_N = 6


def cholesky6(a):
    """Lower-triangular L with a = L L^T for batched (..., 6, 6) SPD input.

    Returns (L, ok) where ok flags positive-definiteness per batch element.
    Non-positive pivots are replaced by 1 to keep downstream math finite.
    """
    rows = [[None] * _N for _ in range(_N)]
    ok = jnp.ones(a.shape[:-2], bool)
    for i in range(_N):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            if i == j:
                ok = ok & (s > 0.0) & jnp.isfinite(s)
                d = jnp.sqrt(jnp.where(s > 0.0, s, 1.0))
                rows[i][j] = d
            else:
                rows[i][j] = s / rows[j][j]
    zero = jnp.zeros_like(a[..., 0, 0])
    L = jnp.stack(
        [
            jnp.stack([rows[i][j] if j <= i else zero for j in range(_N)], axis=-1)
            for i in range(_N)
        ],
        axis=-2,
    )
    return L, ok


def cholesky_inverse6(a):
    """Inverse of a batched (..., 6, 6) SPD matrix via Cholesky.

    Returns (inv, ok).  On failure (non-SPD) the result is garbage and ok is
    False — callers must gate on ok (errors-as-data convention).
    """
    L, ok = cholesky6(a)
    # invert L by forward substitution (unrolled): L @ Linv = I
    linv = [[None] * _N for _ in range(_N)]
    for j in range(_N):
        for i in range(_N):
            if i < j:
                linv[i][j] = None
                continue
            if i == j:
                linv[i][j] = 1.0 / L[..., i, i]
            else:
                s = 0.0
                for k in range(j, i):
                    s = s + L[..., i, k] * linv[k][j]
                linv[i][j] = -s / L[..., i, i]
    # inv(a) = Linv^T @ Linv
    zero = jnp.zeros_like(a[..., 0, 0])
    out = [[zero] * _N for _ in range(_N)]
    for i in range(_N):
        for j in range(_N):
            s = zero
            for k in range(max(i, j), _N):
                s = s + linv[k][i] * linv[k][j]
            out[i][j] = s
    inv = jnp.stack(
        [jnp.stack(out[i], axis=-1) for i in range(_N)], axis=-2
    )
    return inv, ok


# ---------------------------------------------------------------------------
# Tiny-contraction helpers (elementwise multiply + reduce, never dot_general)
# ---------------------------------------------------------------------------
# XLA lowers batched einsums with small contraction dims (3 or 6) to
# matrix-unit dot_generals padded to the unit's tile; at orbit-determination
# batch shapes a broadcast-multiply + sum fuses with its neighbours instead.
# Every hot-path contraction goes through these (whether the rule pays on
# the GPU is ROADMAP C6).


def matvec_small(m, v):
    """(..., i, j) @ (..., j) -> (..., i) via multiply + reduce."""
    return jnp.sum(m * v[..., None, :], -1)


def rotate3(rot, v):
    """Apply a (3, 3) rotation (or batch thereof) to (..., 3) vectors."""
    return jnp.sum(jnp.asarray(rot, jnp.asarray(v).dtype) * v[..., None, :], -1)


def matmul_small(a, b):
    """(..., i, k) @ (..., k, j) -> (..., i, j) via multiply + reduce.

    For tiny inner dims (3x3 rotation chains): `@` lowers to a
    dot_general that pads the contraction to the tile size (see module
    note)."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)
