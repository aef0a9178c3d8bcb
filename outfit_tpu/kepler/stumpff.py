"""Generalized Stumpff functions s0..s3, batched and branch-free.

Behavioral parity with the reference's ``s_funct`` (``src/kepler/stumpff.rs:78``):
same (psi, alpha) -> (s0, s1, s2, s3) contract with alpha = -1/a, where

    s2 = psi^2/2 + beta psi^4/4! + ...,   s3 = psi^3/3! + beta psi^5/5! + ...
    s0 = 1 + alpha*s2,  s1 = psi + alpha*s3,  beta = alpha*psi^2.

Batch-first redesign (vs the reference's data-dependent while loops):

* The halving count is computed in closed form, ``k = ceil(log4(|beta|/T))``,
  instead of a runtime halving loop (``stumpff.rs:244-261``).
* The series runs a fixed 12 terms at the reduced ``|beta| <= 1`` — enough
  for full f64 accuracy (term_12/term_0 < 1e-19) without per-lane early exit.
* Duplication scales s2/s3 back up *directly* via the cancellation-free
  recurrences

      s2(2p) = 2*s2*(2 + alpha*s2)          (= 2*s2*(s0+1))
      s3(2p) = 2*(s3 + p*s2 + alpha*s2*s3)  (= (2*s0*s1 - 2p)/alpha)

  avoiding the reference's documented precision loss from reconstructing
  s2 = (s0-1)/alpha at large beta (``stumpff.rs:232-235``).

Fully vectorized: any broadcastable (psi, alpha) shapes.
"""

import jax
import jax.numpy as jnp

#: Reduce |beta| below this before the series (power of 4 friendly).
_BETA_THRESHOLD = 1.0
#: Fixed series term count at |beta| <= 1 (term ratio < 1/12 per step).
_N_SERIES = 12
#: Max halvings: covers |beta| up to 4^40 ~ 1e24.
_MAX_HALVINGS = 40

import numpy as _np

_POW2NEG = jnp.asarray(2.0 ** -_np.arange(_MAX_HALVINGS + 1, dtype=_np.float64))


def s_funct(psi, alpha):
    """Compute (s0, s1, s2, s3) for universal anomaly psi and alpha = -1/a.

    Shapes broadcast; outputs have the broadcast shape.
    """
    dtype = jnp.result_type(psi, alpha)
    if not jnp.issubdtype(dtype, jnp.floating):
        dtype = jnp.float64
    psi, alpha = jnp.broadcast_arrays(
        jnp.asarray(psi, dtype), jnp.asarray(alpha, dtype)
    )
    beta = alpha * psi * psi

    # Closed-form halving count (0 where |beta| already small; log of 0 guarded)
    absbeta = jnp.abs(beta)
    safe = jnp.maximum(absbeta, _BETA_THRESHOLD)
    k = jnp.ceil(0.5 * jnp.log2(safe / _BETA_THRESHOLD)).astype(jnp.int32)
    k = jnp.clip(k, 0, _MAX_HALVINGS)

    # exact 2^-k via table gather (no s64 bitcast, as jnp.ldexp needs)
    scale = _POW2NEG[k].astype(dtype)  # powers of two: exact in any float
    psi_r = psi * scale
    beta_r = beta * scale * scale

    # Fixed-term series for s2, s3 at the reduced psi.
    psi2 = psi_r * psi_r
    s2 = 0.5 * psi2
    s3 = s2 * psi_r / 3.0
    term2 = s2
    term3 = s3
    for n in range(1, _N_SERIES + 1):
        term2 = term2 * (beta_r / ((2.0 * n + 1.0) * (2.0 * n + 2.0)))
        term3 = term3 * (beta_r / ((2.0 * n + 2.0) * (2.0 * n + 3.0)))
        s2 = s2 + term2
        s3 = s3 + term3

    # Masked duplication: double psi k times, scaling s2/s3 cancellation-free.
    # Early exit at the batch-max halving count (typically 0-4 for IOD-scale
    # arcs; the 40-step bound only pays when some lane actually needs it).
    kmax = jnp.max(k)

    def dup_cond(carry):
        i, _, _, _ = carry
        return i < kmax

    def dup(carry):
        i, p, s2, s3 = carry
        act = i < k
        s2n = 2.0 * s2 * (2.0 + alpha * s2)
        s3n = 2.0 * (s3 + p * s2 + alpha * s2 * s3)
        pn = 2.0 * p
        return (
            i + 1,
            jnp.where(act, pn, p),
            jnp.where(act, s2n, s2),
            jnp.where(act, s3n, s3),
        )

    _, _, s2, s3 = jax.lax.while_loop(
        dup_cond, dup, (jnp.array(0, jnp.int32), psi_r, s2, s3)
    )

    s0 = 1.0 + alpha * s2
    s1 = psi + alpha * s3
    return s0, s1, s2, s3
