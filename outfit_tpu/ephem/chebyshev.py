"""Device-side Chebyshev ephemeris tables and batched interpolation.

The flattened layout (SURVEY hard-part #6): per body, a granule-uniform
coefficient array ``coeffs[n_granules, 3, n_coeff]`` in AU over
``[t0, t0 + n_granules * granule_days]`` (MJD TT/TDB).  A query is one
gather (granule row) + one Chebyshev-basis contraction — batched over any
epoch shape, jit/vmap-ready, and trivially shardable over the epoch axis.

Parity: the numerical behavior matches the reference's per-record Chebyshev
evaluation (``horizon_records.rs:204``, ``ephemeris_record.rs:195``); the
layout is redesigned for batched device queries (the reference walks nested
Vec<HashMap<body, Vec<record>>>).
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class BodyTable(NamedTuple):
    """Granule-uniform Chebyshev table for one body (positions in AU)."""

    t0: float  # MJD of first granule start
    granule_days: float
    coeffs: jnp.ndarray  # (n_granules, 3, n_coeff)

    @property
    def t_end(self):
        return self.t0 + self.coeffs.shape[0] * self.granule_days


def _chebyshev_basis(tau, n):
    """T_k(tau) and dT_k/dtau for k < n; tau shape (...) -> (..., n)."""
    # Iterative recurrence, unrolled at trace time (n is static, <= ~18).
    t_prev = jnp.ones_like(tau)
    t_cur = tau
    d_prev = jnp.zeros_like(tau)
    d_cur = jnp.ones_like(tau)
    ts = [t_prev, t_cur]
    ds = [d_prev, d_cur]
    for _ in range(2, n):
        t_next = 2.0 * tau * t_cur - t_prev
        d_next = 2.0 * t_cur + 2.0 * tau * d_cur - d_prev
        ts.append(t_next)
        ds.append(d_next)
        t_prev, t_cur = t_cur, t_next
        d_prev, d_cur = d_cur, d_next
    return jnp.stack(ts[:n], axis=-1), jnp.stack(ds[:n], axis=-1)


def interpolate_body(table: BodyTable, mjd, velocity: bool = True):
    """Interpolate position (AU) and velocity (AU/day) at batched epochs.

    Epochs outside coverage are clamped to the boundary granule (the
    reference panics; callers validate coverage host-side via
    ``BodyTable.t0 / t_end``).
    """
    mjd = jnp.asarray(mjd)
    n_gran = table.coeffs.shape[0]
    n_coeff = table.coeffs.shape[2]

    x = (mjd - table.t0) / table.granule_days
    idx = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, n_gran - 1)
    tau = 2.0 * (x - idx) - 1.0  # [-1, 1] within granule

    c = jnp.asarray(table.coeffs)[idx]  # (..., 3, n_coeff); asarray: tables
    # loaded from the npz cache are numpy and must be device arrays under jit
    tb, db = _chebyshev_basis(tau, n_coeff)  # (..., n_coeff)
    # multiply + reduce over the (tiny) coefficient axis — einsum would
    # lower to a padded dot_general (see utils.linalg)
    pos = jnp.sum(c * tb[..., None, :], -1)
    if not velocity:
        return pos, None
    vel = jnp.sum(c * db[..., None, :], -1) * (2.0 / table.granule_days)
    return pos, vel


def fit_body_table(
    state_fn,
    t0: float,
    t1: float,
    granule_days: float = 16.0,
    n_coeff: int = 14,
) -> BodyTable:
    """Build a BodyTable by Chebyshev-fitting a host-side position function.

    ``state_fn(mjd_array) -> positions (n, 3) in AU``.  Used by the analytic
    source (and by tests to build synthetic tables).  Fitting uses
    Chebyshev-Gauss-Lobatto collocation per granule — interpolation error
    is bounded by the function's smoothness, not the sample count.
    """
    n_gran = int(np.ceil((t1 - t0) / granule_days))
    # Chebyshev-Gauss-Lobatto nodes in [0, 1]
    k = np.arange(n_coeff)
    nodes = 0.5 * (1.0 - np.cos(np.pi * k / (n_coeff - 1)))  # [0,1], ascending

    starts = t0 + granule_days * np.arange(n_gran)
    times = (starts[:, None] + granule_days * nodes[None, :]).ravel()
    pos = np.asarray(state_fn(times)).reshape(n_gran, n_coeff, 3)

    # First-kind Chebyshev-Lobatto fit: coefficients via the discrete
    # orthogonality of T_j at Lobatto nodes.
    x = np.cos(np.pi * k / (n_coeff - 1))  # Lobatto nodes, descending in x
    # T matrix: T[j, m] = T_j(x_m)
    T = np.cos(np.pi * np.outer(np.arange(n_coeff), k) / (n_coeff - 1))
    w = np.ones(n_coeff)
    w[0] = w[-1] = 0.5
    scale = np.ones(n_coeff) * (2.0 / (n_coeff - 1))
    scale[0] = scale[-1] = 1.0 / (n_coeff - 1)
    # nodes ascending in t correspond to x descending; flip sample order
    samples = pos[:, ::-1, :]  # now aligned with x_m = cos(pi m / (n-1))
    coeffs = np.einsum("jm,m,gmc->gcj", T, w, samples) * scale  # scale over j
    return BodyTable(float(t0), float(granule_days), jnp.asarray(coeffs))
