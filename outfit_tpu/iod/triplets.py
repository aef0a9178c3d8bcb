"""Host-side triplet generation, scoring, and RMS-window selection.

Behavioral parity with ``src/initial_orbit_determination/triplet_generation/``:

* ``downsample_uniform_with_edges`` (index_generator.rs:66-75),
* feasible windows dt_min <= t_k - t_i <= dt_max with i < j < k
  (index_generator.rs:94-260),
* spacing weight s(dt) = dtw/dt if dt <= dtw else 1 + dt/dtw summed over
  both gaps (mod.rs:148-274), best-K selection (mod.rs:365-408),

and with ``select_rms_interval`` (trajectory.rs:294-350).

This stage is O(n^2) index bookkeeping on at most 100 downsampled epochs per
trajectory — plain numpy is the right tool; the output feeds the device
kernel.
"""

from typing import List, Tuple

import numpy as np


def downsample_uniform_with_edges(n: int, max_keep: int) -> np.ndarray:
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if max_keep >= n:
        return np.arange(n)
    if max_keep <= 3:
        return np.array([0, n // 2, n - 1])
    i = np.arange(max_keep)
    return i * (n - 1) // (max_keep - 1)


def triplet_weight(t1, t2, t3, dtw: float):
    # s(dt) = dtw/dt if dt <= dtw else 1 + dt/dtw (mod.rs:148-274), written
    # with ONE division per gap (1 + dt * (1/dtw) costs a multiply).
    inv_dtw = 1.0 / dtw

    def s_gap(dt):
        return np.where(
            dt <= dtw, dtw / np.maximum(dt, 1e-300), 1.0 + dt * inv_dtw
        )

    return s_gap(t2 - t1) + s_gap(t3 - t2)


#: tiny f32 floor guarding the s_gap division (1e-300 underflows in f32)
_W32_TINY = np.float32(1e-38)

#: finite cap keeping FEASIBLE weights strictly below the +inf infeasible-mask
#: sentinel.  A zero intra-triplet gap (duplicate epochs; dt_min only bounds
#: the span t3-t1) makes dtw32/tiny32 overflow f32 to +inf, which would
#: collide with the mask and let argmin/stable-sort tie-breaks pick
#: span-INFEASIBLE combinations into the first ktrips slots (the f64 path
#: kept these finite at ~2e301).  min(w, cap) after the sum maps every
#: overflowed lane to the same finite value (degenerate triplets tie-broken
#: by index — they are interchangeable as Gauss inputs) while preserving the
#: ordering of all non-overflowing weights.
_W32_CAP = np.float32(3.0e38)


def triplet_weight32(t1, t2, t3, dtw: float):
    """float32 SELECTION weight — the quantized ordering key shared bitwise
    by the numpy and device enumerators.

    Best-K triplet choice is a spacing heuristic (mod.rs:148-274); ~7
    significant digits order the candidates identically except on
    physical near-ties, where either member is an equally good Gauss
    triplet.  Quantizing the ordering to f32 lets the device enumerator
    run its weight sweep in f32 instead of f64 (the C(m,3) grid is the
    largest real-cadence IOD sweep) and order
    by the int32 BIT PATTERN (monotonic for non-negative floats incl.
    +inf).  Gaps are computed in f64 and rounded once; every subsequent
    op is f32, expression-identical between numpy and XLA (the CPU
    device==numpy parity property tests pin it; a backend whose f32
    division is not correctly rounded may order near-ties differently —
    deterministically)."""
    dtw32 = np.float32(dtw)
    inv32 = np.float32(1.0 / dtw)
    one32 = np.float32(1.0)

    def s_gap(dt64):
        g = np.asarray(dt64, np.float64).astype(np.float32)
        return np.where(
            g <= dtw32, dtw32 / np.maximum(g, _W32_TINY), one32 + g * inv32
        )

    with np.errstate(over="ignore"):  # zero-gap overflow is clamped below
        w = (s_gap(t2 - t1) + s_gap(t3 - t2)).astype(np.float32)
    return np.minimum(w, _W32_CAP)




def generate_triplet_indices(
    epochs: np.ndarray,
    dt_min: float,
    dt_max: float,
    optimal_interval: float,
    max_obs: int,
    max_triplets: int,
) -> List[Tuple[int, int, int]]:
    """Best-K spacing-weighted feasible triplets (indices into ``epochs``).

    ``epochs`` must be sorted ascending.  Returns original (pre-downsample)
    indices.  Fully vectorized (the reference's lazy two-pointer stream +
    bounded heap, index_generator.rs:94-260 / mod.rs:365-408, is a scalar-CPU
    shape; enumerating the <= m^3/6 combinations with numpy and taking a
    lexicographic best-K is equivalent and far faster from Python).
    """
    n = len(epochs)
    keep = downsample_uniform_with_edges(n, max_obs)
    t = epochs[keep]
    m = len(t)
    if m < 3:
        return []
    a, j, k = np.meshgrid(
        np.arange(m), np.arange(m), np.arange(m), indexing="ij", sparse=True
    )
    span = t[k] - t[a]
    feasible = (a < j) & (j < k) & (span >= dt_min) & (span <= dt_max)
    ai, ji, ki = np.nonzero(feasible)
    if ai.size == 0:
        return []
    w = triplet_weight32(t[ai], t[ji], t[ki], optimal_interval)
    # ascending (f32 weight, a, j, k): (ai, ji, ki) come out of nonzero in
    # lexicographic order, so a stable argsort on the quantized weight IS
    # the (w, a, j, k) lex order the scalar reference uses
    wbits = w.view(np.int32)
    order = np.argsort(wbits, kind="stable")[:max_triplets]
    ka = keep[ai[order]]
    kj = keep[ji[order]]
    kk = keep[ki[order]]
    return [(int(x), int(y), int(z)) for x, y, z in zip(ka, kj, kk)]


def generate_triplet_indices_batch(
    epochs_pad: np.ndarray,
    counts: np.ndarray,
    dt_min: float,
    dt_max: float,
    optimal_interval: float,
    max_obs: int,
    max_triplets: int,
    budget: int = 32_000_000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized :func:`generate_triplet_indices` over MANY trajectories.

    ``epochs_pad`` is ``(T, n_max)`` per-trajectory sorted epochs (padding
    arbitrary), ``counts`` the valid lengths.  Returns ``(trips, ktrips)``:
    ``trips[t, :ktrips[t]]`` are the best-K triplets as local observation
    indices, element-for-element equal to the scalar enumerator (property-
    tested).  This removes the per-trajectory Python loop that dominated
    host prep at survey scale.

    ``budget`` caps the (chunk x combination) working-set size.
    """
    counts = np.asarray(counts, np.int64)
    T = counts.shape[0]
    trips = np.zeros((T, max_triplets, 3), np.int64)
    ktrips = np.zeros(T, np.int64)
    if T == 0:
        return trips, ktrips

    # downsample map (index_generator.rs:66-75): identity when n <= max_obs,
    # uniform-with-edges otherwise; the scalar max_keep<=3 quirk keeps 3
    m_eff = np.where(counts <= max_obs, counts, 3 if max_obs <= 3 else max_obs)
    m_eff = np.minimum(m_eff, counts)
    m_cap = int(m_eff.max(initial=0))
    if m_cap < 3:
        return trips, ktrips

    i = np.arange(m_cap)
    nm1 = np.maximum(counts - 1, 0)[:, None]
    down = i[None, :] * nm1 // np.maximum(m_eff - 1, 1)[:, None]
    keep = np.where(counts[:, None] <= max_obs, np.minimum(i, nm1), down)
    if max_obs <= 3:
        # scalar special case: [0, n//2, n-1]
        special = np.stack(
            [np.zeros(T, np.int64), counts // 2, nm1[:, 0]], axis=1
        )
        keep = np.where(
            (counts[:, None] > max_obs), special[:, : m_cap], keep
        )
    keep = np.minimum(keep, nm1)

    td = np.take_along_axis(
        epochs_pad, np.minimum(keep, epochs_pad.shape[1] - 1), axis=1
    )  # (T, m_cap) downsampled epochs

    # combination list in (a, j, k) lexicographic order — matches the scalar
    # enumerator's nonzero order, so stable sort ties resolve identically
    a, j, k = np.meshgrid(
        np.arange(m_cap), np.arange(m_cap), np.arange(m_cap),
        indexing="ij", sparse=True,
    )
    ai, ji, ki = np.nonzero((a < j) & (j < k))
    M = ai.size
    if M == 0:
        return trips, ktrips

    chunk = max(1, int(budget // max(M, 1)))
    for lo in range(0, T, chunk):
        sl = slice(lo, min(lo + chunk, T))
        tdc = td[sl]
        t1 = tdc[:, ai]
        t2 = tdc[:, ji]
        t3 = tdc[:, ki]
        span = t3 - t1
        feas = (
            (ki[None, :] < m_eff[sl, None])
            & (span >= dt_min)
            & (span <= dt_max)
        )
        w = triplet_weight32(t1, t2, t3, optimal_interval)
        w = np.where(feas, w, np.float32(np.inf)).astype(np.float32)
        order = np.argsort(w.view(np.int32), axis=1, kind="stable")[
            :, :max_triplets
        ]
        kc = np.minimum(feas.sum(axis=1), max_triplets)
        kp = keep[sl]
        pad_k = order.shape[1]
        if pad_k < max_triplets:
            order = np.pad(order, ((0, 0), (0, max_triplets - pad_k)))
        trips[sl, :, 0] = np.take_along_axis(kp, ai[order], axis=1)
        trips[sl, :, 1] = np.take_along_axis(kp, ji[order], axis=1)
        trips[sl, :, 2] = np.take_along_axis(kp, ki[order], axis=1)
        ktrips[sl] = kc
    return trips, ktrips


def generate_triplet_indices_device(
    epochs_pad,
    counts,
    dt_min: float,
    dt_max: float,
    optimal_interval: float,
    max_obs: int,
    max_triplets: int,
    m_cap: int = None,
):
    """Device-side :func:`generate_triplet_indices_batch` (jitted).

    Same best-K set and order: argmin's first-minimum rule breaks ties by
    lower index, which equals the stable ascending-(w32, a, j, k) order
    because the combination list is enumerated in (a, j, k) lexicographic
    order.  Inputs must be device/bucketed arrays (``epochs_pad``
    (T, n_max), ``counts`` (T,) int32); returns (trips (T, K, 3) int32,
    ktrips (T,)).
    """
    import jax

    return _enum_device_jit(
        epochs_pad,
        counts,
        dt_min=float(dt_min),
        dt_max=float(dt_max),
        dtw=float(optimal_interval),
        max_obs=int(max_obs),
        max_triplets=int(max_triplets),
        m_cap=None if m_cap is None else int(m_cap),
    )


def _enum_device(epochs_pad, counts, *, dt_min, dt_max, dtw, max_obs,
                 max_triplets, m_cap=None):
    """``m_cap`` (static) tightens the combination space to the dataset's
    bucketed max observation count — the combination count is C(m_cap, 3),
    so a dataset with <=24 obs/trajectory in 32-wide padding runs 2.4x
    fewer weight evaluations."""
    import jax
    import jax.numpy as jnp

    T, n_max = epochs_pad.shape
    cap = n_max if m_cap is None else min(m_cap, n_max)
    m_cap = min(cap, 3 if max_obs <= 3 else max_obs)
    if m_cap < 3:
        return (
            jnp.zeros((T, max_triplets, 3), jnp.int32),
            jnp.zeros((T,), jnp.int32),
        )
    a, j, k = np.meshgrid(
        np.arange(m_cap), np.arange(m_cap), np.arange(m_cap),
        indexing="ij", sparse=True,
    )
    ai, ji, ki = np.nonzero((a < j) & (j < k))  # static, lex (a, j, k) order

    counts = counts.astype(jnp.int32)
    m_eff = jnp.where(counts <= max_obs, counts, 3 if max_obs <= 3 else max_obs)
    m_eff = jnp.minimum(m_eff, counts)
    i = jnp.arange(m_cap, dtype=jnp.int32)
    nm1 = jnp.maximum(counts - 1, 0)[:, None]
    down = i[None, :] * nm1 // jnp.maximum(m_eff - 1, 1)[:, None]
    keep = jnp.where(counts[:, None] <= max_obs, jnp.minimum(i, nm1), down)
    if max_obs <= 3:
        special = jnp.stack(
            [jnp.zeros_like(counts), counts // 2, nm1[:, 0]], axis=1
        )
        keep = jnp.where(counts[:, None] > max_obs, special[:, :m_cap], keep)
    keep = jnp.minimum(keep, nm1)

    td = jnp.take_along_axis(epochs_pad, jnp.minimum(keep, n_max - 1), axis=1)

    C = ai.size
    k_eff = min(max_triplets, C)

    # --- quantized-weight top-K -------------------------------------------
    # Selection orders candidates by the f32-QUANTIZED weight's int32 bit
    # pattern (monotonic for the non-negative weights incl. +inf; see
    # triplet_weight32) with argmin's first-minimum rule as the
    # ascending-index tie-break — the same (w32, a, j, k) lex order the
    # numpy enumerators produce with a stable argsort on the bits.  The
    # f32 weight sweep replaced an f64 one whose s_gap divisions made the
    # C(m,3) grid the largest real-cadence IOD sweep, and the argmin
    # passes compare int32.  Cross-platform caveat: a backend whose f32
    # division is not correctly rounded can order physical near-ties
    # (weights within ~1 ulp) differently from the CPU/numpy paths;
    # ordering is deterministic within each platform, and either member
    # of such a tie is an equally good Gauss triplet.
    # (Two rejected shapes: lax.top_k lowers to a full variadic sort, and
    # a block-decomposed top-K with per-row block repair lowers its
    # row-indexed gathers to serialized general gathers.)
    dtw32 = np.float32(dtw)
    inv32 = np.float32(1.0 / dtw)
    one32 = np.float32(1.0)
    tiny32 = _W32_TINY

    t1 = td[:, ai]
    t2 = td[:, ji]
    t3 = td[:, ki]
    span = t3 - t1
    feas = (
        (jnp.asarray(ki, jnp.int32)[None, :] < m_eff[:, None])
        & (span >= dt_min)
        & (span <= dt_max)
    )

    def s_gap(dt64):
        g = dt64.astype(jnp.float32)
        return jnp.where(
            g <= dtw32, dtw32 / jnp.maximum(g, tiny32), one32 + g * inv32
        )

    w32 = jnp.minimum(s_gap(t2 - t1) + s_gap(t3 - t2), _W32_CAP)
    w32 = jnp.where(feas, w32, jnp.float32(jnp.inf))
    wbits = jax.lax.bitcast_convert_type(w32, jnp.int32)
    # materialize the bit grid once: the K argmin passes then stream int32
    # from HBM instead of re-running the divisions per pass
    wbits = jax.lax.optimization_barrier(wbits)

    ktrips = jnp.minimum(jnp.sum(feas, axis=1), max_triplets).astype(jnp.int32)

    iot = jax.lax.broadcasted_iota(jnp.int32, (1, C), 1)
    excl = jnp.int32(np.int32(2**31 - 1))  # sorts after +inf bits
    sel_cols = []
    for _ in range(k_eff):
        wm = wbits
        for prev in sel_cols:
            wm = jnp.where(iot == prev[:, None], excl, wm)
        sel_cols.append(jnp.argmin(wm, axis=1).astype(jnp.int32))
    sel = jnp.stack(sel_cols, axis=1)
    trips = jnp.stack(
        [
            jnp.take_along_axis(keep, jnp.asarray(idx, jnp.int32)[sel], axis=1)
            for idx in (ai, ji, ki)
        ],
        axis=-1,
    ).astype(jnp.int32)
    if k_eff < max_triplets:
        trips = jnp.pad(trips, ((0, 0), (0, max_triplets - k_eff), (0, 0)))
    return trips, ktrips


import functools as _functools  # noqa: E402

try:  # jit lazily so numpy-only consumers don't pull in jax
    import jax as _jax

    _enum_device_jit = _functools.partial(
        _jax.jit,
        static_argnames=("dt_min", "dt_max", "dtw", "max_obs", "max_triplets", "m_cap"),
    )(_enum_device)
except Exception:  # pragma: no cover
    _enum_device_jit = _enum_device


def select_rms_interval(
    epochs: np.ndarray, idx1: int, idx3: int, extf: float, dtmax: float
) -> Tuple[int, int]:
    """RMS-window [start, end] (inclusive) around a triplet.

    Parity: ``select_rms_interval`` (trajectory.rs:294-350): extf x triplet
    span, or 10 x full arc when extf < 0, floored at dtmax.
    """
    w0, w1 = select_rms_interval_batch(
        epochs, np.asarray([idx1]), np.asarray([idx3]), extf, dtmax
    )
    return int(w0[0]), int(w1[0])


def select_rms_interval_batch(
    epochs: np.ndarray, idx1: np.ndarray, idx3: np.ndarray, extf: float,
    dtmax: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized :func:`select_rms_interval` over many triplets at once.

    ``epochs`` sorted ascending; ``idx1``/``idx3`` arrays of triplet
    first/last indices.  Returns (start, end) index arrays (inclusive).
    """
    epochs = np.asarray(epochs)
    idx1 = np.asarray(idx1)
    idx3 = np.asarray(idx3)
    if extf >= 0.0:
        dt = (epochs[idx3] - epochs[idx1]) * extf
    else:
        dt = np.full(idx1.shape, 10.0 * (epochs[-1] - epochs[0]))
    if dtmax >= 0.0:
        dt = np.maximum(dt, dtmax)
    # first index with epochs[i] >= epochs[idx1] - dt
    i_start = np.searchsorted(epochs, epochs[idx1] - dt, side="left")
    # last index with epochs[i] <= epochs[idx3] + dt
    i_end = np.searchsorted(epochs, epochs[idx3] + dt, side="right") - 1
    return i_start, np.maximum(i_end, idx3)
