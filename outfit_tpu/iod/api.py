"""User-facing IOD API: fit_full_iod over a whole dataset.

Behavioral parity with the reference's ``FitIOD`` trait
(``src/initial_orbit_determination/obs_dataset_api.rs``) and
``estimate_best_orbit`` (``trajectory.rs:429-545``):

* prepare: error model -> batch RMS correction -> observer cache
  (``prepare_iod`` :254-275),
* per-trajectory deterministic noise (the reference XORs a base seed with a
  stable trajectory hash, :277-296; here: jax.random fold_in with a
  CRC32 of the trajectory id — same contract: results independent of
  trajectory order and parallel schedule),
* triplets x (1 + n_noise_realizations) Monte-Carlo lanes, Gauss candidates,
  RMS scoring over the triplet window, best-orbit argmin.

Batch-first: every trajectory's lanes are flattened into ONE device batch;
a single jitted kernel processes all trajectories of a dataset at once.
The lane batch is the axis to shard across devices (outfit_tpu.parallel).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from outfit_tpu.constants import ROT_EQUMJ2000_TO_ECLMJ2000
from outfit_tpu.errors import NoFeasibleTriplets, NoViableOrbit
from outfit_tpu.elements.orb_elem import KIND_KEPLERIAN, ccek1
from outfit_tpu.elements.types import (
    CometaryElements,
    EquinoctialElements,
    KeplerianElements,
    cometary_to_equinoctial,
    keplerian_to_equinoctial,
)
from outfit_tpu.iod.gauss import (
    GaussTriplets,
    candidates_to_elements,
    gauss_candidates,
    polish_selected,
)
from outfit_tpu.iod.params import IODParams
from outfit_tpu.iod.scoring import rms_orbit_error
from outfit_tpu.iod.triplets import generate_triplet_indices_device
from outfit_tpu.observations.error_model import ErrorModel
from outfit_tpu.observer.cache import ObserverCache
from outfit_tpu.time.scales import Ut1Provider
from outfit_tpu.utils.linalg import rotate3


@dataclass(slots=True)
class FitResult:
    """Per-trajectory IOD outcome (parity: FitOrbitResult::IODGauss).

    ``slots=True``: one instance per trajectory on the finalize critical
    path (see LsqResult)."""

    traj_id: str
    ok: bool
    error: Optional[str] = None
    rms: float = float("inf")
    corrected: bool = False
    epoch: float = 0.0
    kind: int = KIND_KEPLERIAN  # 0 = Keplerian, 1 = Cometary (ccek1 output)
    elements: Optional[np.ndarray] = None  # (6,) ccek1 element set
    equinoctial: Optional[np.ndarray] = None  # (6,) a,h,k,p,q,lambda (ecliptic)

    @property
    def orbit_quality(self) -> float:
        """Scalar fit quality = the windowed IOD RMS.  Parity:
        ``FitOrbitResult::orbit_quality`` (constants.rs:157-162)."""
        return self.rms

    @property
    def orbital_elements(self):
        """ccek1 element set (Keplerian or Cometary per ``kind``); parity:
        ``FitOrbitResult::orbital_elements`` (constants.rs:169-174)."""
        if self.elements is None:
            return None
        e = self.elements
        if self.kind == KIND_KEPLERIAN:
            return KeplerianElements(self.epoch, e[0], e[1], e[2], e[3], e[4], e[5])
        return CometaryElements(self.epoch, e[0], e[1], e[2], e[3], e[4], e[5])

    @property
    def keplerian(self) -> Optional[KeplerianElements]:
        if self.elements is None or self.kind != KIND_KEPLERIAN:
            return None
        e = self.elements
        return KeplerianElements(self.epoch, e[0], e[1], e[2], e[3], e[4], e[5])


def _bucket(n: int, floor: int = 8) -> int:
    """Round up to the next power of two (>= floor): ragged trajectories
    land in a handful of padded shapes instead of recompiling per dataset
    (SURVEY hard-part #3 bucketing policy)."""
    b = floor
    while b < n:
        b *= 2
    return b


def _bucket_width(cw):
    """Observation-axis width ladder: powers of two up to 32, then
    quarter-octave steps (granularity 2^(k-2) within [2^k, 2^(k+1))).

    Unlike the trajectory axis (latency-bound while loops, ~flat in rows),
    every padded obs COLUMN costs real elementwise work per lane at survey
    widths — a 129-obs arc must not pay a 256-wide kernel.  Quarter-octave
    steps cap the padding waste at ~25% while keeping the compile-shape
    variety bounded (4 shapes per doubling)."""
    cw = np.maximum(np.asarray(cw, np.int64), 1)
    k = np.floor(np.log2(cw)).astype(np.int64)
    g = np.maximum(8, 1 << np.maximum(k - 2, 0))
    quarter = -(-cw // g) * g
    pow2 = 1 << np.ceil(np.log2(cw)).astype(np.int64)
    return np.maximum(8, np.where(cw <= 32, pow2, quarter))


def stable_hash(traj_id: str) -> int:
    """Order-stable trajectory hash (determinism contract,
    obs_dataset_api.rs:277-296)."""
    return zlib.crc32(traj_id.encode("utf-8"))


@dataclass
class PaddedDatasetArrays:
    """(T, n_max) per-trajectory padded views of a whole dataset, built with
    one lexsort + vectorized scatters (no per-trajectory Python loops — the
    host-prep bottleneck at survey scale, docs/DESIGN.md)."""

    counts: np.ndarray  # (T,) observations per trajectory
    n_max: int  # bucketed padded width
    mjd: np.ndarray  # (T, n_max) epoch-sorted
    ra: np.ndarray
    dec: np.ndarray
    sra: np.ndarray  # padded slots = 1.0 (benign weights)
    sdec: np.ndarray
    helio: np.ndarray  # (T, n_max, 3)
    valid: np.ndarray  # (T, n_max) bool
    glob_idx: np.ndarray  # (T, n_max) global observation index per slot
    bias_ra: Optional[np.ndarray] = None  # (T, n_max) debiasing, radians
    bias_dec: Optional[np.ndarray] = None


def _storage_order(dataset) -> np.ndarray:
    """Stable (trajectory, epoch) sort order of the dataset's storage rows.

    Fast path: ingestion (MPC files, dataframes, synthetic builders) usually
    stores observations already grouped by trajectory and time-sorted within
    — an O(n) check that is ~50x cheaper than the 2-key lexsort at survey
    scale (the lexsort was the single largest host-prep line item)."""
    mjd, ti = dataset.mjd_tt, dataset.traj_index
    n = len(mjd)
    if n == 0:
        return np.arange(0)
    grouped = ti[1:] >= ti[:-1]
    if grouped.all():
        if ((mjd[1:] >= mjd[:-1]) | (ti[1:] != ti[:-1])).all():
            return np.arange(n)
    return np.lexsort((mjd, ti))


def padded_dataset_arrays(
    dataset, helio: Optional[np.ndarray] = None, with_values: bool = True
) -> PaddedDatasetArrays:
    """Build the padded per-trajectory layout for every trajectory, in
    ``traj_ids`` order.  ``helio`` is the observer-cache heliocentric
    position table aligned with dataset storage order.

    ``with_values=False`` returns only the LAYOUT (counts, epochs, valid,
    glob_idx) — callers that gather observation values on device (the IOD
    path) skip the value scatters and the helio device->host download.
    The layout variant is memoized on the dataset (fit_full_iod and
    fit_lsq share one lexsort per dataset)."""
    # layout is always resolved through the memo: the value path reuses the
    # cached lexsort instead of re-deriving order/counts/starts (one layout
    # computation per dataset, period)
    key = (len(dataset.mjd_tt), dataset.mjd_tt, dataset.traj_index,
           dataset.n_trajectories)
    hit = getattr(dataset, "_layout_cache", None)
    if (
        hit is not None
        and hit[0][0] == key[0]
        and hit[0][3] == key[3]
        and hit[0][1] is key[1]
        and hit[0][2] is key[2]
    ):
        lay = hit[1]
    else:
        lay = _padded_layout_impl(dataset)
        try:
            dataset._layout_cache = (key, lay)
        except Exception:
            pass
    if not with_values:
        return lay

    # value scatters derived from the layout: valid selects the populated
    # (trajectory, slot) cells row-major, glob_idx maps each back to its
    # dataset storage row
    v = lay.valid
    gi = lay.glob_idx[v]

    def _scatter(src, fill=0.0):
        out = np.full(v.shape, fill)
        out[v] = src[gi]
        return out

    helio_pad = np.zeros((*v.shape, 3))
    helio_pad[v] = np.asarray(helio)[gi]
    return PaddedDatasetArrays(
        counts=lay.counts,
        n_max=lay.n_max,
        mjd=lay.mjd,
        ra=_scatter(dataset.ra),
        dec=_scatter(dataset.dec),
        sra=_scatter(dataset.ra_error, fill=1.0),
        sdec=_scatter(dataset.dec_error, fill=1.0),
        helio=helio_pad,
        valid=v,
        glob_idx=lay.glob_idx,
        bias_ra=None if dataset.bias_ra is None else _scatter(dataset.bias_ra),
        bias_dec=None if dataset.bias_dec is None else _scatter(dataset.bias_dec),
    )


def _padded_layout_impl(dataset) -> PaddedDatasetArrays:
    """Layout-only build: one lexsort + the index/validity scatters."""
    n = len(dataset.mjd_tt)
    Tall = dataset.n_trajectories
    order = _storage_order(dataset)
    ti_sorted = dataset.traj_index[order]
    counts = np.bincount(ti_sorted, minlength=Tall)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n) - starts[ti_sorted]
    n_max = _bucket(int(counts.max(initial=1)))
    mjd = np.zeros((Tall, n_max))
    mjd[ti_sorted, pos] = dataset.mjd_tt[order]
    valid = np.zeros((Tall, n_max), dtype=bool)
    valid[ti_sorted, pos] = True
    glob_idx = np.zeros((Tall, n_max), np.int64)
    glob_idx[ti_sorted, pos] = order
    return PaddedDatasetArrays(
        counts=counts,
        n_max=n_max,
        mjd=mjd,
        ra=None,
        dec=None,
        sra=None,
        sdec=None,
        helio=None,
        valid=valid,
        glob_idx=glob_idx,
    )


def device_base_arrays(dataset, cache):
    """Device copies of the dataset-order base observation arrays, padded
    to a power-of-two length (dataset size never recompiles the gather
    kernels).  Returns ``(mjd, ra, dec, sra, sdec, helio, bias_ra,
    bias_dec)``; bias entries are None when the dataset carries no bias.

    Memoized ON the dataset (keyed by the constituent array identities, so
    apply_error_model / batch-RMS / set_bias — which all rebind the arrays
    — invalidate it): fit_full_iod and fit_lsq share one upload.
    """
    # keyed by the constituent arrays THEMSELVES (identity, with references
    # retained so a freed-and-reallocated array can never recycle an id into
    # a false hit).  API mutators (apply_error_model / batch-RMS / set_bias /
    # push_observation) all REBIND these arrays; direct in-place mutation of
    # dataset columns requires dataset.invalidate_caches().
    key = (
        len(dataset.mjd_tt),
        dataset.mjd_tt,
        dataset.ra,
        dataset.dec,
        dataset.ra_error,
        dataset.dec_error,
        cache.helio_pos_pad,
        dataset.bias_ra,
        dataset.bias_dec,
    )
    hit = getattr(dataset, "_device_base_cache", None)
    if (
        hit is not None
        and hit[0][0] == key[0]
        and all(a is b for a, b in zip(hit[0][1:], key[1:]))
    ):
        return hit[1]
    nb = _bucket(len(dataset.mjd_tt))
    pad_n = nb - len(dataset.mjd_tt)

    def _pad(x, fill=0.0):
        return jnp.asarray(np.concatenate([x, np.full(pad_n, fill)]))

    with_bias = dataset.bias_ra is not None
    base = (
        _pad(dataset.mjd_tt),
        _pad(dataset.ra),
        _pad(dataset.dec),
        _pad(dataset.ra_error, 1.0),
        _pad(dataset.dec_error, 1.0),
        # the cache's padded device array IS bucket-length nb already (both
        # use the power-of-two bucket of the observation count): no eager
        # slice/concat ops, which each cost a dispatch
        cache.helio_pos_pad
        if cache.helio_pos_pad.shape[0] == nb
        else jnp.concatenate(
            [cache.helio_pos_equ, jnp.zeros((pad_n, 3))], axis=0
        ),
        _pad(dataset.bias_ra) if with_bias else None,
        _pad(dataset.bias_dec) if with_bias else None,
    )
    try:
        dataset._device_base_cache = (key, base)
    except Exception:
        pass
    return base


def _draw_noise(base_key, hashes, max_triplets, n_real):
    z = jax.vmap(
        lambda h: jax.random.normal(
            jax.random.fold_in(base_key, h), (max_triplets, n_real, 3, 2)
        )
    )(hashes)
    return z.at[:, :, 0].set(0.0)  # realization 0 = exact triplet


_draw_noise_jit = jax.jit(_draw_noise, static_argnames=("max_triplets", "n_real"))


def _iod_kernel_gather(
    base,  # (mjd, ra, dec, sra, sdec, helio) dataset-order device arrays
    glob_idx_g,  # (Tb, n_max) int32 observation slot -> dataset index
    valid_g,  # (Tb, n_max) bool
    tr_g,  # (Sb, 3) int32 triplet global observation indices
    tk_t_g,  # (Sb,) int32 trajectory row within the group
    tk_glob_g,  # (Sb,) int32 kept-trajectory row into z_all
    tk_k_g,  # (Sb,) int32 triplet rank within its trajectory
    wlo_g,  # (Sb,) RMS-window epoch bounds (inf/-inf on padded rows)
    whi_g,
    z_all,  # (hb, max_triplets, n_real, 3, 2) Monte-Carlo draws
    params: IODParams,
):
    """Device-side lane assembly + IOD kernel.

    The host uploads INDICES (int32) and the dataset-order base arrays
    once; triplet lanes, Monte-Carlo noise application, padded observation
    tables, and RMS-window masks are all gathered/computed on device,
    instead of uploading ~20 MB of materialized lanes per 8k-trajectory
    batch.
    """
    obs_arrays = _gather_obs_tables(base, glob_idx_g, valid_g)
    z = z_all[tk_glob_g, tk_k_g]  # (Sb, n_real, 3, 2)
    tri, lane_traj, window_mask = _assemble_lanes(
        base, tr_g, z, tk_t_g, obs_arrays[0], valid_g, wlo_g, whi_g, params
    )
    return _iod_kernel(tri, obs_arrays, lane_traj, window_mask, params)


def _gather_obs_tables(base, glob_idx_g, valid_g):
    """Padded per-trajectory observation tables from the dataset-order base
    arrays (pad slots: 0 / sigma 1).  Shared by the gather and dense kernel
    entries so the two dispatch modes cannot drift apart."""
    mjd_b, ra_b, dec_b, sra_b, sdec_b, helio_b = base
    obs_mjd = jnp.where(valid_g, mjd_b[glob_idx_g], 0.0)
    obs_ra = jnp.where(valid_g, ra_b[glob_idx_g], 0.0)
    obs_dec = jnp.where(valid_g, dec_b[glob_idx_g], 0.0)
    obs_sra = jnp.where(valid_g, sra_b[glob_idx_g], 1.0)
    obs_sdec = jnp.where(valid_g, sdec_b[glob_idx_g], 1.0)
    obs_helio = jnp.where(valid_g[..., None], helio_b[glob_idx_g], 0.0)
    return (obs_mjd, obs_ra, obs_dec, obs_sra, obs_sdec, obs_helio)


def _assemble_lanes(base, g3, z, tk_t, obs_mjd, valid_g, wlo_s, whi_s, params):
    """(triplet x realization) lane arrays from per-triplet global index
    rows.  ``g3``: (S, 3) dataset-order observation indices per triplet;
    ``z``: (S, n_real, 3, 2) noise draws; ``tk_t``: (S,) padded-trajectory
    row per triplet; ``wlo_s``/``whi_s``: (S,) RMS-window epoch bounds
    (epoch-interval form of select_rms_interval).  Shared by the gather and
    dense kernel entries.  Returns (tri, lane_traj, window_mask)."""
    mjd_b, ra_b, dec_b, sra_b, sdec_b, helio_b = base
    n_real = params.n_noise_realizations + 1
    ns = params.noise_scale
    S = g3.shape[0]
    L = S * n_real
    lane_ra = (
        ra_b[g3][:, None, :] + z[..., 0] * sra_b[g3][:, None, :] * ns
    ).reshape(L, 3)
    lane_dec = (
        dec_b[g3][:, None, :] + z[..., 1] * sdec_b[g3][:, None, :] * ns
    ).reshape(L, 3)
    lane_t = jnp.broadcast_to(
        mjd_b[g3][:, None, :], (S, n_real, 3)
    ).reshape(L, 3)
    lane_pos = jnp.broadcast_to(
        helio_b[g3][:, None, :, :], (S, n_real, 3, 3)
    ).reshape(L, 3, 3)
    lane_traj = jnp.repeat(tk_t, n_real, total_repeat_length=L)

    wmask_tri = (
        (obs_mjd[tk_t] >= wlo_s[:, None])
        & (obs_mjd[tk_t] <= whi_s[:, None])
        & valid_g[tk_t]
    )
    window_mask = jnp.repeat(wmask_tri, n_real, axis=0, total_repeat_length=L)
    tri = GaussTriplets(lane_ra, lane_dec, lane_t, lane_pos)
    return tri, lane_traj, window_mask


_iod_kernel_gather_jit = jax.jit(_iod_kernel_gather, static_argnames=("params",))


def _enum_chunk(
    base, glob_idx_g, valid_g, counts_g, params: IODParams, m_cap: int = None
):
    """Device triplet enumeration for one chunk, dispatched SEPARATELY
    from the dense kernel: fused into the big program, XLA's scheduling of
    the C(m,3) argmin sweeps materialized ~8 grid-sized f32 buffers
    (attributed in the HLO) — standalone they fuse into streaming passes.  Output is tiny ((Tb, K, 3) int32 + (Tb,)), so the
    extra dispatch costs one async launch, no host sync."""
    from outfit_tpu.iod.triplets import _enum_device

    mjd_b = base[0]
    obs_mjd = jnp.where(valid_g, mjd_b[glob_idx_g], 0.0)
    return _enum_device(
        obs_mjd,
        counts_g,
        dt_min=params.dt_min,
        dt_max=params.dt_max_triplet,
        dtw=params.optimal_interval_time,
        max_obs=params.max_obs_for_triplets,
        max_triplets=params.max_triplets,
        m_cap=m_cap,
    )


_enum_chunk_jit = jax.jit(_enum_chunk, static_argnames=("params", "m_cap"))


def _iod_kernel_dense(
    base,  # (mjd, ra, dec, sra, sdec, helio) dataset-order device arrays
    glob_idx_g,  # (Tb, n_max) int32
    valid_g,  # (Tb, n_max) bool
    counts_g,  # (Tb,) int32 observations per trajectory (0 on padding)
    z_off,  # scalar int32: chunk offset into z_all's kept-trajectory axis
    z_all,  # (hb, max_triplets, n_real, 3, 2)
    params: IODParams,
    m_cap: int = None,
    trips_in=None,  # optional precomputed (trips, ktrips) from _enum_chunk
):
    """Fully fused IOD: triplet enumeration + lane assembly + kernel in ONE
    device dispatch (dense (trajectory x max_triplets) lane grid).

    Used when most trajectories realize close to ``max_triplets`` feasible
    triplets (the survey steady state) — no intermediate host round-trips
    at all.  Trajectories with fewer triplets mask the excess lanes
    (window empty -> inf score).  The ragged host path remains for sparse
    regimes where a dense grid would waste most lanes.

    ``trips_in``: enumeration results from :func:`_enum_chunk` (a separate
    async dispatch — see its docstring for why); None enumerates inline.
    """
    from outfit_tpu.iod.triplets import _enum_device

    K = params.max_triplets
    Tb, n_max = glob_idx_g.shape

    obs_arrays = _gather_obs_tables(base, glob_idx_g, valid_g)
    obs_mjd = obs_arrays[0]

    if trips_in is not None:
        trips, ktrips = trips_in
    else:
        trips, ktrips = _enum_device(
            obs_mjd,
            counts_g,
            dt_min=params.dt_min,
            dt_max=params.dt_max_triplet,
            dtw=params.optimal_interval_time,
            max_obs=params.max_obs_for_triplets,
            max_triplets=K,
            m_cap=m_cap,
        )  # (Tb, K, 3) local slots, (Tb,)

    # RMS windows (select_rms_interval epoch-interval form)
    te1 = jnp.take_along_axis(obs_mjd, trips[..., 0], axis=1)  # (Tb, K)
    te3 = jnp.take_along_axis(obs_mjd, trips[..., 2], axis=1)
    last = jnp.maximum(counts_g - 1, 0)[:, None]
    arc = jnp.take_along_axis(obs_mjd, last, axis=1)[:, 0] - obs_mjd[:, 0]
    if params.extf >= 0.0:
        dt = (te3 - te1) * params.extf
    else:
        dt = 10.0 * arc[:, None] * jnp.ones_like(te1)
    if params.dtmax >= 0.0:
        dt = jnp.maximum(dt, params.dtmax)
    k_ok = jnp.arange(K, dtype=jnp.int32)[None, :] < ktrips[:, None]
    wlo = jnp.where(k_ok, te1 - dt, jnp.inf)
    whi = jnp.where(k_ok, te3 + dt, -jnp.inf)

    # dense lane grid: S = Tb * K triplets
    S = Tb * K
    g_flat = jnp.take_along_axis(
        glob_idx_g, trips.reshape(Tb, K * 3), axis=1
    ).reshape(S, 3)
    tk_t = jnp.repeat(
        jnp.arange(Tb, dtype=jnp.int32), K, total_repeat_length=S
    )
    tk_k = jnp.tile(jnp.arange(K, dtype=jnp.int32), Tb)
    z = z_all[tk_t + z_off, tk_k]  # (S, n_real, 3, 2)
    tri, lane_traj, window_mask = _assemble_lanes(
        base, g_flat, z, tk_t, obs_mjd, valid_g, wlo.reshape(S), whi.reshape(S), params
    )
    out = _iod_kernel(tri, obs_arrays, lane_traj, window_mask, params)
    # the realized triplet count rides along so the sync-free dispatch mode
    # can classify NoFeasibleTriplets rows without an early enumeration fetch
    return out + (ktrips,)


_iod_kernel_dense_jit = jax.jit(
    _iod_kernel_dense, static_argnames=("params", "m_cap")
)


def _lane_select(rms, valid, corrected):
    """Per-lane candidate choice: corrected-preferred, then min RMS.

    Parity: ``prelim_orbit`` corrected-first policy (gauss.rs:1238-1247)
    with min-RMS tie-breaking instead of solver discovery order.
    """
    finite = jnp.isfinite(rms)
    corr_ok = corrected & valid & finite
    any_corr = jnp.any(corr_ok, axis=-1, keepdims=True)
    eligible = jnp.where(any_corr, corr_ok, valid & finite)
    score = jnp.where(eligible, rms, jnp.inf)
    best = jnp.argmin(score, axis=-1)
    best_rms = jnp.take_along_axis(score, best[..., None], axis=-1)[..., 0]
    return best, best_rms


def _to_equinoctial(kind, el, epoch, relevant=None):
    """Element-set-aware equinoctial conversion (Keplerian or hyperbolic
    Cometary), masked per lane.

    The Cometary branch is a chain of f64 transcendentals
    (sinh/atanh/tan through cometary->keplerian->equinoctial) that
    compiles to thousand-op fusions — for a branch that all-elliptic workloads never
    take.  It is therefore ``lax.cond``-gated on a RELEVANT cometary lane
    actually existing; ``relevant`` marks lanes whose output is consumed
    downstream (invalid/padding lanes score inf or are masked by the
    caller, so their values are dead either way).  Keplerian lanes are
    bitwise identical with or without the gate (the computed
    ``eq_from_kep`` arrays pass through the ``where`` unmodified);
    relevant cometary lanes always force the branch on (their own flag
    drives ``jnp.any``) and match the ungated form to <=1 ulp — the
    ``lax.cond`` branch is lowered as a separate XLA computation with
    its own fusion choices (same class of noise as the documented
    batch-shape lowering noise, utils/linalg.py).  Batch isolation is
    preserved: a relevant lane's value never depends on which other
    lanes share its batch.
"""
    kep = KeplerianElements(
        epoch, el[..., 0], el[..., 1], el[..., 2], el[..., 3], el[..., 4], el[..., 5]
    )
    eq_from_kep = keplerian_to_equinoctial(kep)
    is_kep = kind == KIND_KEPLERIAN
    need_com = ~is_kep if relevant is None else (~is_kep & relevant)

    def _with_cometary(kep_fields):
        com = CometaryElements(
            epoch, el[..., 0], el[..., 1], el[..., 2], el[..., 3], el[..., 4], el[..., 5]
        )
        eq_from_com = cometary_to_equinoctial(com)
        return tuple(
            jnp.where(is_kep, a, jnp.where(jnp.isfinite(b), b, 0.0))
            for a, b in zip(kep_fields, eq_from_com[1:])
        )

    fields = jax.lax.cond(
        jnp.any(need_com),
        _with_cometary,
        lambda kep_fields: kep_fields,
        tuple(eq_from_kep[1:]),
    )
    return EquinoctialElements(epoch, *fields)


def _iod_kernel(tri: GaussTriplets, obs_arrays, lane_traj, window_mask, params: IODParams):
    """Jitted core: candidates -> elements -> scores -> per-lane best.

    ``params.precision == "mixed"`` runs root-finding, the f-g correction
    loop, and RMS scoring in f32, selects the winner, then recovers f64
    accuracy for that
    single candidate per lane via :func:`polish_selected` + an f64 rescore.
    Times (MJD epochs) stay f64 throughout — only day-scale differences are
    cast down (f32 cannot hold an absolute MJD to better than ~6 minutes).
    """
    mixed = params.precision == "mixed"
    cands = gauss_candidates(
        tri, params, work_dtype=jnp.float32 if mixed else None
    )
    state_elems = candidates_to_elements(cands)

    kind = state_elems.kind  # (L, K)
    el = state_elems.elements  # (L, K, 6)
    # invalid candidates are masked out of selection (_lane_select), so only
    # valid lanes' conversions are live
    eq = _to_equinoctial(kind, el, cands.epoch, relevant=cands.valid)

    mjd, ra, dec, sra, sdec, helio = obs_arrays
    if mixed:
        ra, dec, sra, sdec, helio = (
            x.astype(jnp.float32) for x in (ra, dec, sra, sdec, helio)
        )
    N = mjd.shape[1]
    S = int(params.selection_subsample)
    subsampled = 0 < S < N
    if subsampled:
        # SELECTION-window subsample (opt-in; see IODParams docstring):
        # the window mask is contiguous over the left-packed valid
        # observations (epoch-interval form, _assemble_lanes), so a
        # uniform-with-edges pick over [wlo, wlo+cnt-1] mirrors the
        # triplet downsampler's policy (index_generator.rs:66-75).  When
        # cnt <= S the subsample IS the window (bitwise-identical
        # scoring); otherwise S distinct indices (the floor-division
        # steps are >= 1 when cnt-1 >= S-1).
        wlo = jnp.argmax(window_mask, axis=-1).astype(jnp.int32)  # (L,)
        cnt = jnp.sum(window_mask, axis=-1).astype(jnp.int32)
        s_ar = jnp.arange(S, dtype=jnp.int32)[None, :]  # (1, S)
        j = jnp.where(
            cnt[:, None] <= S,
            s_ar,
            s_ar * (cnt[:, None] - 1) // (S - 1),
        )
        pos = wlo[:, None] + jnp.minimum(j, jnp.maximum(cnt[:, None] - 1, 0))
        pos = jnp.minimum(pos, N - 1)
        sub_mask = s_ar < cnt[:, None]
        sub = lambda x: jnp.take_along_axis(x[lane_traj], pos, axis=1)
        obs_mjd = sub(mjd)[:, None, :]  # (L, 1, S)
        obs_ra = sub(ra)[:, None, :]
        obs_dec = sub(dec)[:, None, :]
        obs_sra = sub(sra)[:, None, :]
        obs_sdec = sub(sdec)[:, None, :]
        obs_helio = jnp.take_along_axis(
            helio[lane_traj], pos[..., None], axis=1
        )[:, None, :, :]
        wmask = sub_mask[:, None, :]
    else:
        obs_mjd = mjd[lane_traj][:, None, :]  # (L, 1, N)
        obs_ra = ra[lane_traj][:, None, :]
        obs_dec = dec[lane_traj][:, None, :]
        obs_sra = sra[lane_traj][:, None, :]
        obs_sdec = sdec[lane_traj][:, None, :]
        obs_helio = helio[lane_traj][:, None, :, :]
        wmask = window_mask[:, None, :]

    rms = rms_orbit_error(
        eq, obs_mjd, obs_ra, obs_dec, obs_sra, obs_sdec, obs_helio, wmask
    )  # (L, K)

    best_cand, best_rms = _lane_select(rms, cands.valid, cands.corrected)

    take = lambda x: jnp.take_along_axis(
        x, best_cand.reshape(best_cand.shape + (1,) * (x.ndim - 1)), axis=1
    )[:, 0]

    # --- per-TRAJECTORY winner (segment argmin over the ragged lane axis) ---
    # the caller only ever uses the best lane per trajectory, so the f64
    # polish/rescore and the device->host transfer run on T lanes, not T*K
    L = best_rms.shape[0]
    T = mjd.shape[0]
    seg_min = jnp.full(T, jnp.inf, best_rms.dtype).at[lane_traj].min(
        best_rms, mode="drop"
    )
    finite = jnp.isfinite(best_rms)
    is_best = finite & (best_rms <= seg_min[lane_traj])
    lane_ids = jnp.arange(L, dtype=jnp.int32)
    sel = (
        jnp.full(T, L, jnp.int32)
        .at[lane_traj]
        .min(jnp.where(is_best, lane_ids, L), mode="drop")
    )
    has = sel < L  # trajectory produced at least one finite-scored lane
    sel = jnp.minimum(sel, L - 1)

    gather = lambda x: take(x)[sel]
    rms_t = jnp.where(has, seg_min.astype(jnp.float64), jnp.inf)

    if not mixed:
        if subsampled:
            # the REPORTED RMS is always full-window: rescore only the
            # winning lane per trajectory (T rows, not L*K)
            eq_t = EquinoctialElements(*(gather(f) for f in eq))
            rms_full = rms_orbit_error(
                eq_t, mjd, ra, dec, sra, sdec, helio, window_mask[sel]
            )
            rms_t = jnp.where(has & jnp.isfinite(rms_full), rms_full, jnp.inf)
        return (
            rms_t,
            gather(kind),
            gather(el),
            gather(eq.vector),
            gather(cands.epoch),
            gather(cands.corrected) & has,
        )

    # --- f64 polish + rescore of the single winning lane per trajectory -----
    tri_t = GaussTriplets(*(f[sel] for f in tri))
    ppos, pvel, pepoch, pcorr = polish_selected(
        tri_t,
        gather(cands.r2),
        gather(cands.pos),
        gather(cands.vel),
        gather(cands.epoch),
        gather(cands.corrected),
        gather(cands.chi1),
        gather(cands.chi2),
        params,
        params.polish_max_it,
    )
    rot = jnp.asarray(ROT_EQUMJ2000_TO_ECLMJ2000)
    kind64, el64 = ccek1(
        rotate3(rot, ppos[..., 1, :]),
        rotate3(rot, pvel),
    )
    # trajectories without a finite-scored lane (has=False) carry junk
    # elements that the finalize step drops — their conversion is dead
    eq64 = _to_equinoctial(kind64, el64, pepoch, relevant=has)
    mjd64, ra64, dec64, sra64, sdec64, helio64 = obs_arrays
    rms64 = rms_orbit_error(
        eq64, mjd64, ra64, dec64, sra64, sdec64, helio64, window_mask[sel]
    )
    best64 = jnp.where(has & jnp.isfinite(rms_t), rms64, jnp.inf)
    return (best64, kind64, el64, eq64.vector, pepoch, pcorr & has)


_iod_kernel_jit = jax.jit(_iod_kernel, static_argnames=("params",))

#: width-bucket coalescing budget (extra padded observations a merge may
#: cost); module-level so tests can force multi-chunk dispatch on small
#: datasets.  Calibration notes at the use site.
_COALESCE_BUDGET = 131072


def _fit_full_iod_dispatch(
    dataset, ephem, params, seed, ut1, error_model, cache, mesh
):
    """Dispatch half of :func:`fit_full_iod`: runs all host prep and issues
    the device work WITHOUT fetching results.  Returns a state dict with
    ``pending`` (device outputs per chunk; None when everything resolved
    host-side), ``results`` (error entries so far), and the device tables a
    fused follow-up stage (fit_lsq) can reuse."""
    params = params.validated()
    if error_model is not None:
        dataset.apply_error_model(error_model)
        dataset.apply_batch_rms_correction(params.gap_max)
    if np.isnan(dataset.ra_error).any():
        dataset.apply_error_model(ErrorModel.fcct14())
        dataset.apply_batch_rms_correction(params.gap_max)
    if cache is None:
        cache = ObserverCache.build(dataset, ephem, ut1)

    results: Dict[str, FitResult] = {}
    n_real = params.n_noise_realizations + 1
    base_key = jax.random.PRNGKey(seed)

    # --- vectorized padded layout: one lexsort + scatters for the WHOLE
    # dataset (per-trajectory Python loops dominated host prep at survey
    # scale) ----------------------------------------------------------------
    Tall = dataset.n_trajectories
    if len(dataset.mjd_tt) == 0 or Tall == 0:
        for tid in dataset.traj_ids:
            results[tid] = FitResult(
                tid, ok=False,
                error=str(
                    NoFeasibleTriplets(
                        0.0, 0, params.dt_min, params.dt_max_triplet
                    )
                ),
            )
        return {"results": results, "pending": None}
    # layout only: observation VALUES are gathered on device from the
    # dataset-order base arrays (no helio download, no value scatters)
    lay = padded_dataset_arrays(dataset, with_values=False)
    counts_all = lay.counts
    n_max = lay.n_max
    epochs_pad = lay.mjd
    obs_valid_all = lay.valid
    glob_idx = lay.glob_idx

    # trajectories observed from an unresolvable station are errors, not
    # silently-geocentric fits (photom fails loudly; observatories.py)
    unk = np.fromiter(
        (o.unknown for o in dataset.observers), bool, count=len(dataset.observers)
    )
    bad_traj = np.zeros(Tall, bool)
    if unk.any():
        bad_obs = unk[dataset.observer_index]
        bad_traj = np.bincount(
            dataset.traj_index[bad_obs], minlength=Tall
        ).astype(bool)
        for t in np.nonzero(bad_traj)[0]:
            tid = dataset.traj_ids[t]
            sel = dataset.traj_index == t
            codes = sorted(
                {
                    dataset.observers[i].code or "?"
                    for i in np.unique(dataset.observer_index[sel & bad_obs])
                }
            )
            results[tid] = FitResult(
                tid, ok=False, error=f"UnknownObservatory({', '.join(codes)})"
            )

    arc = np.where(
        counts_all > 0,
        epochs_pad[np.arange(Tall), np.maximum(counts_all - 1, 0)]
        - epochs_pad[:, 0],
        0.0,
    )

    # --- SYNC-FREE feasibility screen --------------------------------------
    # A host-side necessary condition for a feasible triplet (>= 3 obs and a
    # wide-enough arc).  When most trajectories pass (the survey steady
    # state), we skip the early device enumeration entirely: the dense
    # kernel re-enumerates on device and returns each row's realized triplet
    # count with the results, so host prep contains NO device sync at all.
    # This is what lets fit_lsq_stream overlap datasets — the device queue is
    # FIFO, so a mid-prep device_get for dataset N+1 would serialize behind
    # dataset N's kernels and kill the pipeline.
    # False positives (feasible by the screen, zero triplets on device) run
    # as inert lanes and are classified NoFeasibleTriplets at finalize.
    maybe = (counts_all >= 3) & (arc >= params.dt_min) & ~bad_traj
    sync_free = bool(maybe.any()) and float(maybe.mean()) >= 0.5

    if sync_free:
        trips_all = None
        ktrips_all = None
        for t in np.nonzero(~maybe & ~bad_traj)[0]:
            tid = dataset.traj_ids[t]
            results[tid] = FitResult(
                tid,
                ok=False,
                error=str(
                    NoFeasibleTriplets(
                        arc[t],
                        int(counts_all[t]),
                        params.dt_min,
                        params.dt_max_triplet,
                    )
                ),
            )
        kept_rows = np.nonzero(maybe)[0]
    else:
        # triplet enumeration on DEVICE (top_k == the scalar best-K order;
        # property-tested) instead of the host numpy enumerator.  The
        # trajectory axis is bucketed so dataset size
        # never recompiles.
        Tb_all = _bucket(Tall)
        # combination-space cap: bucketed max observation count (multiples
        # of 8 so per-dataset count jitter does not recompile); C(m_cap, 3)
        # drives the enumeration cost
        m_cap = int(min(n_max, -(-int(counts_all.max(initial=3)) // 8) * 8))
        ep_dev = jnp.asarray(
            np.concatenate([epochs_pad, np.zeros((Tb_all - Tall, n_max))])
        )
        cnt_dev = jnp.asarray(
            np.concatenate(
                [counts_all, np.zeros(Tb_all - Tall, np.int64)]
            ).astype(np.int32)
        )
        trips_dev, ktrips_dev = generate_triplet_indices_device(
            ep_dev,
            cnt_dev,
            params.dt_min,
            params.dt_max_triplet,
            params.optimal_interval_time,
            params.max_obs_for_triplets,
            params.max_triplets,
            m_cap=m_cap,
        )
        from outfit_tpu.utils.fetch import pack_for_fetch, unpack_fetched

        _packed, _spec = pack_for_fetch((trips_dev, ktrips_dev))
        trips_all, ktrips_all = (
            jax.device_get((trips_dev, ktrips_dev))
            if _packed is None
            else unpack_fetched(jax.device_get(_packed), _spec)
        )
        trips_all = trips_all[:Tall].astype(np.int64)
        ktrips_all = ktrips_all[:Tall].astype(np.int64)
        ktrips_all = np.where(bad_traj, 0, ktrips_all)

        for t in np.nonzero((ktrips_all == 0) & ~bad_traj)[0]:
            tid = dataset.traj_ids[t]
            results[tid] = FitResult(
                tid,
                ok=False,
                error=str(
                    NoFeasibleTriplets(
                        arc[t],
                        int(counts_all[t]),
                        params.dt_min,
                        params.dt_max_triplet,
                    )
                ),
            )
        kept_rows = np.nonzero(ktrips_all > 0)[0]
    if kept_rows.size == 0:
        return {"results": results, "pending": None}

    # --- width grouping: order kept trajectories by bucketed observation
    # count so every device chunk is width-homogeneous.  Ragged datasets
    # (n_obs ~ U[8,23]) otherwise mix hard narrow arcs into every chunk:
    # the batch-wide while loops run at the stragglers' iteration counts
    # AND every trajectory pays the global padded obs width.  Per-tid noise
    # keys make
    # the reorder value-transparent (composition-invariance tested).
    cw = np.maximum(counts_all[kept_rows], 1)
    width_b = _bucket_width(cw)
    # width-bucket coalescing: merging a narrow group into the next wider
    # bucket trades padded-obs work (rows x extra columns, ~linear at
    # survey widths) against one fewer latency-bound kernel dispatch (the
    # while-loop floor).  Calibration points: the U[8,23] ragged workload
    # is best as ONE global 32-wide chunk (merge cost ~74k padded obs),
    # while the real-cadence workload (37/61/129-obs real arcs) must NOT
    # run everything at the widest bucket (merge cost ~262k padded obs).
    # Budget between the calibration points: merge while the extra padded
    # obs <= 131072 (to be re-calibrated on the GPU).  Masks keep results
    # identical either way.
    if width_b.size:
        uw = list(np.unique(width_b))
        for i in range(len(uw) - 1):
            w, wn = uw[i], uw[i + 1]
            grp = width_b == w
            n = int(grp.sum())
            if n and n * (wn - w) <= _COALESCE_BUDGET:
                width_b[grp] = wn
    if np.unique(width_b).size > 1:
        order = np.argsort(width_b, kind="stable")
        kept_rows = kept_rows[order]
        width_b = width_b[order]
    kept_tids = [dataset.traj_ids[t] for t in kept_rows]

    # one batched draw for every trajectory's Monte-Carlo noise: per-tid key,
    # FIXED shape (max_triplets, n_real, 3, 2) — deterministic, independent
    # of dataset composition, batch split, AND of the realized triplet count
    # (the first K_t rows are used).  Parity contract: obs_dataset_api.rs
    # :277-296 (base seed ^ stable trajectory hash).  Jitted with the hash
    # count bucketed: eager dispatch costs one dispatch per op, and
    # per-hash fold_in keys make padding value-transparent.
    hashes_np = np.fromiter(
        (stable_hash(t) for t in kept_tids), np.uint32, count=len(kept_tids)
    )
    hb = _bucket(len(hashes_np))
    hashes = jnp.asarray(np.pad(hashes_np, (0, hb - len(hashes_np))))
    # stays device-resident; lanes gather it inside _iod_kernel_gather
    _z_dev = _draw_noise_jit(base_key, hashes, params.max_triplets, n_real)

    # --- lane INDEX assembly: (trajectory x triplet x realization) ---------
    Tk = kept_rows.size
    T = Tk
    if sync_free:
        # realized counts are unknown host-side; chunking uses the
        # max_triplets upper bound (finalize reads the true counts from the
        # kernel output)
        K_t = np.full(Tk, params.max_triplets, np.int64)
        S = int(K_t.sum())
        dense = True
    else:
        K_t = ktrips_all[kept_rows]  # (Tk,) realized triplet counts
        S = int(K_t.sum())

        # DENSE fast path: when most trajectories realize close to
        # max_triplets feasible triplets (the survey steady state), run
        # enumeration + lane assembly + the kernel as ONE fused device
        # dispatch per chunk — zero intermediate host round-trips.
        # Otherwise a dense (T x K) lane grid would waste compute on dead
        # lanes; use the ragged index path.
        dense = S >= 0.5 * Tk * params.max_triplets

    if not dense:
        # only int32 indices + window bounds are computed host-side; the
        # lane arrays themselves are gathered on device (_iod_kernel_gather)
        tk_t = np.repeat(np.arange(Tk), K_t)  # (S,) kept-row per triplet
        tk_off = np.concatenate([[0], np.cumsum(K_t)[:-1]])
        tk_k = np.arange(S) - tk_off[tk_t]  # triplet rank within trajectory
        rows_k = kept_rows[tk_t]  # (S,) dataset trajectory row
        tr_flat = trips_all[rows_k, tk_k]  # (S, 3) local observation indices
        g_flat = glob_idx[rows_k[:, None], tr_flat]  # (S, 3) global indices

        # RMS window (select_rms_interval, trajectory.rs:294-350) batched
        # over flat triplets: with sorted epochs and dt >= 0 the
        # searchsorted index window equals the epoch-interval mask
        te1 = epochs_pad[rows_k, tr_flat[:, 0]]
        te3 = epochs_pad[rows_k, tr_flat[:, 2]]
        if params.extf >= 0.0:
            dt = (te3 - te1) * params.extf
        else:
            dt = 10.0 * arc[rows_k]
        if params.dtmax >= 0.0:
            dt = np.maximum(dt, params.dtmax)
        wlo = te1 - dt
        whi = te3 + dt

    # dataset-order base arrays (shared with fit_lsq: one upload)
    base_dev = device_base_arrays(dataset, cache)[:6]
    z_dev = _z_dev  # device-resident draws from above

    # --- trajectory-aligned device batches (IODParams.batch_size, mod.rs:
    # 169-171) + shape bucketing: triplets and trajectories are padded to
    # powers of two so different datasets (and different chunks) reuse the
    # same compiled kernel.  Triplets are contiguous per trajectory and
    # trajectory-major, so every chunk is a SLICE (no isin scans).
    lane_off = np.concatenate([[0], np.cumsum(K_t * n_real)])  # (Tk+1,)
    tri_off = np.concatenate([[0], np.cumsum(K_t)])
    # width-group boundaries (kept rows are width-sorted above): chunks
    # never straddle two obs-width buckets, so each chunk compiles and runs
    # at ITS width, not the dataset maximum
    cw_sorted = np.maximum(counts_all[kept_rows], 1)
    wb_sorted = width_b  # promoted + sorted above (aligned with kept_rows)
    wcuts = [0] + list(np.nonzero(np.diff(wb_sorted))[0] + 1) + [Tk]
    multi_width = len(wcuts) > 2
    # multi-width chunks are CAPPED at a fixed trajectory count (chunk_t)
    # and shrink per group only in power-of-two steps: per-width group
    # sizes jitter with dataset composition, and arbitrary shapes would
    # recompile every fresh dataset; pow2 buckets bound the shape set and
    # the persistent cache holds it.  chunk_t=4096 keeps the chunk COUNT
    # composition-stable (fewer, larger chunks), while the per-group pow2
    # shrink stops a 1.4k-row group from paying a 4096-row chunk at a
    # wide obs bucket.
    chunk_t = min(8192, _bucket(Tk)) if multi_width else Tk
    spans = []
    for ws, we in zip(wcuts[:-1], wcuts[1:]):
        s = ws
        while s < we:
            e = min(we, s + chunk_t) if multi_width else we
            if params.batch_size > 0:
                eb = (
                    int(
                        np.searchsorted(
                            lane_off, lane_off[s] + params.batch_size,
                            side="right",
                        )
                    )
                    - 1
                )
                e = min(e, max(eb, s + 1))
            spans.append((s, e))
            s = e

    best_rms = np.full(T, np.inf)
    kind = np.zeros(T, np.int32)
    el = np.zeros((T, 6))
    eqv = np.zeros((T, 6))
    epoch = np.zeros(T)
    corrected = np.zeros(T, bool)

    pending = []  # dispatch everything first: chunk N+1's host prep and
    # transfers overlap chunk N's device execution (async dispatch)
    chunk_tables = []  # (glob_dev, valid_dev) per chunk, for stage fusion
    for t0g, t1g in spans:
        if dense:
            Tg = t1g - t0g
            # multi-width: fixed chunk shape (composition-stable compiles);
            # single-width: bucket as before
            # multi-width: fixed chunk CAP with per-group pow2 shrink —
            # padding a 1.4k-row group to a 4096-row chunk at a 160-obs
            # width wastes more obs-columns than the width split saved
            Tb = min(chunk_t, _bucket(Tg)) if multi_width else _bucket(Tg)
            if mesh is not None and Tb % mesh.devices.size:
                from outfit_tpu.parallel import pad_to_multiple

                Tb = pad_to_multiple(Tb, mesh.devices.size)
            pad_t = Tb - Tg
            g_rows = kept_rows[t0g:t1g]
            # chunk-local obs width: kept rows are width-sorted, so the
            # whole chunk shares one bucket (left-packed layout makes the
            # column slice lossless for counts <= w_g)
            w_g = int(min(n_max, wb_sorted[t0g]))
            m_cap_g = int(
                min(w_g, -(-int(cw_sorted[t0g:t1g].max(initial=3)) // 8) * 8)
            )
            g_glob_idx = np.concatenate(
                [glob_idx[g_rows, :w_g], np.zeros((pad_t, w_g), np.int64)]
            ).astype(np.int32)
            g_valid = np.concatenate(
                [obs_valid_all[g_rows, :w_g], np.zeros((pad_t, w_g), bool)]
            )
            g_counts = np.concatenate(
                [counts_all[g_rows], np.zeros(pad_t, np.int64)]
            ).astype(np.int32)
            args = [
                jnp.asarray(g_glob_idx),
                jnp.asarray(g_valid),
                jnp.asarray(g_counts),
            ]
            g_base, g_z = base_dev, z_dev
            if mesh is not None:
                from outfit_tpu.parallel import replicate, shard_batch

                args = [shard_batch(mesh, a) for a in args]
                g_base = replicate(mesh, base_dev)
                g_z = replicate(mesh, z_dev)
            # enumeration as its own async dispatch (see _enum_chunk)
            tk = _enum_chunk_jit(
                g_base, args[0], args[1], args[2], params=params,
                m_cap=m_cap_g,
            )
            out = _iod_kernel_dense_jit(
                g_base, *args, jnp.int32(t0g), g_z, params=params,
                m_cap=m_cap_g, trips_in=tk,
            )
            pending.append((t0g, t1g, Tg, out))
            chunk_tables.append((args[0], args[1]))
            continue
        sl = slice(int(tri_off[t0g]), int(tri_off[t1g]))
        Tg = t1g - t0g
        Sg = sl.stop - sl.start

        # pad triplets to a bucket with inert rows (window all-False -> inf
        # score -> excluded from the segment argmin); padded trajectory
        # rows have no valid observations.  Bucketing at triplet
        # granularity keeps the lane axis (Sb * n_real) compile-stable and
        # mesh-divisible for any n_real.
        Sb = _bucket(Sg)
        if mesh is not None and Sb % mesh.devices.size:
            from outfit_tpu.parallel import pad_to_multiple

            Sb = pad_to_multiple(Sb, mesh.devices.size)
        Tb = _bucket(Tg + (1 if Sb > Sg else 0))
        pad_s = Sb - Sg

        def tri_pad(x, fill):
            return np.concatenate([x[sl], np.full((pad_s,) + x.shape[1:], fill, x.dtype)])

        g_tr = tri_pad(g_flat, 0).astype(np.int32)
        g_tk_t = tri_pad(tk_t - t0g, Tg).astype(np.int32)
        g_tk_glob = tri_pad(tk_t, 0).astype(np.int32)
        g_tk_k = tri_pad(tk_k, 0).astype(np.int32)
        g_wlo = tri_pad(wlo, np.inf)
        g_whi = tri_pad(whi, -np.inf)

        g_rows = kept_rows[t0g:t1g]
        pad_t = Tb - Tg
        w_g = int(min(n_max, wb_sorted[t0g]))
        g_glob_idx = np.concatenate(
            [glob_idx[g_rows, :w_g], np.zeros((pad_t, w_g), np.int64)]
        ).astype(np.int32)
        g_valid = np.concatenate(
            [obs_valid_all[g_rows, :w_g], np.zeros((pad_t, w_g), bool)]
        )

        args = [
            jnp.asarray(a)
            for a in (g_glob_idx, g_valid, g_tr, g_tk_t, g_tk_glob, g_tk_k, g_wlo, g_whi)
        ]
        g_base, g_z = base_dev, z_dev
        if mesh is not None:
            # triplet-axis inputs sharded over the data mesh; dataset-order
            # base arrays, draws, and per-trajectory tables replicated
            from outfit_tpu.parallel import replicate, shard_batch

            args[2:] = [shard_batch(mesh, a) for a in args[2:]]
            args[:2] = [replicate(mesh, a) for a in args[:2]]
            g_base = replicate(mesh, base_dev)
            g_z = replicate(mesh, z_dev)
        out = _iod_kernel_gather_jit(g_base, *args, g_z, params=params)
        pending.append((t0g, t1g, Tg, out))
        chunk_tables.append((args[0], args[1]))

    return {
        "results": results,
        "pending": pending,
        "chunk_tables": chunk_tables,
        "kept_tids": kept_tids,
        "kept_rows": kept_rows,
        "lane_counts": K_t * n_real,
        "T": T,
        "cache": cache,
        "out_arrays": (best_rms, kind, el, eqv, epoch, corrected),
        # sync-free mode: realized triplet counts arrive with the kernel
        # outputs; finalize classifies zero-triplet rows from these
        "sync_free": sync_free,
        "n_real": n_real,
        "arc_kept": arc[kept_rows],
        "counts_kept": counts_all[kept_rows],
        "params": params,
    }


def iod_fetch_mask(outs, slim=False, minimal=False):
    """Per-leaf slim mask for the IOD kernel output tuples
    ``(best_rms, kind, el, eqv, epoch, corr[, ktrips])`` passed to
    :func:`outfit_tpu.utils.fetch.pack_for_fetch`.

    Default (``slim=False``): only the exact-in-float32 leaves ride the
    f32 buffer — ``kind`` ({-1..2}), ``corr`` (bool), ``ktrips`` (realized
    triplet count, bounded by the O(n^2) window enumeration over
    <= max_obs_for_triplets observations, far below 2**24) — so results
    stay BITWISE identical while the transfer drops 2-3 f64 slots/row.

    ``slim=True`` additionally moves the reporting-grade leaves —
    ``best_rms`` (quality metric) and ``el`` (native-kind display
    elements) — to f32.  ``eqv`` (the equinoctial vector the LSQ fallback
    consumes) and ``epoch`` (MJD needs sub-second f64 resolution) always
    stay exact f64.

    ``minimal=True`` (fused table mode only) SKIPS the per-row element
    vectors ``el`` and ``eqv`` entirely (``None`` mask = not transferred);
    the finalize fetches them afterwards for just the rows that consume
    them (LSQ non-converged rows, whose result IS the IOD seed) via a tiny
    second gather — the converged majority's seed elements are superseded
    by the LSQ elements and never cross the link.
    """
    el = None if minimal else slim
    eqv = None if minimal else False
    base = (slim, True, el, eqv, False, True)
    return [base + (True,) * (len(o) - 6) for o in outs]


def _fill_iod_out_arrays(state, fetched):
    """Scatter the fetched per-chunk IOD outputs into the full kept-order
    arrays.  Returns (lane_counts, ktrips_fetched); the filled columns live
    in ``state["out_arrays"]``.  Shared by the per-row dict finalize and the
    columnar table finalize."""
    kept_tids = state["kept_tids"]
    lane_counts = np.asarray(state["lane_counts"], np.int64).copy()
    best_rms, kind, el, eqv, epoch, corrected = state["out_arrays"]
    ktrips_fetched = (
        np.zeros(len(kept_tids), np.int64) if state.get("sync_free") else None
    )
    for (t0g, t1g, Tg, _), out in zip(
        state.get("pending_fetch", state["pending"]), fetched
    ):
        g_rms, g_kind, g_el, g_eqv, g_epoch, g_corr = out[:6]
        best_rms[t0g:t1g] = g_rms[:Tg]
        kind[t0g:t1g] = g_kind[:Tg]
        # minimal-fetch mode skips the element vectors (None leaves); the
        # fused-table finalize back-fills the rows it needs from a deferred
        # device gather, everything else stays NaN
        el[t0g:t1g] = np.nan if g_el is None else g_el[:Tg]
        eqv[t0g:t1g] = np.nan if g_eqv is None else g_eqv[:Tg]
        epoch[t0g:t1g] = g_epoch[:Tg]
        corrected[t0g:t1g] = g_corr[:Tg]
        if ktrips_fetched is not None and len(out) > 6:
            ktrips_fetched[t0g:t1g] = out[6][:Tg]
    if ktrips_fetched is not None:
        lane_counts = ktrips_fetched * state["n_real"]
    return lane_counts, ktrips_fetched


def _finalize_iod(state, fetched) -> Dict[str, FitResult]:
    """Fetch half of :func:`fit_full_iod`: unpack device outputs into the
    per-trajectory result dict."""
    results = state["results"]
    kept_tids = state["kept_tids"]
    lane_counts, ktrips_fetched = _fill_iod_out_arrays(state, fetched)
    best_rms, kind, el, eqv, epoch, corrected = state["out_arrays"]

    # kernel outputs are per-trajectory (the segment argmin runs on device)
    p = state.get("params")
    arc_kept = state.get("arc_kept")
    counts_kept = state.get("counts_kept")
    # bulk scalar conversion: per-row float()/int() numpy casts cost ~5 us
    # per trajectory at survey scale — tolist() amortizes them 3-4x
    finite_l = np.isfinite(best_rms).tolist()
    rms_l = best_rms.tolist()
    corr_l = corrected.tolist()
    epoch_l = epoch.tolist()
    kind_l = kind.tolist()
    el_rows = list(el)
    eqv_rows = list(eqv)
    ktrips_l = None if ktrips_fetched is None else ktrips_fetched.tolist()
    lane_l = lane_counts.tolist()
    for t_row, tid in enumerate(kept_tids):
        if not finite_l[t_row]:
            # sync-free rows that realized zero triplets on device were
            # never enumerable — same NoFeasibleTriplets error the early
            # host screen emits for rows it can rule out itself
            if ktrips_l is not None and ktrips_l[t_row] == 0:
                results[tid] = FitResult(
                    tid, ok=False,
                    error=str(
                        NoFeasibleTriplets(
                            float(arc_kept[t_row]),
                            int(counts_kept[t_row]),
                            p.dt_min,
                            p.dt_max_triplet,
                        )
                    ),
                )
                continue
            results[tid] = FitResult(
                tid, ok=False,
                error=str(NoViableOrbit(lane_l[t_row])),
            )
            continue
        results[tid] = FitResult(
            tid,
            ok=True,
            rms=rms_l[t_row],
            corrected=bool(corr_l[t_row]),
            epoch=epoch_l[t_row],
            kind=kind_l[t_row],
            elements=el_rows[t_row],
            equinoctial=eqv_rows[t_row],
        )
    return results


def fit_full_iod(
    dataset,
    ephem,
    params: IODParams = IODParams(),
    seed: int = 0,
    ut1: Optional[Ut1Provider] = None,
    error_model: Optional[ErrorModel] = None,
    cache: Optional[ObserverCache] = None,
    mesh="auto",
) -> Dict[str, FitResult]:
    """Batch IOD over every trajectory of the dataset.

    Parity: ``fit_full_iod`` (obs_dataset_api.rs:145-172); the rayon
    parallel variant is subsumed — all trajectories run as one device batch,
    and per-trajectory deterministic seeding keeps results schedule-
    independent (the reference's bitwise sequential==parallel contract).

    ``mesh="auto"`` (default) shards the lane batch over a 1-D data mesh of
    all local devices when more than one is present — the multi-chip path IS
    the public entry point (the reference ships ``fit_full_iod_parallel`` as
    a user API, obs_dataset_api.rs:174-207).  Pass ``mesh=None`` to force
    single-device, or an explicit ``jax.sharding.Mesh``.
    """
    from outfit_tpu.parallel import resolve_mesh

    mesh = resolve_mesh(mesh)
    state = _fit_full_iod_dispatch(
        dataset, ephem, params, seed, ut1, error_model, cache, mesh
    )
    if state["pending"] is None:
        return state["results"]
    # ONE bulk transfer for every chunk's outputs, as ONE packed buffer:
    # each individual transfer costs a setup on top of bandwidth
    # (utils/fetch.py)
    from outfit_tpu.utils.fetch import pack_for_fetch, unpack_fetched

    outs = [out for _, _, _, out in state["pending"]]
    packed, spec = pack_for_fetch(outs, iod_fetch_mask(outs))
    if packed is None:
        fetched = jax.device_get([out for _, _, _, out in state["pending"]])
    else:
        fetched = unpack_fetched(jax.device_get(packed), spec)
    return _finalize_iod(state, fetched)


def fit_full_iod_stream(
    datasets,
    ephem,
    params: IODParams = IODParams(),
    seed: int = 0,
    ut1: Optional[Ut1Provider] = None,
    error_model: Optional[ErrorModel] = None,
    mesh="auto",
    depth: int = 2,
    prefetch: bool = True,
):
    """Pipelined IOD over a stream of datasets (host prep of dataset N+1
    overlaps device execution of dataset N; see ``fit_lsq_stream``, which
    also documents the ``prefetch`` finalize thread).
    Yields ``(dataset, results)`` pairs in input order."""
    from collections import deque

    from outfit_tpu.parallel import resolve_mesh

    mesh = resolve_mesh(mesh)

    from outfit_tpu.utils.fetch import pack_for_fetch, unpack_fetched

    def _pack(state):
        # pack at dispatch time so the concat queues right behind the
        # kernels; one transfer per dataset instead of ~n_chunks*7
        if state["pending"] is not None:
            outs = [
                out
                for _, _, _, out in state.get("pending_fetch", state["pending"])
            ]
            state["packed"], state["pack_spec"] = pack_for_fetch(
                outs, iod_fetch_mask(outs)
            )
        return state

    def _fetch_and_build(ds, state):
        if state["pending"] is None:
            return ds, state["results"]
        if state.get("packed") is not None:
            fetched = unpack_fetched(
                jax.device_get(state["packed"]), state["pack_spec"]
            )
        else:
            fetched = jax.device_get(
                [out for _, _, _, out in state.get("pending_fetch", state["pending"])]
            )
        return ds, _finalize_iod(state, fetched)

    ex = None
    if prefetch:
        from concurrent.futures import ThreadPoolExecutor

        ex = ThreadPoolExecutor(1, thread_name_prefix="iod-finalize")

    from outfit_tpu.utils.runtime import clear_executables_if_crowded

    inflight = deque()
    try:
        for ds in datasets:
            # backstop for unbounded shape streams: nearing vm.max_map_count
            # crashes inside XLA instead of raising (utils/runtime.py)
            clear_executables_if_crowded()
            st = _pack(
                _fit_full_iod_dispatch(
                    ds, ephem, params, seed, ut1, error_model, None, mesh
                )
            )
            item = (
                ex.submit(_fetch_and_build, ds, st)
                if ex is not None
                else (ds, st)
            )
            inflight.append(item)
            while len(inflight) > max(depth, 1):
                got = inflight.popleft()
                yield got.result() if ex is not None else _fetch_and_build(*got)
        while inflight:
            got = inflight.popleft()
            yield got.result() if ex is not None else _fetch_and_build(*got)
    finally:
        if ex is not None:
            ex.shutdown(wait=False, cancel_futures=True)


def fit_full_iod_parallel(*args, **kwargs) -> Dict[str, FitResult]:
    """Alias of :func:`fit_full_iod` (parity:
    ``fit_full_iod_parallel``, obs_dataset_api.rs:174-207).  The batched
    device kernel IS the parallel path — with more than one device the
    default ``mesh="auto"`` shards the batch over all of them, and
    per-trajectory deterministic seeding makes results schedule-independent
    (the reference's bitwise sequential==parallel contract)."""
    return fit_full_iod(*args, **kwargs)


def fit_iod(
    observations,
    ephem,
    params: IODParams = IODParams(),
    seed: int = 0,
    ut1=None,
    traj_id: str = "TRAJ",
    error_model=None,
) -> FitResult:
    """Single-trajectory IOD.

    Parity: ``FitIOD::fit_iod`` (obs_dataset_api.rs:41-127) — convenience
    wrapper around the batched path for one trajectory.  Accepts either a
    list of Observation records, or an ObsDataset + ``traj_id`` (the
    reference's ``dataset.fit_iod("K09R05F", ...)`` form).
    """
    from outfit_tpu.observations.dataset import ObsDataset

    if isinstance(observations, ObsDataset):
        # column subset (keeps catalog codes + bias so a catalog-aware
        # error model resolves the same sigma tier as the batch path)
        ds = observations.subset(observations.trajectory_obs_indices(traj_id))
    else:
        ds = ObsDataset()
        for o in observations:
            ds.push_observation(
                traj_id, o.mjd_tt, o.ra, o.dec, o.ra_error, o.dec_error,
                o.observer,
            )
    return fit_full_iod(
        ds, ephem, params, seed=seed, ut1=ut1, error_model=error_model
    )[traj_id]


#: Reference-name aliases (constants.rs:134-195, gauss_result.rs:98-216):
#: ``FitResult`` plays both roles — it carries the Gauss outcome (kind,
#: corrected, rms) and is the per-trajectory value of the result map.
GaussResult = FitResult
FullOrbitResult = Dict[str, FitResult]
IODRMS = float
