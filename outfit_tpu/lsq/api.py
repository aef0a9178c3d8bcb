"""fit_lsq: IOD-seeded differential correction over a whole dataset.

Behavioral parity with ``FitLSQ::fit_lsq``
(``src/differential_orbit_correction/obs_dataset_api.rs:129-224``) and the
``differential_correction`` driver (``diff_cor mod.rs:60-115``):

* seed orbits from a supplied IOD result map or by running fit_full_iod,
* convert seeds to equinoctial, run the batched correction loops,
* fall back to the IOD orbit when the correction fails (status != OK),
* return elements + full 6x6 covariance + 1-sigma uncertainties +
  normalised RMS per trajectory.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from outfit_tpu.elements.types import EquinoctialElements, equinoctial_to_keplerian
from outfit_tpu.elements.uncertainty import uncertainties_from_covariance
from outfit_tpu.iod.api import FitResult, fit_full_iod
from outfit_tpu.iod.params import IODParams
from outfit_tpu.lsq.config import DifferentialCorrectionConfig
from outfit_tpu.lsq.iteration import SEL_ACTIVE, SEL_FORCED_OUT, ObsArrays
from outfit_tpu.lsq.loop import (
    STATUS_OK,
    run_differential_correction,
)
from outfit_tpu.observations.error_model import ErrorModel
from outfit_tpu.observer.cache import ObserverCache
from outfit_tpu.time.scales import Ut1Provider

from outfit_tpu.errors import (
    BizarreOrbit,
    DifferentialCorrectionDiverged,
    DifferentialCorrectionFailed,
)

# LSQ kernel status code -> result-error string (the classes exist for
# host-side raising; in-kernel failures are data and stringify here)
_STATUS_NAMES = {
    1: None,  # still-running sentinel: no error text
    2: BizarreOrbit.__name__,
    3: DifferentialCorrectionDiverged.__name__,
    4: DifferentialCorrectionFailed.__name__ + "(inversion)",
}


#: minimal-fetch compact-slice floor: the bulk fetch always carries room
#: for this many non-converged rows' seed vectors; beyond max(floor,
#: rows/8) the finalize falls back to a live overflow gather.  Module
#: level so tests can force the overflow path.
_NEED_CAP_FLOOR = 256

#: extra padded observations the merged cross-chunk correction may cost
#: before per-chunk dispatch wins (see fit_lsq_dispatch; the same
#: calibration scale as the IOD width coalescer's budget)
_LSQ_MERGE_BUDGET = 131072

#: lower-triangle index pair for symmetric 6x6 covariance fetch packing
_TRIL_I, _TRIL_J = np.tril_indices(6)


def _unpack_cov(tri: np.ndarray) -> np.ndarray:
    """(T, 21) lower triangle -> full symmetric (T, 6, 6)."""
    c = np.zeros(tri.shape[:-1] + (6, 6))
    c[..., _TRIL_I, _TRIL_J] = tri
    c[..., _TRIL_J, _TRIL_I] = tri
    return c


def _status_name(code):
    return _STATUS_NAMES.get(code, f"status={code}")


@dataclass(slots=True)
class LsqResult:
    """Per-trajectory LSQ outcome.

    Parity: ``DifferentialCorrectionOutput`` (diff_cor.rs:202-243) +
    the IOD-fallback semantics of the driver (mod.rs:113).

    ``slots=True``: finalize constructs one of these per trajectory on the
    stream pipeline's critical path (tens of thousands per dataset).
    """

    traj_id: str
    ok: bool
    error: Optional[str] = None
    #: kernel status code (loop.py convention: 1=STATUS_OK, 2=bizarre,
    #: 3=diverged, 4=inversion-failed; -1 = no kernel run for this row).
    #: Carried numerically so LsqTable never reverse-maps error strings.
    status: int = -1
    fell_back_to_iod: bool = False
    normalised_rms: float = float("inf")
    epoch: float = 0.0
    equinoctial: Optional[np.ndarray] = None  # (6,) ecliptic J2000
    covariance: Optional[np.ndarray] = None  # (6, 6)
    uncertainties: Optional[np.ndarray] = None  # (6,) 1-sigma
    n_active_obs: int = 0
    total_newton_iterations: int = 0
    iod: Optional[FitResult] = None

    @property
    def orbit_quality(self) -> float:
        """Scalar fit quality.  Parity: ``FitOrbitResult::orbit_quality``
        (constants.rs:157-162) — the normalised RMS (sqrt reduced chi^2)
        for a converged differential correction, the IOD RMS on fallback."""
        if self.fell_back_to_iod and self.iod is not None:
            return self.iod.rms
        return self.normalised_rms

    @property
    def orbital_elements(self):
        """Equinoctial element set of the fit (parity:
        ``FitOrbitResult::orbital_elements``, constants.rs:169-174)."""
        if self.equinoctial is None:
            return None
        return EquinoctialElements(self.epoch, *map(jnp.float64, self.equinoctial))

    @property
    def keplerian(self):
        if self.equinoctial is None:
            return None
        return equinoctial_to_keplerian(
            EquinoctialElements(self.epoch, *map(jnp.float64, self.equinoctial))
        )

    @property
    def keplerian_covariance(self):
        """6x6 covariance propagated to Keplerian space (Sigma' = J Sigma J^T).

        Parity: ``OrbitalElements::to_keplerian`` covariance propagation
        (orbit_type/mod.rs:323-443).
        """
        if self.covariance is None or self.equinoctial is None:
            return None
        from outfit_tpu.elements.types import jacobian_equinoctial_to_keplerian
        from outfit_tpu.elements.uncertainty import propagate_covariance

        eq = EquinoctialElements(self.epoch, *map(jnp.float64, self.equinoctial))
        j = jacobian_equinoctial_to_keplerian(eq)
        return np.asarray(propagate_covariance(jnp.asarray(self.covariance), j))

    @property
    def keplerian_uncertainties(self):
        """Per-element 1-sigma in Keplerian space (parity: uncertainty.rs
        from_covariance diagonal square roots)."""
        cov = self.keplerian_covariance
        if cov is None:
            return None
        return np.sqrt(np.maximum(np.diag(cov), 0.0))


def _get_runner(
    cfg: DifferentialCorrectionConfig,
    ephem,
    with_bias: bool,
    seeded=False,
):
    """Compile-cached correction runner; the ephemeris tables are closed
    over (needed for the N-body propagator, and JPLEphem is not a pytree).
    The cache lives ON the ephem object so compiled executables are released
    with it (a module dict keyed by id(ephem) would leak and can collide
    after id reuse).

    The runner GATHERS the padded per-trajectory observation tables on
    device from the dataset-order base arrays (no host-side scatter and no
    upload of materialized padded tables)."""
    store = getattr(ephem, "_lsq_runner_jit", None)
    if store is None:
        store = {}
        try:
            ephem._lsq_runner_jit = store
        except AttributeError:
            pass
    key = (cfg, with_bias, seeded)
    if key not in store:

        def _run(el, ep, base, glob_idx, valid):
            mjd_b, ra_b, dec_b, sra_b, sdec_b, helio_b, bra_b, bdec_b = base
            obs = ObsArrays(
                jnp.where(valid, mjd_b[glob_idx], 0.0),
                jnp.where(valid, ra_b[glob_idx], 0.0),
                jnp.where(valid, dec_b[glob_idx], 0.0),
                jnp.where(valid, sra_b[glob_idx], 1.0),
                jnp.where(valid, sdec_b[glob_idx], 1.0),
                jnp.where(valid[..., None], helio_b[glob_idx], 0.0),
                valid,
                bias_ra=None if bra_b is None else jnp.where(valid, bra_b[glob_idx], 0.0),
                bias_dec=None if bdec_b is None else jnp.where(valid, bdec_b[glob_idx], 0.0),
            )
            out = run_differential_correction(el, ep, obs, cfg, ephem=ephem)
            # 1-sigma extraction AND the active-observation count inside the
            # jit: an eager follow-up op costs a dispatch of its own, and
            # downloading the (T, n_obs) selection matrix just to count
            # actives wastes transfer bandwidth.  The covariance crosses
            # to the host as its lower triangle ((T, 21) instead of
            # (T, 36) f64 — it is symmetric).
            n_active = ((out.selection == SEL_ACTIVE) & valid).sum(axis=-1)
            cov_tri = out.covariance[:, _TRIL_I, _TRIL_J]
            return out, uncertainties_from_covariance(out.covariance), n_active, cov_tri

        # FUSED stage handoff: seeds arrive as the IOD kernel's device
        # outputs; rows without a usable seed run inert (benign
        # elements, caller drops them) — same criteria as the host-side
        # rows filter (iod.ok & finite equinoctial)
        def _run_seeded(iod_rms, iod_eqv, iod_epoch, base, glob_idx, valid):
            ok = jnp.isfinite(iod_rms) & jnp.isfinite(iod_eqv).all(-1)
            benign = jnp.asarray([2.0, 0.0, 0.0, 0.0, 0.0, 0.0])
            el = jnp.where(ok[:, None], jnp.where(jnp.isfinite(iod_eqv), iod_eqv, 0.0), benign)
            ep = jnp.where(ok, jnp.where(jnp.isfinite(iod_epoch), iod_epoch, 57000.0), 57000.0)
            out, sig, n_active, cov_tri = _run(el, ep, base, glob_idx, valid)
            return out, sig, n_active, cov_tri, ok

        if not seeded:
            store[key] = jax.jit(_run)
        elif seeded == "merged":
            # MERGED stage handoff across width-grouped IOD chunks: the
            # correction while-loops are latency-bound (wall time ~flat in
            # batch size), so running one correction per chunk multiplies
            # the LSQ cost by the chunk count.  Concatenate every chunk's
            # FULL padded outputs inside one jit (exact per-chunk row
            # counts vary per dataset and would recompile; padded chunk
            # shapes do not), COMPACT the real rows with a gather
            # (``sel_rows`` maps compact row -> merged offset: half the
            # correction rows and half the fetch payload on a typical
            # ragged batch), run ONE correction at the dataset's widest
            # obs bucket, and hand the compacted IOD outputs back so the
            # host fetches no padded rows.
            def _run_merged(seeds, sel_rows, base, glob_idx, valid):
                n_out = len(seeds[0])
                merged = [
                    jnp.concatenate([s[i] for s in seeds])[sel_rows]
                    for i in range(n_out)
                ]
                out, sig, n_active, cov_tri, ok = _run_seeded(
                    merged[0], merged[3], merged[4], base, glob_idx, valid
                )
                return out, sig, n_active, cov_tri, ok, tuple(merged)

            store[key] = jax.jit(_run_merged)
        else:
            store[key] = jax.jit(_run_seeded)
    return store[key]


@dataclass
class PendingLsq:
    """In-flight fused IOD+LSQ work: device kernels dispatched, results not
    yet fetched.  Produced by :func:`fit_lsq_dispatch`; resolved by
    :func:`fit_lsq_finalize`.  Lets a caller (or :func:`fit_lsq_stream`)
    overlap the next dataset's host prep with this one's device execution.
    """

    dataset: object
    st: Optional[dict] = None  # IOD dispatch state (None when resolved)
    lsq_pend: Optional[list] = None
    results: Optional[Dict[str, LsqResult]] = None  # resolved host-side
    # single-buffer fetch (utils/fetch.py): one transfer instead of ~30 —
    # packed at dispatch so the concat queues right behind the kernels
    packed: object = None
    pack_spec: object = None
    #: opt-in slim transfer: the covariance triangle and the IOD
    #: reporting leaves (native-kind elements, seed RMS) ride a float32
    #: buffer (~7 significant digits — reporting grade).  LSQ orbital
    #: elements, the equinoctial seed vector, epochs, and rms stay exact
    #: f64.  Default off: full bit-parity with the sequential path.
    slim: bool = False
    #: columnar finalize: return an :class:`outfit_tpu.lsq.table.LsqTable`
    #: instead of the per-trajectory dict (skips per-row object
    #: construction — the GIL-bound finalize cost at survey scale)
    as_table: bool = False
    #: deferred-element transfer: the per-row IOD element vectors (``el``,
    #: ``eqv`` — 72 B/row) are NOT in the bulk fetch; finalize gathers them
    #: on device for just the rows whose result consumes them (LSQ
    #: non-converged rows) and fetches that small slice separately.  Set
    #: by ``fit_lsq_dispatch(minimal_fetch=True)`` when the dispatch shape
    #: supports it (single fetch chunk — the production single-device path).
    minimal: bool = False

    def __post_init__(self):
        if self.st is not None and self.packed is None:
            from outfit_tpu.iod.api import iod_fetch_mask
            from outfit_tpu.utils.fetch import pack_for_fetch

            st = self.st
            need_pack = st.get("need_pack", ())
            tree = (
                [o for *_, o in st.get("pending_fetch", st["pending"])],
                self.lsq_pend,
                need_pack,
            )
            # lsq_pend tuples: (status, elements, rms, cov_tri, n_active,
            # iterations[, seed_ok]).  Default: the int leaves (status/
            # n_active/iterations — bounded counters, exact in f32) ride the
            # f32 buffer; results stay bitwise identical.  Slim additionally
            # moves the covariance triangle (reporting grade) to f32.  The
            # trailing seed_ok flag (minimal mode only) is a bool — f32.
            # need_pack (minimal mode): per fetch chunk, (row idx, count,
            # el slice, eqv slice) — idx/count are small ints (f32-exact),
            # the el slice follows the slim flag, the eqv slice stays
            # exact f64.
            mask = (
                iod_fetch_mask(tree[0], self.slim, self.minimal),
                [
                    (True, False, False, self.slim, True, True)
                    + (True,) * (len(t) - 6)
                    for t in self.lsq_pend
                ],
                [(True, True, self.slim, False) for _ in need_pack],
            )
            self.packed, self.pack_spec = pack_for_fetch(tree, mask)


def fit_lsq_dispatch(
    dataset,
    ephem,
    iod_params: IODParams = IODParams(),
    config: DifferentialCorrectionConfig = DifferentialCorrectionConfig(),
    seed: int = 0,
    ut1: Optional[Ut1Provider] = None,
    error_model: Optional[ErrorModel] = None,
    mesh="auto",
    cache: Optional[ObserverCache] = None,
    slim_fetch: bool = False,
    as_table: bool = False,
    minimal_fetch: bool = False,
) -> PendingLsq:
    """Run all host prep and dispatch the fused IOD+LSQ device work WITHOUT
    fetching results (async).  Pair with :func:`fit_lsq_finalize`.

    ``as_table=True`` makes the finalize return a columnar
    :class:`~outfit_tpu.lsq.table.LsqTable` (vectorized numpy assembly, no
    per-row Python objects) instead of the ``{traj_id: LsqResult}`` dict —
    the survey-scale mode.

    ``slim_fetch=True`` transfers the covariance triangle and the IOD
    reporting leaves (native-kind elements, seed RMS) as float32 (~40%
    fewer device->host bytes; LSQ elements/rms, the equinoctial seed,
    and epochs stay exact f64) — for throughput-bound services on slow
    links where 7-digit uncertainty reporting suffices.  Default False:
    full bit-parity (1-sigma values derive host-side from the fetched
    covariance diagonal in either mode).

    ``minimal_fetch=True`` (requires ``as_table=True``) additionally keeps
    the per-row IOD element vectors on device: the bulk fetch drops 72
    B/row (the 6-f64 equinoctial seed + 6-f32/f64 display elements), and
    finalize fetches them afterwards for ONLY the rows whose result is the
    IOD seed (LSQ non-converged rows — a small minority on healthy
    workloads).  Contract difference: converged rows' ``iod_elements`` /
    ``iod_equinoctial`` table columns are NaN (their fit elements are the
    LSQ ones); every column a converged or fallback result actually uses
    is unchanged, and the deferred rows' seed values are exact f64.
    Applies on every dispatch shape: single-chunk directly; multi-chunk
    through the merged correction, which compacts the chunks into one
    fetch chunk (mesh or not)."""
    from outfit_tpu.parallel import resolve_mesh

    if minimal_fetch and not as_table:
        raise ValueError(
            "minimal_fetch=True requires as_table=True (the per-row dict "
            "materializes every row's IOD FitResult eagerly, which would "
            "re-fetch everything the minimal transfer skipped)"
        )

    mesh = resolve_mesh(mesh)
    if error_model is not None:
        dataset.apply_error_model(error_model)
        dataset.apply_batch_rms_correction(iod_params.gap_max)
    if np.isnan(dataset.ra_error).any():
        dataset.apply_error_model(ErrorModel.fcct14())
        dataset.apply_batch_rms_correction(iod_params.gap_max)
    if cache is None:
        cache = ObserverCache.build(dataset, ephem, ut1)

    # FUSED IOD->LSQ: seed the correction directly from the IOD
    # kernel's device outputs — one bulk transfer for both stages
    # (each extra sync point costs a host round trip plus the seed
    # download/upload).
    from outfit_tpu.iod.api import (
        _fit_full_iod_dispatch,
        device_base_arrays,
    )

    st = _fit_full_iod_dispatch(
        dataset, ephem, iod_params, seed, ut1, None, cache, mesh
    )
    if st["pending"] is None:
        # everything resolved host-side (no viable trajectories): run the
        # sequential path to build error results
        return PendingLsq(
            dataset,
            results=_fit_lsq_seeded(
                dataset, ephem, config, st["results"], mesh, cache=cache
            ),
            as_table=as_table,
        )
    with_bias = dataset.bias_ra is not None
    base = device_base_arrays(dataset, cache)

    merge_lsq = False
    if len(st["pending"]) > 1:
        # Merge the correction across width-grouped IOD chunks when the
        # width padding is cheap: ONE latency-bound while-loop for all
        # kept trajectories (per-chunk correction multiplies the ~flat
        # LSQ wall floor by the chunk count) — but running every row at
        # the widest bucket costs rows x extra-obs-columns of padded
        # partials per Newton iteration.  The budget is the same
        # calibration as the IOD width coalescer: merge while the extra
        # padded obs <= _LSQ_MERGE_BUDGET.  On the real-cadence workload
        # (2731 x 64-wide + 1365 x 160-wide rows) the 262k padded obs of
        # a merge exceed it; on the U[8,23] ragged workload (32-wide
        # buckets) merging stays inside it.
        from outfit_tpu.iod.api import _bucket, padded_dataset_arrays

        lay = padded_dataset_arrays(dataset, with_values=False)
        kept_rows = st["kept_rows"]
        Tk = len(kept_rows)
        counts_kept = np.maximum(lay.counts[kept_rows], 1)
        from outfit_tpu.iod.api import _bucket_width

        w_m = int(
            min(lay.n_max, int(_bucket_width(int(counts_kept.max(initial=1)))))
        )
        extra_pad = sum(
            Tg * (w_m - int(glob_dev.shape[1]))
            for (_, _, Tg, _), (glob_dev, _) in zip(
                st["pending"], st["chunk_tables"]
            )
        )
        merge_lsq = extra_pad <= _LSQ_MERGE_BUDGET

    if merge_lsq:
        # compact row t (kept order) lives at merged offset off_c + (t-t0g)
        # of the full padded-chunk concatenation
        chunk_lens = [int(o[0].shape[0]) for (_, _, _, o) in st["pending"]]
        offs = np.concatenate([[0], np.cumsum(chunk_lens)[:-1]]).astype(np.int64)
        Tb_k = _bucket(Tk)
        if mesh is not None:
            from outfit_tpu.parallel import pad_to_multiple

            Tb_k = pad_to_multiple(Tb_k, mesh.devices.size)
        sel_rows = np.zeros(Tb_k, np.int32)
        for off, (t0g, t1g, Tg, _) in zip(offs, st["pending"]):
            sel_rows[t0g:t1g] = off + np.arange(Tg)
        glob_m = np.zeros((Tb_k, w_m), np.int32)
        glob_m[:Tk] = lay.glob_idx[kept_rows, :w_m]
        valid_m = np.zeros((Tb_k, w_m), bool)
        valid_m[:Tk] = lay.valid[kept_rows, :w_m]

        runner = _get_runner(config, ephem, with_bias, seeded="merged")
        seeds = [o for (_, _, _, o) in st["pending"]]
        sel_dev = jnp.asarray(sel_rows)
        glob_dev = jnp.asarray(glob_m)
        valid_dev = jnp.asarray(valid_m)
        if mesh is not None:
            from outfit_tpu.parallel import replicate, shard_batch

            sel_dev = shard_batch(mesh, sel_dev)
            glob_dev = shard_batch(mesh, glob_dev)
            valid_dev = shard_batch(mesh, valid_dev)
            base = replicate(mesh, base)
        lsq_out, sig_dev, nact_dev, cov_tri_dev, ok_dev, iod_merged = runner(
            seeds, sel_dev, base, glob_dev, valid_dev,
        )
        st["lsq_merged"] = [(0, Tk)]
        # finalize fetches the compacted IOD outputs (one pseudo-chunk
        # covering every kept row) instead of the per-chunk padded ones
        st["pending_fetch"] = [(0, Tk, Tk, iod_merged)]
        lsq_chunk = (
            lsq_out.status,
            lsq_out.elements,
            lsq_out.normalised_rms,
            cov_tri_dev,
            nact_dev,
            lsq_out.total_newton_iterations,
        )
        if minimal_fetch:
            # keep the element vectors on device for the (rare) overflow
            # gather; the kernel's own seed-ok flag replaces the host-side
            # isfinite(eqv) screen the bulk fetch can no longer do, and the
            # rows the results DO consume ride the bulk fetch as a
            # device-compacted slice (one-slot lists: the finalize walks
            # deferred/need per fetch chunk)
            st["deferred_iod"] = [(iod_merged[2], iod_merged[3])]
            cap = min(len(sel_rows), max(_NEED_CAP_FLOOR, len(sel_rows) // 8))
            st["need_pack"] = [_compact_need_rows(
                iod_merged[0], iod_merged[2], iod_merged[3],
                lsq_out.status, lsq_out.elements, ok_dev, cap=cap,
            )]
            lsq_chunk = lsq_chunk + (ok_dev,)
        return PendingLsq(
            dataset, st=st, lsq_pend=[lsq_chunk], slim=slim_fetch,
            as_table=as_table, minimal=minimal_fetch,
        )

    # dispatch the seeded correction per IOD chunk (chunks are
    # width-homogeneous, so each runs at its own obs width), then
    # ONE bulk transfer for every stage of every chunk.  Deferred-element
    # mode carries one compact slice + on-device table pair PER chunk
    # (chunk-local row indices; the finalize adds each chunk's kept-order
    # offset), so minimal_fetch composes with every dispatch shape.
    runner = _get_runner(config, ephem, with_bias, seeded=True)
    lsq_pend = []
    deferred_list = []
    need_list = []
    for (t0g, t1g, Tg, iod_out), (glob_dev, valid_dev) in zip(
        st["pending"], st["chunk_tables"]
    ):
        lsq_out, sig_dev, nact_dev, cov_tri_dev, ok_dev = runner(
            iod_out[0], iod_out[3], iod_out[4], base, glob_dev,
            valid_dev,
        )
        lsq_chunk = (
            lsq_out.status,
            lsq_out.elements,
            lsq_out.normalised_rms,
            cov_tri_dev,
            nact_dev,
            lsq_out.total_newton_iterations,
        )
        if minimal_fetch:
            deferred_list.append((iod_out[2], iod_out[3]))
            n_rows = int(iod_out[0].shape[0])
            cap = min(n_rows, max(_NEED_CAP_FLOOR, n_rows // 8))
            need_list.append(_compact_need_rows(
                iod_out[0], iod_out[2], iod_out[3],
                lsq_out.status, lsq_out.elements, ok_dev, cap=cap,
            ))
            lsq_chunk = lsq_chunk + (ok_dev,)
        lsq_pend.append(lsq_chunk)
    if minimal_fetch:
        st["deferred_iod"] = deferred_list
        st["need_pack"] = need_list
    return PendingLsq(
        dataset, st=st, lsq_pend=lsq_pend, slim=slim_fetch,
        as_table=as_table, minimal=minimal_fetch,
    )


def fit_lsq_finalize(pending: PendingLsq):
    """Fetch a dispatched fused fit's device outputs (one bulk transfer)
    and build the per-trajectory result map (or columnar
    :class:`~outfit_tpu.lsq.table.LsqTable` when dispatched with
    ``as_table=True``)."""
    if pending.results is not None:
        if pending.as_table:
            from outfit_tpu.lsq.table import LsqTable

            return LsqTable.from_results(
                pending.dataset.traj_ids, pending.results
            )
        return pending.results
    dataset, st, lsq_pend = pending.dataset, pending.st, pending.lsq_pend
    if pending.packed is not None:
        from outfit_tpu.utils.fetch import unpack_fetched

        iod_fetched, lsq_fetched, need_fetched = unpack_fetched(
            jax.device_get(pending.packed), pending.pack_spec
        )
    else:
        iod_fetched, lsq_fetched, need_fetched = jax.device_get(
            (
                [o for *_, o in st.get("pending_fetch", st["pending"])],
                lsq_pend,
                st.get("need_pack", ()),
            )
        )
    if pending.as_table:
        return _build_fused_table(
            dataset, st, iod_fetched, lsq_fetched, need_fetched
        )
    return _build_fused_results(dataset, st, iod_fetched, lsq_fetched)


#: deferred-row element gather (minimal-fetch finalize); compiled once per
#: (table rows, padded request) shape pair — both power-of-two bucketed
_gather_rows_jit = jax.jit(
    lambda el, eqv, idx: (jnp.take(el, idx, axis=0), jnp.take(eqv, idx, axis=0))
)


@partial(jax.jit, static_argnames=("cap",))
def _compact_need_rows(rms, el, eqv, status, elements, ok, cap: int):
    """Device-side compaction of the rows whose RESULT consumes the IOD
    seed vectors (non-converged rows with a finite IOD fit), up to a static
    ``cap``.  Dispatched right after the correction kernels so the compact
    slice rides the SAME bulk fetch — a host-side row selection would need
    a second device round-trip that queues behind the next dataset's
    kernels and stalls the stream pipeline.

    ``jnp.nonzero(size=cap)`` returns the row positions in ascending order
    (real rows precede any pad-duplicate positions) with trailing fill;
    the finalize keeps the first ``min(n, cap)`` entries and falls back to
    a live gather for the (rare) overflow beyond ``cap``."""
    conv = ok & (status == STATUS_OK) & jnp.isfinite(elements).all(-1)
    need = jnp.isfinite(rms) & ~conv
    idx = jnp.nonzero(need, size=cap, fill_value=len(need))[0].astype(jnp.int32)
    return idx, need.sum().astype(jnp.int32), el[idx % len(need)], eqv[idx % len(need)]


def _fetch_deferred_rows(deferred, need):
    """Gather rows ``need`` of the on-device (el, eqv) tables and fetch them
    as one packed buffer.  ``need`` is padded to a power of two so the jitted
    gather and the fetch shapes stay compile-cached across datasets."""
    from outfit_tpu.utils.fetch import pack_for_fetch, unpack_fetched

    el_dev, eqv_dev = deferred
    n = int(need.size)
    n_pad = 1 << max(0, int(n - 1).bit_length())
    idx = np.zeros(n_pad, np.int32)
    idx[:n] = need
    el_g, eqv_g = _gather_rows_jit(el_dev, eqv_dev, jnp.asarray(idx))
    bufs, spec = pack_for_fetch((el_g, eqv_g))
    el_h, eqv_h = unpack_fetched(jax.device_get(bufs), spec)
    return el_h[:n], eqv_h[:n]


def _live_lsq_chunks(st, lsq_fetched):
    """Per-chunk fetched LSQ outputs -> kept-order column tuples."""
    if st.get("lsq_merged"):
        merged = lsq_fetched[0]
        return [
            tuple(a[off : off + Tg] for a in merged)
            for off, Tg in st["lsq_merged"]
        ]
    return [
        tuple(a[:Tg] for a in chunk)
        for chunk, (_, _, Tg, _) in zip(lsq_fetched, st["pending"])
    ]


def _build_fused_table(dataset, st, iod_fetched, lsq_fetched, need_fetched=()):
    """Columnar finalize: vectorized numpy assembly, no per-row objects.
    Row order = ``dataset.traj_ids``; see :class:`outfit_tpu.lsq.table.LsqTable`."""
    from outfit_tpu.iod.api import _fill_iod_out_arrays, padded_dataset_arrays
    from outfit_tpu.lsq.table import (
        IOD_HOST_SCREENED,
        IOD_NO_FEASIBLE_TRIPLETS,
        IOD_NO_VIABLE_ORBIT,
        IOD_OK,
        IOD_SEED_NOT_FINITE,
        LsqTable,
    )

    live = _live_lsq_chunks(st, lsq_fetched)
    status_k = np.concatenate([c[0] for c in live]).astype(np.int8)
    elements_k = np.concatenate([c[1] for c in live])
    rms_k = np.concatenate([c[2] for c in live])
    cov_tri_k = np.concatenate([c[3] for c in live])
    nact_k = np.concatenate([c[4] for c in live]).astype(np.int32)
    its_k = np.concatenate([c[5] for c in live]).astype(np.int32)

    lane_counts, ktrips = _fill_iod_out_arrays(st, iod_fetched)
    best_rms, kind, el, eqv, epoch, corrected = st["out_arrays"]
    kept_rows = np.asarray(st["kept_rows"], np.int64)
    tids = list(dataset.traj_ids)
    N = len(tids)

    # --- kept-order stage flags (mirrors the dict-mode row logic) ---
    iod_ok_k = np.isfinite(best_rms)
    if len(live[0]) > 6:
        # minimal-fetch mode: eqv never crossed the link; the kernel's own
        # seed-ok flag (isfinite(rms) & isfinite(eqv).all) substitutes —
        # every consumer below ANDs it with iod_ok_k, where the two agree
        seed_finite_k = np.concatenate([c[6] for c in live]).astype(bool)
    else:
        seed_finite_k = np.isfinite(eqv).all(axis=1)
    conv_k = iod_ok_k & seed_finite_k & (status_k == STATUS_OK)
    conv_k &= np.isfinite(elements_k).all(axis=1)
    fell_k = iod_ok_k & seed_finite_k & ~conv_k

    deferred = st.get("deferred_iod")
    if deferred is not None:
        # back-fill the element vectors for just the rows whose RESULT is
        # the IOD seed (non-converged kept rows); converged rows keep NaN —
        # their fit elements are the LSQ ones (documented minimal-fetch
        # contract).  Each fetch chunk carries its own device-compacted
        # slice with CHUNK-LOCAL row indices (+ its on-device table pair
        # for cap overflow, rare); the merged path is one pseudo-chunk.
        need = np.nonzero(iod_ok_k & ~conv_k)[0]
        if st.get("lsq_merged"):
            spans = [(0, len(best_rms))]
        else:
            spans = [(t0g, t1g) for (t0g, t1g, _, _) in st["pending"]]
        nf_list = need_fetched if need_fetched else [()] * len(spans)
        for (t0g, t1g), dfr, nf in zip(spans, deferred, nf_list):
            need_c = need[(need >= t0g) & (need < t1g)] - t0g
            fetched_rows = np.empty(0, np.int64)
            if nf:
                idx, _n, el_rows, eqv_rows = nf
                idx = idx.astype(np.int64)
                # ascending positions: real rows precede pad-duplicate/
                # fill slots (>= the chunk's live-row count) — keep the
                # in-range prefix
                keep = idx < (t1g - t0g)
                fetched_rows = idx[keep]
                el[t0g + fetched_rows] = el_rows[keep]
                eqv[t0g + fetched_rows] = eqv_rows[keep]
            rest = np.setdiff1d(need_c, fetched_rows, assume_unique=True)
            if rest.size:
                el_rest, eqv_rest = _fetch_deferred_rows(dfr, rest)
                el[t0g + rest] = el_rest
                eqv[t0g + rest] = eqv_rest

    err_k = np.where(
        iod_ok_k,
        np.where(seed_finite_k, IOD_OK, IOD_SEED_NOT_FINITE),
        IOD_NO_VIABLE_ORBIT,
    ).astype(np.int8)
    if ktrips is not None:
        err_k[~iod_ok_k & (ktrips == 0)] = IOD_NO_FEASIBLE_TRIPLETS

    # --- scatter kept-order -> dataset-order with inert fill ---
    def scat(col, fill, dtype=None):
        shape = (N,) + col.shape[1:]
        out = np.full(shape, fill, dtype or col.dtype)
        out[kept_rows] = col
        return out

    kept = np.zeros(N, bool)
    kept[kept_rows] = True

    counts_kept = np.asarray(st["counts_kept"], np.int64)
    # fallback rows report the observation count (dict-mode parity);
    # converged rows the post-rejection active count
    nact_full_k = np.where(conv_k, nact_k, counts_kept.astype(np.int32))

    table = LsqTable(
        traj_ids=tids,
        kept=kept,
        iod_ok=scat(iod_ok_k, False),
        iod_error_code=scat(err_k, IOD_HOST_SCREENED),
        iod_rms=scat(best_rms, np.nan),
        iod_kind=scat(kind.astype(np.int8), -1),
        iod_corrected=scat(corrected.astype(bool), False),
        iod_epoch=scat(epoch, np.nan),
        iod_elements=scat(el, np.nan),
        iod_equinoctial=scat(eqv, np.nan),
        ok=scat(iod_ok_k & seed_finite_k, False),
        converged=scat(conv_k, False),
        fell_back_to_iod=scat(fell_k, False),
        status=scat(status_k, -1),
        normalised_rms=scat(np.where(conv_k, rms_k, best_rms), np.nan),
        epoch=scat(epoch, np.nan),
        equinoctial=scat(np.where(conv_k[:, None], elements_k, eqv), np.nan),
        covariance_tri=scat(
            np.where(conv_k[:, None], cov_tri_k, np.nan), np.nan
        ),
        uncertainties=scat(
            np.where(
                conv_k[:, None],
                np.sqrt(
                    np.maximum(cov_tri_k[:, _TRIL_DIAG], 0.0)
                ),
                np.nan,
            ),
            np.nan,
        ),
        n_active_obs=scat(nact_full_k, 0),
        total_newton_iterations=scat(
            np.where(conv_k, its_k, 0).astype(np.int32), 0
        ),
        host_errors={
            tid: r.error
            for tid, r in st["results"].items()
            if getattr(r, "error", None)
        },
        _lane_counts=scat(lane_counts.astype(np.int64), 0),
        _arc=scat(np.asarray(st["arc_kept"], np.float64), np.nan),
        _counts=scat(counts_kept, 0),
        _dt_min=st["params"].dt_min,
        _dt_max=st["params"].dt_max_triplet,
        _ktrips=None if ktrips is None else scat(ktrips, 0),
    )
    return table


#: positions of the 6 diagonal entries inside the 21-slot lower triangle
_TRIL_DIAG = np.array([0, 2, 5, 9, 14, 20])


def _build_fused_results(dataset, st, iod_fetched, lsq_fetched):
    from outfit_tpu.iod.api import _finalize_iod, padded_dataset_arrays

    # chunk obs widths differ: reduce selection to active counts
    # per chunk, then concatenate the width-independent outputs in
    # kept order (chunks tile kept_tids contiguously).  In merged-LSQ mode
    # there is ONE correction output covering every kept row already.
    if st.get("lsq_merged"):
        merged = lsq_fetched[0]
        live = [
            tuple(a[off : off + Tg] for a in merged)
            for off, Tg in st["lsq_merged"]
        ]
    else:
        live = [
            tuple(a[:Tg] for a in chunk)
            for chunk, (_, _, Tg, _) in zip(lsq_fetched, st["pending"])
        ]
    status = np.concatenate([c[0] for c in live])
    elements = np.concatenate([c[1] for c in live])
    rms = np.concatenate([c[2] for c in live])
    cov = _unpack_cov(np.concatenate([c[3] for c in live]))
    its = np.concatenate([c[5] for c in live])
    # 1-sigma host-side from the fetched covariance diagonal (identical
    # math to elements/uncertainty.py) — fetching a separate sigma array
    # would duplicate 6 of the covariance's 21 transferred values
    sigmas = np.sqrt(
        np.maximum(np.diagonal(cov, axis1=-2, axis2=-1), 0.0)
    )
    n_active_vec = np.concatenate([c[4] for c in live])
    initial_orbits = _finalize_iod(st, iod_fetched)
    results = {}
    kept_tids = st["kept_tids"]
    kept_set = set(kept_tids)
    for tid in dataset.iter_traj_id():
        if tid in kept_set:
            continue
        iod = initial_orbits.get(tid)
        err = iod.error if iod is not None else "no IOD seed"
        results[tid] = LsqResult(
            tid, ok=False, error=f"IOD failed: {err}", iod=iod
        )
    counts_kept = padded_dataset_arrays(dataset, with_values=False).counts[
        st["kept_rows"]
    ]
    # bulk scalar conversion (per-row numpy casts are the survey-scale
    # finalize hotspot; see _finalize_iod)
    ok_l = ((status == STATUS_OK) & np.isfinite(elements).all(axis=1)).tolist()
    rms_l = rms.tolist()
    el_rows = list(elements)
    cov_rows = list(cov)
    sig_rows = list(sigmas)
    nact_l = n_active_vec.tolist()
    its_l = its.tolist()
    status_l = status.tolist()
    counts_l = counts_kept.tolist()
    for t, tid in enumerate(kept_tids):
        iod = initial_orbits[tid]
        if not iod.ok or iod.equinoctial is None:
            results[tid] = LsqResult(
                tid, ok=False,
                error=f"IOD failed: {iod.error}", iod=iod,
            )
            continue
        if not np.isfinite(iod.equinoctial).all():
            results[tid] = LsqResult(
                tid, ok=False, error="IOD seed not finite", iod=iod
            )
            continue
        if ok_l[t]:
            results[tid] = LsqResult(
                tid,
                ok=True,
                status=status_l[t],
                normalised_rms=rms_l[t],
                epoch=iod.epoch,
                equinoctial=el_rows[t],
                covariance=cov_rows[t],
                uncertainties=sig_rows[t],
                n_active_obs=nact_l[t],
                total_newton_iterations=its_l[t],
                iod=iod,
            )
        else:
            results[tid] = LsqResult(
                tid,
                ok=True,
                error=_status_name(status_l[t]),
                status=status_l[t],
                fell_back_to_iod=True,
                normalised_rms=iod.rms,
                epoch=iod.epoch,
                equinoctial=np.array(iod.equinoctial),
                n_active_obs=counts_l[t],
                iod=iod,
            )
    return results


def _fit_lsq_seeded(
    dataset, ephem, config, initial_orbits, mesh, cache=None, ut1=None
):
    """Two-step path: differential correction from an explicit per-trajectory
    seed map (the ``initial_orbits=`` resume path, diff_cor
    obs_dataset_api.rs:68-71,211-213)."""
    if cache is None:
        cache = ObserverCache.build(dataset, ephem, ut1)

    results: Dict[str, LsqResult] = {}
    rows = []
    for tid in dataset.iter_traj_id():
        iod = initial_orbits.get(tid)
        if iod is None or not iod.ok or iod.equinoctial is None:
            err = iod.error if iod is not None else "no IOD seed"
            results[tid] = LsqResult(tid, ok=False, error=f"IOD failed: {err}", iod=iod)
            continue
        if not np.isfinite(iod.equinoctial).all():
            results[tid] = LsqResult(
                tid, ok=False, error="IOD seed not finite", iod=iod
            )
            continue
        rows.append((tid, iod))

    if not rows:
        return results

    from outfit_tpu.iod.api import _bucket, padded_dataset_arrays

    # LAYOUT only (one lexsort): observation values are gathered on device
    # from the dataset-order base arrays inside the jitted runner
    lay = padded_dataset_arrays(dataset, with_values=False)
    n_max = lay.n_max
    T = len(rows)
    tid_to_row = {tid: i for i, tid in enumerate(dataset.traj_ids)}
    rsel = np.fromiter(
        (tid_to_row[tid] for tid, _ in rows), np.int64, count=T
    )
    el0 = np.stack([iod.equinoctial for _, iod in rows])
    ep0 = np.fromiter((iod.epoch for _, iod in rows), np.float64, count=T)

    # ALWAYS pad the trajectory axis to a power-of-two bucket with inert
    # rows (no valid observations, benign seed elements): T is the number
    # of IOD-converged trajectories, which varies per dataset — unbucketed
    # it recompiles the correction kernel for every dataset.  With a mesh, the
    # bucket is additionally a mesh multiple so the batch shards evenly.
    # Padded rows are dropped on unpack.
    from outfit_tpu.parallel import pad_to_multiple, replicate, shard_batch

    Tb = _bucket(T)
    if mesh is not None:
        Tb = pad_to_multiple(Tb, mesh.devices.size)
    pad = Tb - T
    g_glob = np.concatenate(
        [lay.glob_idx[rsel], np.zeros((pad, n_max), np.int64)]
    ).astype(np.int32)
    g_valid = np.concatenate([lay.valid[rsel], np.zeros((pad, n_max), bool)])
    if pad:
        el0 = np.concatenate([el0, np.tile([2.0, 0, 0, 0, 0, 0.0], (pad, 1))])
        ep0 = np.concatenate([ep0, np.full(pad, 57000.0)])

    # dataset-order base arrays (shared with fit_full_iod: one upload)
    from outfit_tpu.iod.api import device_base_arrays

    with_bias = dataset.bias_ra is not None
    base = device_base_arrays(dataset, cache)

    el = jnp.asarray(el0)
    ep = jnp.asarray(ep0)
    glob = jnp.asarray(g_glob)
    valid_dev = jnp.asarray(g_valid)
    if mesh is not None:
        el = shard_batch(mesh, el)
        ep = shard_batch(mesh, ep)
        glob = shard_batch(mesh, glob)
        valid_dev = shard_batch(mesh, valid_dev)
        base = replicate(mesh, base)

    out, sig_dev, nact_dev, cov_tri_dev = _get_runner(config, ephem, with_bias)(
        el, ep, base, glob, valid_dev
    )
    valid = g_valid

    # ONE bulk transfer as ONE packed buffer (each individual transfer
    # costs a setup on top of bandwidth; utils/fetch.py)
    from outfit_tpu.utils.fetch import pack_for_fetch, unpack_fetched

    _tree = (
        out.status,
        out.elements,
        out.normalised_rms,
        cov_tri_dev,
        nact_dev,
        out.total_newton_iterations,
    )
    # int leaves (status / n_active / iteration counters, all << 2**24)
    # ride the f32 buffer — exact values, 3 fewer f64 slots per row
    packed, spec = pack_for_fetch(
        _tree, (True, False, False, False, True, True)
    )
    status, elements, rms, cov_tri, n_active_vec, its = (
        jax.device_get(_tree)
        if packed is None
        else unpack_fetched(jax.device_get(packed), spec)
    )
    cov = _unpack_cov(cov_tri)
    # 1-sigma host-side from the covariance diagonal (six of its 21
    # transferred values) — same math as elements/uncertainty.py
    sigmas = np.sqrt(np.maximum(np.diagonal(cov, axis1=-2, axis2=-1), 0.0))

    # bulk scalar conversion (per-row numpy casts cost ~3 us each; at
    # survey scale the loop body must be pure construction)
    ok_l = ((status == STATUS_OK) & np.isfinite(elements).all(axis=1)).tolist()
    nval_l = valid.sum(axis=1).tolist()
    rms_l = rms.tolist()
    ep_l = ep0.tolist()
    el_rows = list(elements)
    cov_rows = list(cov)
    sig_rows = list(sigmas)
    nact_l = n_active_vec.tolist()
    its_l = its.tolist()
    status_l = status.tolist()
    for t, (tid, iod) in enumerate(rows):
        if ok_l[t]:
            results[tid] = LsqResult(
                tid,
                ok=True,
                status=status_l[t],
                normalised_rms=rms_l[t],
                epoch=ep_l[t],
                equinoctial=el_rows[t],
                covariance=cov_rows[t],
                uncertainties=sig_rows[t],
                n_active_obs=nact_l[t],
                total_newton_iterations=its_l[t],
                iod=iod,
            )
        else:
            # fall back to the IOD orbit (diff_cor mod.rs:113)
            results[tid] = LsqResult(
                tid,
                ok=True,
                error=_status_name(status_l[t]),
                status=status_l[t],
                fell_back_to_iod=True,
                normalised_rms=float(iod.rms),
                epoch=float(iod.epoch),
                equinoctial=np.array(iod.equinoctial),
                n_active_obs=nval_l[t],
                iod=iod,
            )
    return results


def fit_lsq(
    dataset,
    ephem,
    iod_params: IODParams = IODParams(),
    config: DifferentialCorrectionConfig = DifferentialCorrectionConfig(),
    seed: int = 0,
    ut1: Optional[Ut1Provider] = None,
    error_model: Optional[ErrorModel] = None,
    initial_orbits: Optional[Dict[str, FitResult]] = None,
    mesh="auto",
    cache: Optional[ObserverCache] = None,
    as_table: bool = False,
) -> Dict[str, LsqResult]:
    """IOD + differential correction for every trajectory of the dataset.

    ``mesh="auto"`` (default) shards the trajectory batch over a 1-D data
    mesh of all local devices when more than one is present (and forwards
    the mesh to the IOD seeding stage); ``mesh=None`` forces single-device.

    ``initial_orbits`` resumes the correction from previously computed IOD
    results instead of re-running IOD (parity: diff_cor
    obs_dataset_api.rs:68-71).
    """
    if initial_orbits is not None:
        from outfit_tpu.parallel import resolve_mesh

        mesh = resolve_mesh(mesh)
        if error_model is not None:
            dataset.apply_error_model(error_model)
            dataset.apply_batch_rms_correction(iod_params.gap_max)
        if np.isnan(dataset.ra_error).any():
            dataset.apply_error_model(ErrorModel.fcct14())
            dataset.apply_batch_rms_correction(iod_params.gap_max)
        if cache is None:
            cache = ObserverCache.build(dataset, ephem, ut1)
        res = _fit_lsq_seeded(dataset, ephem, config, initial_orbits, mesh, cache)
        if as_table:
            from outfit_tpu.lsq.table import LsqTable

            return LsqTable.from_results(dataset.traj_ids, res)
        return res
    return fit_lsq_finalize(
        fit_lsq_dispatch(
            dataset, ephem, iod_params, config, seed, ut1, error_model,
            mesh, cache, as_table=as_table,
        )
    )


# finalize-pool width for fit_lsq_stream (internal)
_FINALIZE_WORKERS = 2


def fit_lsq_stream(
    datasets,
    ephem,
    iod_params: IODParams = IODParams(),
    config: DifferentialCorrectionConfig = DifferentialCorrectionConfig(),
    seed: int = 0,
    ut1: Optional[Ut1Provider] = None,
    error_model: Optional[ErrorModel] = None,
    mesh="auto",
    depth: int = 2,
    prefetch: bool = True,
    slim_fetch: bool = False,
    as_table: bool = False,
    minimal_fetch: bool = False,
):
    """Pipelined fused fits over a stream of datasets.

    ``slim_fetch=True`` cuts the device->host result bytes ~40% by moving
    the covariance triangle and IOD reporting leaves as float32 (see
    :func:`fit_lsq_dispatch`); LSQ orbital elements stay exact f64.
    Default False (full bit-parity with sequential ``fit_lsq``).
    ``minimal_fetch=True`` (requires ``as_table=True``) further defers the
    IOD element vectors to a tiny per-dataset second transfer covering only
    non-converged rows (see :func:`fit_lsq_dispatch`) — the
    fetch-bandwidth-bound service mode.

    Keeps up to ``depth`` datasets in flight: while the device executes
    dataset N's kernels, the host preps and dispatches dataset N+1 (JAX
    dispatch is asynchronous), then fetches N's results.  In steady state
    the slower of {host prep + transfers, device compute} sets throughput
    instead of their sum — the device-queue analogue of the reference's
    overlap of rayon workers across trajectories
    (obs_dataset_api.rs:174-207 processes independent work concurrently).

    ``prefetch=True`` (default) runs each finalize (device fetch + result
    construction) on one background thread: device_get releases the GIL
    while the transfer rides the interconnect, so it overlaps the next
    dataset's host prep.  Results are identical either way — this is pure
    scheduling.

    Yields ``(dataset, results)`` pairs in input order.
    """
    from collections import deque

    ex = None
    if prefetch:
        from concurrent.futures import ThreadPoolExecutor

        # two workers so dataset N's device_get (GIL-free transfer)
        # overlaps dataset N-1's result construction (GIL-bound Python);
        # results stay input-ordered via the in-flight deque
        ex = ThreadPoolExecutor(_FINALIZE_WORKERS, thread_name_prefix="lsq-finalize")

    def _finalize(pend):
        if ex is not None:
            return pend.dataset, pend_futures.pop(id(pend)).result()
        return pend.dataset, fit_lsq_finalize(pend)

    from outfit_tpu.utils.runtime import clear_executables_if_crowded

    pend_futures = {}
    inflight = deque()
    try:
        for ds in datasets:
            # backstop for unbounded shape streams: nearing vm.max_map_count
            # crashes inside XLA instead of raising (utils/runtime.py)
            clear_executables_if_crowded()
            pend = fit_lsq_dispatch(
                ds, ephem, iod_params, config, seed, ut1, error_model, mesh,
                slim_fetch=slim_fetch, as_table=as_table,
                minimal_fetch=minimal_fetch,
            )
            if ex is not None:
                pend_futures[id(pend)] = ex.submit(fit_lsq_finalize, pend)
            inflight.append(pend)
            while len(inflight) >= max(depth, 1) + 1:
                yield _finalize(inflight.popleft())
        while inflight:
            yield _finalize(inflight.popleft())
    finally:
        if ex is not None:
            ex.shutdown(wait=False, cancel_futures=True)


def fit_lsq_stream_escalating(
    datasets,
    ephem,
    stages,
    seed: int = 0,
    ut1: Optional[Ut1Provider] = None,
    error_model: Optional[ErrorModel] = None,
    mesh="auto",
    retry_if=None,
    flush_every: int = 4,
    refit_fill: int = 8,
    **stream_kw,
):
    """Pipelined tiered fitting: the LEAN stage streams every dataset
    (:func:`fit_lsq_stream`), and trajectories that fail it are re-fit
    with the richer stages in BATCHED passes spanning up to
    ``flush_every`` datasets' failures at once.

    ``refit_fill``: the refit pass's compile shapes are COMPOSITION
    dependent (which obs-width buckets the failures span, and the width
    coalescer's merge decision over them) — left alone, every new
    failure mix compiles new kernels, and a cold one inside a service's
    steady state costs a long compile (dozens of XLA compiles on a
    6-dataset real-cadence stream whose warm pass had seen one mix).
    Topping the refit up to ``refit_fill`` trajectories per obs-width
    bucket PRESENT IN THE HELD DATASETS with sacrificial rows (their
    results are discarded, never patched) pins the refit composition —
    and therefore its kernels — to one shape per workload.  0 disables.

    Rationale: on real survey workloads a lean IOD profile converges
    ~99.9+% of arcs, and the rich kernels are LATENCY-bound — a re-fit
    of 8 stragglers costs nearly the same dispatch as 4096 — so
    per-dataset escalation would erase the lean profile's saving.  Batching the failures of several datasets into one rich
    pass amortizes that latency to near zero at the stream's failure
    rates (~1 per few thousand arcs).

    Yields ``(dataset, results)`` in input order, with failed rows
    PATCHED by the richer stages before their dataset is yielded
    (results are buffered up to ``flush_every`` datasets).  Requires the
    columnar path (``as_table=True``, the default here) or plain dict
    results.  Determinism: per-trajectory seeds make each re-fit
    independent of which other trajectories escalated with it; escalated
    rows draw their noise from the buffer-position-prefixed id
    ("<k>|<tid>", k = dataset index modulo ``flush_every``), so a fixed
    stream is reproducible, but an escalated row's realization differs
    from a standalone ``fit_lsq_escalating`` run of the same dataset.
    """
    if not stages:
        raise ValueError("needs at least one (params, config) stage")
    user_retry = retry_if is not None
    if retry_if is None:
        retry_if = lambda r: (not r.ok) or r.fell_back_to_iod  # noqa: E731
    stream_kw.setdefault("as_table", True)
    params0, cfg0 = stages[0]

    held = []  # [(dataset, results, [failed tids])]

    def _failed_tids(ds, res):
        if isinstance(res, dict):
            return [tid for tid, r in res.items() if retry_if(r)]
        # columnar: the DEFAULT predicate retries exactly rows whose
        # converged flag is down, so the cheap vector mask pre-filters;
        # a USER predicate may escalate converged rows too (e.g. high
        # nRMS), so it must see every row — parity with
        # fit_lsq_escalating, which applies retry_if to all results
        if user_retry:
            tids = np.asarray(res.traj_ids, object)
        else:
            tids = np.asarray(res.traj_ids, object)[~np.asarray(res.converged)]
        return [tid for tid in tids if retry_if(res.result(tid))]

    def _flush():
        """One batched rich pass per remaining stage over the held
        datasets' accumulated failures; patch and yield in order."""
        import dataclasses

        from outfit_tpu.observations.dataset import ObsDataset

        # one failure subset per held dataset (subset preserves every
        # column — catalog codes, biases — unlike re-pushing Observation
        # views), concatenated with held-index-prefixed ids so identical
        # fixture ids from different datasets stay distinct
        parts = []
        prefixes = []  # parallel: patch-back prefix per part
        n_fail_bucket = {}  # obs-width bucket -> failing-row count
        from outfit_tpu.iod.api import _bucket_width

        for hi, (ds, res, fails) in enumerate(held):
            if not fails:
                continue
            fset = set(fails)
            rows = []
            for tid, g in ds.trajectory_groups():
                if tid in fset and g.size:
                    rows.append(g)
                    b = int(_bucket_width(g.size))
                    n_fail_bucket[b] = n_fail_bucket.get(b, 0) + 1
            if rows:
                parts.append(ds.subset(np.concatenate(rows)))
                prefixes.append(str(hi))
        if parts and refit_fill:
            # sacrificial filler rows pin the refit composition (see the
            # refit_fill doc): refit_fill rows in EVERY width bucket the
            # held datasets contain, failures included
            want = {}
            for hi, (ds, _res, fails) in enumerate(held):
                counts = np.bincount(
                    np.asarray(ds.traj_index, np.int64),
                    minlength=len(ds.traj_ids),
                )
                for b in set(int(x) for x in _bucket_width(counts)):
                    want.setdefault(b, refit_fill)
            fill_rows = []
            need = {
                b: max(n - n_fail_bucket.get(b, 0), 0)
                for b, n in want.items()
            }
            for hi, (ds, _res, fails) in enumerate(held):
                if not any(need.values()):
                    break
                fset = set(fails)
                for tid, g in ds.trajectory_groups():
                    if tid in fset or not g.size:
                        continue
                    b = int(_bucket_width(g.size))
                    if need.get(b, 0) > 0:
                        need[b] -= 1
                        fill_rows.append((hi, g))
            if fill_rows:
                by_hi = {}
                for hi, g in fill_rows:
                    by_hi.setdefault(hi, []).append(g)
                for hi, gs in by_hi.items():
                    parts.append(held[hi][0].subset(np.concatenate(gs)))
                    # hi kept in the prefix: the same trajectory id can
                    # occur in several held datasets
                    prefixes.append(f"~fill{hi}")
        if parts:
            # concat dedupes identical observers, so the merged table's
            # length (a kernel-shape bucket) matches any one input's —
            # the warm shapes of a plain per-dataset fit cover the refit
            cur = ObsDataset.concat(
                parts, rename=lambda k, tid: f"{prefixes[k]}|{tid}"
            )
            for k, (p, c) in enumerate(stages[1:], start=1):
                res_k = fit_lsq(
                    cur, ephem, p, c, seed=seed, ut1=ut1,
                    error_model=error_model, mesh=mesh,
                )
                clean = {}  # merged id -> clean-id result (retry_if input)
                for mtid, r in res_k.items():
                    hi_s, tid = mtid.split("|", 1)
                    if hi_s.startswith("~fill"):
                        continue  # sacrificial shape filler, discard
                    tgt = held[int(hi_s)][1]
                    rr = dataclasses.replace(r, traj_id=tid)
                    clean[mtid] = rr
                    if isinstance(tgt, dict):
                        tgt[tid] = rr
                    else:
                        tgt.patch_row(tid, rr)
                if k == len(stages) - 1:
                    break
                # retry_if sees the CLEAN-id results (parity with
                # _failed_tids and fit_lsq_escalating: a user predicate
                # inspecting r.traj_id must never see the merged
                # '<hi>|<tid>' prefix); sacrificial '~fill' rows are
                # already excluded from ``clean`` — their results are
                # discarded, and re-fitting them would waste device work
                # and make later-stage compile composition depend on
                # filler outcomes
                retry = {t for t, rr in clean.items() if retry_if(rr)}
                if not retry:
                    break
                rows = [
                    g for t, g in cur.trajectory_groups()
                    if t in retry and g.size
                ]
                if not rows:
                    break
                cur = cur.subset(np.concatenate(rows))
        out = [(ds, res) for ds, res, _ in held]
        held.clear()
        return out

    for ds, res in fit_lsq_stream(
        datasets, ephem, params0, cfg0, seed=seed, ut1=ut1,
        error_model=error_model, mesh=mesh, **stream_kw,
    ):
        held.append((ds, res, _failed_tids(ds, res)))
        if len(held) >= max(flush_every, 1):
            yield from _flush()
    yield from _flush()


def fit_lsq_escalating(
    dataset,
    ephem,
    stages,
    seed: int = 0,
    ut1: Optional[Ut1Provider] = None,
    error_model: Optional[ErrorModel] = None,
    mesh="auto",
    retry_if=None,
):
    """Tiered fitting: stage 0 fits every trajectory; trajectories that
    fail it are re-fit with each successively richer stage, on the failing
    subset only.

    ``stages`` is a list of ``(IODParams, DifferentialCorrectionConfig)``
    pairs ordered lean -> rich.  ``retry_if(result) -> bool`` decides
    whether a trajectory escalates (default: did not converge through the
    least-squares loop, i.e. ``not r.ok or r.fell_back_to_iod``).

    This is the batch-idiomatic answer to ragged difficulty: most
    arcs converge under a cheap config (few triplets / realizations, tight
    iteration caps), so only the hard tail pays for a rich one — instead
    of every lane being padded to the budget the hardest arc needs.  The
    reference has no direct equivalent (its scalar per-trajectory loop
    always runs the full IODParams budget; obs_dataset_api.rs:145-172).

    Deterministic per trajectory: seeds fold in the trajectory id (the
    ``base_seed ^ stable_hash`` contract, obs_dataset_api.rs:277-296), so
    a trajectory's stage-k result does not depend on which other
    trajectories escalated with it.
    """
    if not stages:
        raise ValueError("fit_lsq_escalating needs at least one (params, config) stage")
    if retry_if is None:
        retry_if = lambda r: (not r.ok) or r.fell_back_to_iod  # noqa: E731
    cur = dataset
    results: Dict[str, LsqResult] = {}
    for k, (params, cfg) in enumerate(stages):
        res = fit_lsq(
            cur, ephem, params, cfg, seed=seed, ut1=ut1,
            error_model=error_model, mesh=mesh,
        )
        results.update(res)
        if k == len(stages) - 1:
            break
        retry = {tid for tid, r in res.items() if retry_if(r)}
        if not retry:
            break
        parts = [g for tid, g in cur.trajectory_groups() if tid in retry and g.size]
        if not parts:
            break
        cur = cur.subset(np.concatenate(parts))
    return results


#: Reference-name alias (``DifferentialCorrectionOutput``, diff_cor.rs:202-225).
DifferentialCorrectionOutput = LsqResult
