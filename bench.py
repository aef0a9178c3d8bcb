"""Benchmark: IOD+LSQ fits, N-body steps and ephemeris entries per second
on one NVIDIA GPU.

Prints JSON metric lines ``{"metric", "value", "unit"}``: a provisional
line as soon as the first stage has a measured number, then an improved
line after each later stage that beats it (the last line wins).

Structure:

* the bench is a supervisor: the parent process never imports jax; each
  stage runs in its own child process (``python bench.py --stage NAME``),
  one at a time, and writes result lines to a file the parent tails.  A
  child that stops producing output for ``$OUTFIT_BENCH_STALL_S``
  (default 240 s) or exceeds its per-stage cap is SIGKILLed (whole
  process group) and the supervisor continues with the next stage;
* the done-bar stages (headline stream, real-cadence escalating, DOP853)
  get one retry after a stall kill when the budget allows;
* the parent keeps the tiered best-so-far Reporter, so the last JSON
  line survives any child death; a watchdog thread flushes it and exits
  just before the wall budget (``$OUTFIT_BENCH_BUDGET_S``, default
  1380 s), and SIGTERM/SIGINT re-print it, so even an external
  ``timeout`` kill leaves a parsed JSON line in the tail;
* every stage checks the remaining budget before starting and is skipped
  (never started) when its estimated cost would not fit;
* a stage that uses JAX fails unless the first device is a GPU: there is
  no CPU fallback;
* the kill path is itself tested: a hidden ``wedge`` stage sleeps
  forever, and tests/test_bench_supervisor.py proves the supervisor
  kills it and still exits rc=0 with a valid metric line
  (``OUTFIT_BENCH_FORCE_WEDGE=<stage>`` hangs any real stage the same
  way).

The workload mirrors examples/run_full_iod_parallel.rs: K synthetic
trajectories (12 observations each) pushed through the batched Gauss-IOD
kernel and the differential-correction loop.  Timing covers the warm jitted
device execution (the production steady state); host-side dataset prep and
compile are excluded and reported on stderr.
"""

import json
import os
import signal
import sys
import threading
import time

import numpy as np

_T_START = time.time()
_BUDGET_S = float(os.environ.get("OUTFIT_BENCH_BUDGET_S", "1380"))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _elapsed():
    return time.time() - _T_START


def _remaining():
    return _BUDGET_S - _elapsed()


class Reporter:
    """Best-so-far metric line, printed immediately on every improvement.

    fits/sec results always outrank the propagation fallback; within a
    unit, higher value wins.  ``flush()`` re-prints the current best (the
    watchdog/signal path) so the process tail always ends with a valid
    line once any stage has completed.
    """

    def __init__(self):
        self.best = None
        self._best_rank = None
        self._lock = threading.Lock()

    def report(self, result, tier=0):
        """``tier`` orders honesty classes: 0 = propagation fallback,
        1 = kernels-only fits/sec (host prep excluded), 2 = end-to-end
        fits/sec.  A higher tier always replaces a lower one (an honest
        end-to-end number beats a flattering kernels-only one even when
        smaller); within a tier, higher value wins."""
        with self._lock:
            rank = (tier, result["value"])
            if self._best_rank is None or (
                rank[0] > self._best_rank[0]
                or (rank[0] == self._best_rank[0] and rank[1] > self._best_rank[1])
            ):
                self.best = result
                self._best_rank = rank
                print(json.dumps(result), flush=True)

    def flush(self, note=""):
        with self._lock:
            if self.best is not None:
                if note:
                    log(note)
                print(json.dumps(self.best), flush=True)
                return True
        if note:
            log(note + " (no stage completed - no metric line to flush)")
        return False


REPORTER = Reporter()

#: extra (non-ranked) metric lines already printed by the parent, in
#: arrival order — the tail fallback when no ranked stage completed
_EXTRAS_PRINTED = {}

#: pid of the live stage child (its own session/process group), killed by
#: the watchdog/signal paths so an exiting supervisor never orphans a
#: hung child
_CHILD_PID = [None]


def _flush_tail(note):
    """Guarantee the stdout tail ends with a parseable JSON line: the
    ranked best-so-far, else the last completed secondary metric, else an
    explicit failure marker.  Every exit path (normal, watchdog, signal)
    goes through here.  Returns True when a real measurement was
    printed."""
    if REPORTER.flush(note):
        return True
    if _EXTRAS_PRINTED:
        log(note + " (no ranked stage completed; re-printing the last "
            "secondary metric line)")
        print(json.dumps(list(_EXTRAS_PRINTED.values())[-1]), flush=True)
        return True
    if note:
        log(note + " (no stage completed at all)")
    print(json.dumps({
        "metric": "bench produced no measurement (all stages failed)",
        "value": 0.0, "unit": "none",
    }), flush=True)
    return False


def _kill_child():
    pid = _CHILD_PID[0]
    if pid is not None:
        try:
            os.killpg(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            pass


def _install_flush_guards():
    """Watchdog thread + signal handlers that keep the metric-line contract
    under timeouts.  The watchdog is the reliable path even in-child: a
    long-running XLA compile holds the main thread in C++ where Python
    signal handlers are deferred, but daemon threads keep running."""

    def _watchdog():
        while True:
            rem = _remaining()
            if rem <= 10.0:
                break
            time.sleep(min(rem - 10.0, 15.0))
        _kill_child()
        had = _flush_tail(
            f"watchdog: wall budget {_BUDGET_S:.0f}s nearly exhausted - "
            "flushing best-so-far metric and exiting"
        )
        os._exit(0 if had else 3)

    threading.Thread(target=_watchdog, daemon=True, name="bench-watchdog").start()

    def _on_signal(signum, frame):
        _kill_child()
        had = _flush_tail(f"signal {signum}: flushing best-so-far metric")
        os._exit(0 if had else 3)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except (ValueError, OSError):
            pass


#: per-process XLA compile accounting [count, total_seconds]; fed by a
#: jax.monitoring listener (installed in main) and reported per stage so
#: compile-shape growth is visible in every bench log
_COMPILES = [0, 0.0]


def _install_compile_tracker():
    try:
        import jax.monitoring as mon

        def _on_duration(key, dur, **kw):
            if key == "/jax/core/compile/backend_compile_duration":
                _COMPILES[0] += 1
                _COMPILES[1] += dur

        mon.register_event_duration_secs_listener(_on_duration)
    except Exception as e:  # tracking is best-effort
        log(f"compile tracker unavailable ({type(e).__name__}: {e})")




def bench_iod_lsq(n_traj: int, repeats: int = 3, precision: str = "mixed"):
    import jax
    import jax.numpy as jnp

    from outfit_tpu.iod.api import _iod_kernel
    from outfit_tpu.iod.params import IODParams
    from outfit_tpu.lsq.config import DifferentialCorrectionConfig
    from outfit_tpu.lsq.iteration import ObsArrays
    from outfit_tpu.lsq.loop import run_differential_correction
    from __graft_entry__ import _synthetic_batch

    # production configuration: mixed precision (f32 iterate + f64 polish)
    # with f64-polished elements (see tests/test_iod.py::TestMixedPrecision)
    # newton_max_it=20: quality is flat between 15 and 50 correction
    # iterations (docs/DESIGN.md) — the tail is pure straggler cost under
    # the batch-converged while loop
    params = IODParams(n_noise_realizations=3, precision=precision, newton_max_it=20)
    lanes_per_traj = 8  # ~2 triplets x 4 realizations
    n_obs = 12

    tri, obs_arrays, lane_traj, window = _synthetic_batch(
        n_traj=n_traj, lanes_per_traj=lanes_per_traj, n_obs=n_obs, seed=7
    )

    iod_fn = jax.jit(lambda t, o, lt, w: _iod_kernel(t, o, lt, w, params))
    t0 = time.time()
    out = iod_fn(tri, obs_arrays, lane_traj, window)
    jax.block_until_ready(out)
    log(f"IOD kernel compile+first run: {time.time() - t0:.1f}s")

    best = min(
        _timed(lambda: jax.block_until_ready(iod_fn(tri, obs_arrays, lane_traj, window)))
        for _ in range(repeats)
    )
    log(f"IOD warm: {best*1e3:.1f} ms for {n_traj} trajectories")

    # LSQ stage: REAL workload — the per-trajectory best IOD seed refined
    # against the same dynamically-consistent synthetic observations (the
    # loop does genuine Newton + outlier-rejection iterations; a random-data
    # workload diverges in ~2 iterations and measures nothing)
    best_rms, _kind, _el, eqv, epoch, _corr = out
    # kernel outputs are per-trajectory (device-side segment argmin)
    seed_eq = np.asarray(eqv)
    seed_ep = np.asarray(epoch)
    ok_seed = (
        np.isfinite(np.asarray(best_rms))
        & np.isfinite(seed_eq).all(axis=1)
        & (np.abs(seed_eq[:, 0]) < 1e4)
    )
    seed_eq = np.where(ok_seed[:, None], seed_eq, np.array([2.0, 0, 0, 0, 0, 1.0]))
    seed_ep = np.where(ok_seed, seed_ep, 57000.0)

    mjd, ra, dec, sra, sdec, helio = obs_arrays
    T, N = n_traj, n_obs
    obs = ObsArrays(
        mjd, ra, dec, sra, sdec,
        jnp.broadcast_to(jnp.asarray(helio), (T, N, 3)),
        jnp.ones((T, N), bool),
    )
    # grace=2: tolerate the routine transient RMS overshoot of the first
    # Newton step from a Gauss seed (see DifferentialCorrectionConfig docs);
    # raises real-workload convergence 50% -> 95%
    # capped budgets: warm-started lanes needing >12 f64 Newton iterations
    # are pathological (they stagnate/diverge anyway); measured identical
    # success rates and nRMS vs the default budgets
    cfg = DifferentialCorrectionConfig(
        divergence_grace_iterations=2, precision=precision,
        max_newton_iterations=4, prewarm_max_iterations=16,
    )
    lsq_fn = jax.jit(lambda e, t, o: run_differential_correction(e, t, o, cfg))
    el = jnp.asarray(seed_eq)
    ep = jnp.asarray(seed_ep)
    t0 = time.time()
    res = lsq_fn(el, ep, obs)
    jax.block_until_ready(res)
    log(f"LSQ kernel compile+first run: {time.time() - t0:.1f}s")
    conv = float((np.asarray(res.status) == 1).mean())
    nr = np.asarray(res.normalised_rms)[np.asarray(res.status) == 1]
    log(f"LSQ converged: {conv*100:.1f}% of trajectories "
        f"(nRMS med {np.median(nr):.1e} p95 {np.percentile(nr, 95):.1e})")

    best_lsq = min(
        _timed(lambda: jax.block_until_ready(lsq_fn(el, ep, obs)))
        for _ in range(repeats)
    )
    log(f"LSQ warm: {best_lsq*1e3:.1f} ms for {T} trajectories")

    total = best + best_lsq
    return n_traj / total


_radec_jit = None

_BENCH_EPH = None


def bench_eph():
    """ONE analytic ephemeris shared by every stage.  The ephemeris tables
    trace into the jitted kernels as constants, so a fresh JPLEphem per
    stage forces full retraces."""
    global _BENCH_EPH
    if _BENCH_EPH is None:
        from outfit_tpu.ephem import JPLEphem

        _BENCH_EPH = JPLEphem.analytic(53500.0, 61500.0)
    return _BENCH_EPH


def synthetic_dataset_ragged(n_traj: int, eph, seed: int = 0,
                             n_obs_range=(8, 23)):
    """Realistically RAGGED workload: per-trajectory observation counts
    drawn uniformly from ``n_obs_range`` (a fixed (12 obs, 8 lanes) shape
    may flatter the kernels).  Built by generating
    at the max count and masking rows out."""
    # note: the range keeps the expected TOTAL observation count clear of a
    # power-of-two bucket boundary (mean 15.5 x 8192 = 127k < 131072), so
    # per-dataset size jitter never alternates base-array compile buckets
    lo, hi = n_obs_range
    ds = synthetic_dataset(n_traj, hi, eph, seed=seed)
    rng = np.random.default_rng(seed + 777)
    counts = rng.integers(lo, hi + 1, n_traj)
    # keep the first counts[t] observations of each trajectory
    local = np.arange(n_traj * hi) % hi
    keep = local < counts[np.arange(n_traj * hi) // hi]
    for f in ("mjd_tt", "ra", "dec", "ra_error", "dec_error",
              "traj_index", "observer_index", "mag", "catalog"):
        arr = getattr(ds, f)
        if len(arr) == len(keep):
            setattr(ds, f, arr[keep])
    return ds


_fixture_base = None


def real_cadence_dataset(n_traj: int, seed: int = 0):
    """Real-survey workload: tile the repo's REAL MPC fixtures — 2015AB (37 obs /
    1981-day arc), 8467 (61 obs / 40 d), 33803 (129 obs / 160 d); real
    cadence, real observatory sites, FCCT14 sigmas — to ``n_traj``
    trajectories, re-noising each copy's astrometry at the per-observation
    catalog sigma.  All three base arcs converge through IOD+LSQ
    (tests/test_lsq.py, tests/test_ephemeris_api.py)."""
    global _fixture_base
    from outfit_tpu.observations.dataset import ObsDataset
    from outfit_tpu.observations.error_model import ErrorModel

    if _fixture_base is None:
        here = os.path.dirname(os.path.abspath(__file__))
        bases = []
        for name in ("2015AB", "8467", "33803"):
            ds = ObsDataset.from_mpc_80_col(
                os.path.join(here, "tests", "data", f"{name}.obs")
            )
            ds.apply_error_model(ErrorModel.fcct14())
            bases.append(ds)
        _fixture_base = bases
    bases = _fixture_base

    rng = np.random.default_rng(seed)
    out = ObsDataset()
    counts = np.array([len(b.mjd_tt) for b in bases])
    # interleave fixtures round-robin so every width bucket appears
    picks = np.arange(n_traj) % len(bases)
    total = int(counts[picks].sum())
    fields = {}
    for f in ("mjd_tt", "ra", "dec", "ra_error", "dec_error", "mag"):
        fields[f] = np.concatenate([getattr(bases[p], f) for p in picks])
    cat = np.concatenate([bases[p].catalog for p in picks])
    obs_idx = []
    observers = []
    obs_off = []
    for b in bases:
        obs_off.append(len(observers))
        observers.extend(b.observers)
    for p in picks:
        obs_idx.append(bases[p].observer_index + obs_off[p])
    out.observer_index = np.concatenate(obs_idx)
    out.observers = observers
    out.traj_index = np.repeat(np.arange(n_traj, dtype=np.int64), counts[picks])
    out.traj_ids = [f"R{i:06d}" for i in range(n_traj)]
    out.catalog = cat
    for f, v in fields.items():
        setattr(out, f, v.copy())
    # re-noise each copy at the catalog sigma (fresh measurement realization)
    out.ra = out.ra + rng.normal(0, 1, total) * out.ra_error / np.cos(out.dec)
    out.dec = out.dec + rng.normal(0, 1, total) * out.dec_error
    assert total == len(out.mjd_tt)
    return out


def synthetic_dataset(n_traj: int, n_obs: int, eph, seed: int = 0):
    """Dynamically consistent synthetic ObsDataset: random bound orbits
    observed from the geocenter with the SAME ephemeris the fit uses, so
    solver convergence matches production (examples/run_full_iod_parallel.rs
    workload shape)."""
    import jax.numpy as jnp

    from outfit_tpu.constants import ROT_ECLMJ2000_TO_EQUMJ2000
    from outfit_tpu.elements.twobody import propagate_twobody
    from outfit_tpu.elements.types import (
        EquinoctialElements,
        KeplerianElements,
        keplerian_to_equinoctial,
    )
    from outfit_tpu.iod.scoring import apparent_radec
    from outfit_tpu.observations.dataset import ObsDataset
    from outfit_tpu.observations.observatories import Observer

    rng = np.random.default_rng(seed)
    T = n_traj

    def _radec(kep_arrs, omjd):
        # jitted: one dispatch instead of one per operation
        kep = KeplerianElements(*kep_arrs)
        eq = keplerian_to_equinoctial(kep)
        eqb = EquinoctialElements(*[f[:, None] for f in eq])
        st = propagate_twobody(eqb, 57000.0, omjd, compute_derivatives=False)
        rot = jnp.asarray(ROT_ECLMJ2000_TO_EQUMJ2000)
        pos_equ = jnp.einsum("ij,...j->...i", rot, st.position)
        vel_equ = jnp.einsum("ij,...j->...i", rot, st.velocity)
        helio, _ = eph.earth_ephemeris(omjd)
        return apparent_radec(pos_equ, vel_equ, helio)

    global _radec_jit
    if _radec_jit is None:
        import jax

        _radec_jit = jax.jit(_radec)
    kep_arrs = (
        jnp.asarray(np.full(T, 57000.0)),
        jnp.asarray(rng.uniform(1.2, 3.5, T)),
        jnp.asarray(rng.uniform(0.0, 0.35, T)),
        jnp.asarray(rng.uniform(0.0, 0.6, T)),
        jnp.asarray(rng.uniform(0, 2 * np.pi, T)),
        jnp.asarray(rng.uniform(0, 2 * np.pi, T)),
        jnp.asarray(rng.uniform(0, 2 * np.pi, T)),
    )
    omjd = 57000.0 + np.sort(rng.uniform(0, 40, (T, n_obs)), axis=1)
    ra, dec = _radec_jit(kep_arrs, jnp.asarray(omjd))
    sigma = 2.4e-6  # ~0.5 arcsec
    ra = np.asarray(ra) + rng.normal(0, sigma, (T, n_obs))
    dec = np.asarray(dec) + rng.normal(0, sigma, (T, n_obs))

    ds = ObsDataset()
    ds.mjd_tt = omjd.ravel()
    ds.ra = ra.ravel()
    ds.dec = dec.ravel()
    ds.ra_error = np.full(T * n_obs, sigma)
    ds.dec_error = np.full(T * n_obs, sigma)
    ds.traj_index = np.repeat(np.arange(T, dtype=np.int64), n_obs)
    ds.observer_index = np.zeros(T * n_obs, np.int64)
    ds.traj_ids = [f"S{i:06d}" for i in range(T)]
    ds.observers = [Observer.geocenter()]
    ds.mag = np.full(T * n_obs, np.nan)
    return ds


#: fit_lsq_stream keyword arguments of the service mode: slim fetch +
#: columnar results + deferred IOD elements (elements stay exact f64)
SERVICE_STREAM_KW = dict(slim_fetch=True, as_table=True, minimal_fetch=True)


def profiles():
    """Named ``(IODParams, DifferentialCorrectionConfig)`` profiles of the
    benchmark workloads, shared with chip_smoke.py.

    * ``service``: the 12-obs service stream (mixed precision, two
      triplets x three noise realizations, capped correction budgets).
    * ``rich``: the full-quality real-cadence profile.  On real arcs
      triplet diversity does the convergence work, so it takes 16
      triplets and no noise realizations, drawn from a 48-point
      uniform-with-edges downsample (C(48,3) candidates instead of
      C(100,3)).
    * ``lean``: the real-cadence streaming tier: 4 triplets from a
      32-point downsample, an f-g correction cap of 10, and at most 3
      outlier-rejection passes.  Its rare failures are re-fit with
      ``rich`` by ``fit_lsq_stream_escalating``.
    """
    from outfit_tpu.iod.params import IODParams
    from outfit_tpu.lsq.config import DifferentialCorrectionConfig

    # grace=2 tolerates the transient RMS overshoot of the first Newton
    # step from a Gauss seed (see DifferentialCorrectionConfig)
    cfg = DifferentialCorrectionConfig(
        divergence_grace_iterations=2, precision="mixed",
        max_newton_iterations=4, prewarm_max_iterations=16,
    )
    return {
        "service": (IODParams(
            n_noise_realizations=3, precision="mixed", newton_max_it=20,
            max_triplets=2,
        ), cfg),
        "rich": (IODParams(
            n_noise_realizations=0, precision="mixed", newton_max_it=20,
            max_triplets=16, max_obs_for_triplets=48,
        ), cfg),
        "lean": (IODParams(
            n_noise_realizations=0, precision="mixed", newton_max_it=10,
            max_triplets=4, max_obs_for_triplets=32,
        ), DifferentialCorrectionConfig(
            divergence_grace_iterations=2, precision="mixed",
            max_newton_iterations=4, prewarm_max_iterations=16,
            max_outlier_rejection_passes=3,
        )),
    }


def random_orbits(n: int, seed: int):
    """``n`` random bound main-belt-like orbits at epoch MJD 57000 as a
    numpy ``(n, 6)`` equinoctial array (a, h, k, p, q, mean longitude),
    plus the generator for any further draws."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(1.2, 3.5, n)
    e = rng.uniform(0.0, 0.35, n)
    pom = rng.uniform(0, 2 * np.pi, n)
    om = rng.uniform(0, 2 * np.pi, n)
    tani2 = np.tan(rng.uniform(0.0, 0.3, n))
    lam = rng.uniform(0, 2 * np.pi, n)
    eq = np.stack([a, e * np.sin(pom), e * np.cos(pom),
                   tani2 * np.sin(om), tani2 * np.cos(om), lam], axis=1)
    return eq, rng


def bench_e2e(n_traj: int, repeats: int = 3, builder=None, tag="e2e",
              escalate=False, rich=False, stream=False):
    """Dataset -> results throughput INCLUDING all host prep (observer
    cache, triplet enumeration, lane assembly, result dict construction).

    Steady state: the warm pass re-runs on a freshly built equivalent
    dataset so nothing is amortized except compiled kernels (the
    production operating point for a long-running fitting service).

    ``builder(seed)`` overrides the dataset source (e.g. the RAGGED
    variable-n_obs workload); dataset synthesis itself is excluded from
    the timed region in either case.

    ``rich=True`` swaps in the full-quality config (max_triplets=16).
    ``stream=True`` runs the workload through ``fit_lsq_stream`` with the
    full service stack (slim fetch + columnar results + deferred IOD
    elements) instead of sequential calls.
    ``escalate=True`` runs the tiered recipe: with ``stream=True`` the
    pipelined form (``fit_lsq_stream_escalating``: the lean real-cadence
    profile streams every dataset, and the rare failures are re-fit with
    the rich profile in ONE batched pass across datasets); without
    ``stream`` the sequential ``fit_lsq_escalating``."""
    from outfit_tpu.lsq.api import fit_lsq, fit_lsq_escalating
    from outfit_tpu.observer.cache import ObserverCache

    eph = bench_eph()
    prof = profiles()
    params, cfg = prof["service"]
    rich_params, _ = prof["rich"]
    lean_params, lean_cfg = prof["lean"]

    if rich:
        params = rich_params

    def run(ds):
        # the FUSED production path: IOD seeds hand off to the correction
        # on device; one bulk transfer returns both stages' results
        if escalate:
            lsq = fit_lsq_escalating(
                ds, eph, [(params, cfg), (rich_params, cfg)], seed=7
            )
            return None, lsq
        cache = ObserverCache.build(ds, eph)
        lsq = fit_lsq(ds, eph, params, cfg, seed=7, cache=cache)
        return None, lsq

    if builder is None:
        builder = lambda seed: synthetic_dataset(n_traj, 12, eph, seed=seed)
    t0 = time.time()
    ds = builder(100)
    log(f"{tag} dataset build: {time.time()-t0:.2f}s ({n_traj} traj)")

    if stream:
        from outfit_tpu.lsq import fit_lsq_stream, fit_lsq_stream_escalating

        kw = SERVICE_STREAM_KW
        if escalate:
            # lean tier streams; failures of ALL datasets re-fit in one
            # batched rich pass (flush_every covers the whole stream).
            # depth=3: one more dataset in flight than the default hides
            # the per-dataset host prep behind a deeper device queue
            def streamer(dss, n):
                return fit_lsq_stream_escalating(
                    dss, eph, [(lean_params, lean_cfg), (rich_params, cfg)],
                    seed=7, flush_every=max(n, 1), depth=3, **kw,
                )
        else:
            def streamer(dss, n):
                return fit_lsq_stream(dss, eph, params, cfg, seed=7, **kw)
        t0 = time.time()
        for _ in streamer([ds], 1):
            pass
        # second warm pass: the first timed pass after a single warm still
        # ran ~30% under steady state (lazy executable/transfer warmup)
        for _ in streamer([ds], 1):
            pass
        if escalate:
            # warm the rich-refit shapes at the PINNED composition the
            # escalation wrapper uses (refit_fill=8 rows per obs-width
            # bucket; the real-cadence builder is round-robin over 3
            # families, so the first 24 trajectories are 8 per bucket) —
            # the warm dataset may have zero lean failures, which would
            # otherwise leave the refit kernels to compile INSIDE the
            # timed region on the first real failure
            import numpy as _np

            rows = []
            for k, (_tid, g) in enumerate(ds.trajectory_groups()):
                if k >= 24:
                    break
                rows.append(g)
            if rows:
                # subset keeps the full observer table, matching the
                # refit's (concat dedupes identical observers)
                fit_lsq(
                    ds.subset(_np.concatenate(rows)),
                    eph, rich_params, cfg, seed=7,
                )
        log(f"{tag} stream compile+first run: {time.time()-t0:.1f}s")
        n_ds = max(repeats, 3)
        datasets = [builder(101 + i) for i in range(n_ds)]
        t0 = time.time()
        n_done = n_conv = 0
        for _ds, res in streamer(iter(datasets), n_ds):
            n_done += len(res)
            n_conv += int(np.asarray(res.converged).sum())
        dt = time.time() - t0
        log(
            f"{tag} stream: {n_done} fits over {n_ds} datasets in {dt:.2f}s "
            f"({n_done/dt:.0f} fits/sec/chip pipelined, "
            f"{n_conv/max(n_done,1)*100:.1f}% LSQ-converged)"
        )
        return n_done / dt

    t0 = time.time()
    iod, lsq = run(ds)
    log(f"{tag} compile+first run: {time.time()-t0:.1f}s")

    best = np.inf
    for rep in range(repeats):
        ds = builder(101 + rep)
        t0 = time.time()
        iod, lsq = run(ds)
        best = min(best, time.time() - t0)
    n_ok = sum(r.ok and not r.fell_back_to_iod for r in lsq.values())
    log(
        f"{tag} warm: {best*1e3:.0f} ms for {n_traj} trajectories "
        f"({best/n_traj*1e6:.0f} us/traj, {n_ok/n_traj*100:.1f}% LSQ-converged)"
    )
    return n_traj / best


def bench_propagation_fallback():
    """Fallback metric if the full pipeline fails to compile on the target:
    batched universal-variable two-body propagation steps/sec."""
    import jax
    import jax.numpy as jnp

    from outfit_tpu.kepler import propagate_universal

    n = 65536
    rng = np.random.default_rng(0)
    r0 = rng.uniform(0.5, 4.0, (n, 1)) * _unit(rng, n)
    v = np.sqrt(2.959e-4 / np.linalg.norm(r0, axis=1, keepdims=True))
    v0 = v * rng.uniform(0.5, 1.2, (n, 1)) * _unit(rng, n)
    dts = jnp.asarray(rng.uniform(-200, 200, n))
    f = jax.jit(lambda p, v, d: propagate_universal(p, v, 0.0, d))
    out = f(jnp.asarray(r0), jnp.asarray(v0), dts)
    jax.block_until_ready(out)
    best = min(
        _timed(lambda: jax.block_until_ready(f(jnp.asarray(r0), jnp.asarray(v0), dts)))
        for _ in range(3)
    )
    return n / best


def bench_dop853_nbody(n_lanes: int = 4096, repeats: int = 3):
    """Batched DOP853 N-body propagation steps/sec/chip — the second
    BASELINE.md metric ("batched DOP853 propagation steps/sec").

    Workload: ``n_lanes`` random bound orbits propagated 30 days under the
    full planet perturber list with the 42-state STM on (the
    differential-correction N-body configuration, propagator/nbody.py).
    A "step" is one ACCEPTED adaptive RK8(5,3) step of the 42-state
    system (12 rhs evaluations + error control); the count is the lane
    sum of ``NBodyResult.n_steps``.  The integrator is owned batched code
    (propagator/dop853.py) vs the reference's delegated crate
    (reference ``src/propagator/nbody.rs:505-523``)."""
    import jax
    import jax.numpy as jnp

    from outfit_tpu.elements.types import EquinoctialElements
    from outfit_tpu.propagator import NBodyConfig, propagate_nbody

    eph = bench_eph()
    cfg = NBodyConfig.with_planets()
    B = n_lanes
    el, rng = random_orbits(B, seed=3)
    eq = EquinoctialElements(
        jnp.full(B, 57000.0), *(jnp.asarray(el[:, j]) for j in range(6))
    )
    t1 = jnp.asarray(57000.0 + rng.uniform(25.0, 30.0, B))

    fn = jax.jit(lambda q, t: propagate_nbody(q, t, eph, cfg))
    t0 = time.time()
    out = fn(eq, t1)
    jax.block_until_ready(out)
    log(f"dop853-nbody compile+first run: {time.time()-t0:.1f}s")
    ok = float((np.asarray(out.status) == 0).mean())
    steps = int(np.asarray(out.n_steps).sum())
    best = min(
        _timed(lambda: jax.block_until_ready(fn(eq, t1)))
        for _ in range(repeats)
    )
    log(
        f"dop853-nbody warm: {best*1e3:.0f} ms for {B} lanes x 30 d "
        f"(42-state STM, full planets; {steps} accepted steps, "
        f"{ok*100:.1f}% ok)"
    )
    return steps / best


def bench_ephemeris_gen(n_orbits: int = 4096, n_epochs: int = 64,
                        repeats: int = 3):
    """Batched apparent-ephemeris generation entries/sec/chip — the
    BASELINE.json config class "Ephemeris generation ... phase angle /
    elongation / aberration" (reference tests/test_ephemeris.rs), which
    previously had no bench line.

    Workload: ``n_orbits`` random bound orbits x ``n_epochs`` daily
    epochs from a geocentric observer, SECOND-order aberration (two
    Keplerian retro-propagation passes, aberration.rs:197 parity) and
    the Combined output (apparent RA/Dec/distances + phase angle,
    elongation, radial velocity, sky motion).  The device core is
    ``compute_apparent`` (ephemeris/compute.py) — the same kernel the
    public ``EphemerisRequest`` path dispatches per entry batch."""
    import jax
    import jax.numpy as jnp

    from outfit_tpu.elements.types import EquinoctialElements
    from outfit_tpu.ephemeris.compute import compute_apparent
    from outfit_tpu.ephemeris.config import AberrationOrder

    eph = bench_eph()
    B, E = n_orbits, n_epochs
    el, rng = random_orbits(B, seed=5)
    eq = EquinoctialElements(
        jnp.full((B, 1), 57000.0),
        *(jnp.asarray(el[:, j])[:, None] for j in range(6)),
    )
    epochs = jnp.asarray(
        57000.0 + np.arange(E)[None, :] + rng.uniform(0, 1, (B, E))
    )

    def gen(eq, t):
        obs_pos, obs_vel = eph.earth_ephemeris(t)
        return compute_apparent(
            eq, t, obs_pos, obs_vel, aberration=AberrationOrder.SECOND,
        )

    fn = jax.jit(gen)
    t0 = time.time()
    out = fn(eq, epochs)
    jax.block_until_ready(out)
    log(f"ephemeris-gen compile+first run: {time.time()-t0:.1f}s")
    ok = float(np.asarray(out.ok).mean())
    best = min(
        _timed(lambda: jax.block_until_ready(fn(eq, epochs)))
        for _ in range(repeats)
    )
    log(
        f"ephemeris-gen warm: {best*1e3:.1f} ms for {B} orbits x {E} "
        f"epochs (2nd-order aberration + full geometry; {ok*100:.2f}% ok)"
    )
    return B * E / best


def _unit(rng, n):
    x = rng.normal(size=(n, 3))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _timed(f):
    t0 = time.time()
    f()
    return time.time() - t0


def bench_e2e_stream(n_traj: int = 8192, n_datasets: int = 12,
                     modes=("minimal", "default"), on_result=None):
    """12 x 8192 = ~1e5 trajectories end to end.  8192 trajectories per
    dataset is the operating batch size (ROADMAP A5 re-measures it).

    ``modes``: "minimal" = the service stack (slim fetch + columnar
    LsqTable + deferred IOD elements: orbital elements stay exact f64, the
    covariance triangle rides f32) and "default" = the bit-parity
    reference fetch.  Each extra mode costs a compile plus a full stream
    pass.  ``on_result(mode, fps)`` fires as each mode finishes, so a
    timeout mid-stage still leaves the completed modes' numbers with the
    reporter.  Returns {mode: fits/sec}."""
    return _bench_e2e_stream(n_traj, n_datasets, modes, on_result)


#: fit_lsq_stream kwargs per stream-bench mode name
_STREAM_MODES = {
    "default": {},
    "slim": {"slim_fetch": True},
    "table": {"slim_fetch": True, "as_table": True},
    "minimal": SERVICE_STREAM_KW,
}


def _bench_e2e_stream(n_traj: int, n_datasets: int,
                      modes=("minimal", "default"), on_result=None):
    """Pipelined service throughput: a stream of datasets through
    fit_lsq_stream (host prep of dataset N+1 overlaps device execution of
    dataset N).  The steady-state operating mode of a fitting service."""
    from outfit_tpu.lsq import fit_lsq_stream

    eph = bench_eph()
    params, cfg = profiles()["service"]
    # warm (compile) outside the timed region — only the requested specs
    ds0 = synthetic_dataset(n_traj, 12, eph, seed=99)
    for m in modes:
        next(fit_lsq_stream([ds0], eph, params, cfg, seed=7, **_STREAM_MODES[m]))

    datasets = [
        synthetic_dataset(n_traj, 12, eph, seed=400 + i)
        for i in range(n_datasets)
    ]

    _LABELS = {
        "default": "bit-parity fetch",
        "slim": "slim fetch",
        "table": "slim fetch + columnar results",
        "minimal": "slim fetch + columnar results + deferred IOD elements",
    }

    def run(mode):
        t0 = time.time()
        n_done = 0
        for ds, res in fit_lsq_stream(
            iter(datasets), eph, params, cfg, seed=7, **_STREAM_MODES[mode]
        ):
            n_done += len(res)
        dt = time.time() - t0
        fps = n_done / dt
        log(
            f"stream ({_LABELS[mode]}): {n_done} fits over {n_datasets} "
            f"datasets in {dt:.2f}s ({fps:.0f} fits/sec/chip pipelined)"
        )
        if on_result is not None:
            on_result(mode, fps)
        return fps

    return {m: run(m) for m in modes}


def accuracy_certificate(n_traj: int = 1024):
    """Mixed-vs-f64 element agreement on the bench workload (the
    throughput headline ships with its parity stats).

    Runs the SAME synthetic batch through the IOD+LSQ kernels in the
    bench's mixed-precision production config and in pure f64, and logs
    median/max relative element disagreement over the rows converged in
    both.  The BASELINE contract is 1e-9 elements; mixed mode's f64 polish
    restores f64-grade IOD elements (tests/test_iod.py::TestMixedPrecision),
    but its LSQ loop runs on f32 Jacobians and ends within ~1e-2 of a
    formal sigma of the f64 optimum (docs/DESIGN.md 'Numerics')."""
    import jax
    import jax.numpy as jnp

    from outfit_tpu.iod.api import _iod_kernel
    from outfit_tpu.iod.params import IODParams
    from outfit_tpu.lsq.config import DifferentialCorrectionConfig
    from outfit_tpu.lsq.iteration import ObsArrays
    from outfit_tpu.lsq.loop import run_differential_correction
    from __graft_entry__ import _synthetic_batch

    n_obs = 12
    args = _synthetic_batch(
        n_traj=n_traj, lanes_per_traj=8, n_obs=n_obs, seed=7
    )
    mjd, ra, dec, sra, sdec, helio = args[1]
    obs = ObsArrays(
        mjd, ra, dec, sra, sdec,
        jnp.broadcast_to(jnp.asarray(helio), (n_traj, n_obs, 3)),
        jnp.ones((n_traj, n_obs), bool),
    )

    lsq_jits = {}  # cfg -> jitted runner: a fresh jit(lambda) per call
    # would defeat jit's function-identity cache and retrace/recompile
    # the identical kernel

    def run_lsq(seed_eq, seed_ep, precision, **cfg_kw):
        cfg_kw.setdefault("divergence_grace_iterations", 2)
        cfg = DifferentialCorrectionConfig(precision=precision, **cfg_kw)
        fn = lsq_jits.get(cfg)
        if fn is None:
            fn = lsq_jits[cfg] = jax.jit(
                lambda e, t, o, _c=cfg: run_differential_correction(
                    e, t, o, _c)
            )
        res = fn(jnp.asarray(seed_eq), jnp.asarray(seed_ep), obs)
        jax.block_until_ready(res)
        return res

    def pipeline(precision):
        params = IODParams(
            n_noise_realizations=3, precision=precision, newton_max_it=20
        )
        out = jax.jit(
            lambda t, o, lt, w: _iod_kernel(t, o, lt, w, params)
        )(*args)
        _rms, _k, _e, eqv, epoch, _c = out
        seed_eq = np.asarray(eqv)
        seed_ep = np.asarray(epoch)
        ok = np.isfinite(np.asarray(_rms)) & np.isfinite(seed_eq).all(axis=1)
        seed_eq = np.where(ok[:, None], seed_eq, np.array([2.0, 0, 0, 0, 0, 1.0]))
        seed_ep = np.where(ok, seed_ep, 57000.0)
        res = run_lsq(seed_eq, seed_ep, precision)
        sig = np.sqrt(np.maximum(np.asarray(
            jnp.diagonal(res.covariance, axis1=-2, axis2=-1)
        ), 0.0))
        return (
            np.asarray(res.status), np.asarray(res.elements), ok,
            np.asarray(eqv), np.asarray(res.normalised_rms), sig,
            seed_eq, seed_ep,
        )

    st_m, el_m, ok_m, eqv_m, nr_m, sig_m, sd_eq_m, sd_ep_m = pipeline("mixed")
    st_f, el_f, ok_f, eqv_f, nr_f, sig_f, sd_eq_f, sd_ep_f = pipeline("f64")
    both = (st_m == 1) & (st_f == 1)
    if not both.any():
        log("ACCURACY: no rows converged in both precisions (!)")
        return
    # separate PRECISION spread from SEED SENSITIVITY: on noisy synthetic
    # arcs some fits are multi-modal or have flat chi2 valleys, and the two
    # precisions' different IOD seeds can settle at different (equally
    # chi2-valid) points — that is seed sensitivity, not numerical error.
    # Same-basin = the two fits describe the same optimum (normalised RMS
    # agrees to 1e-6); within it, the STATISTICALLY meaningful scale for an
    # element difference is the fit's own formal 1-sigma.
    nr_m_s = np.where(both, nr_m, 0.0)  # mask BEFORE subtracting: inf-inf
    nr_f_s = np.where(both, nr_f, 0.0)  # on unconverged rows warns as nan
    # same-optimum classification is by PARAMETER-SPACE distance: two fits
    # describe the same chi2 point when every element agrees within half
    # its own formal 1-sigma.  (Rounds 1-3 classified by nRMS agreement at
    # 1e-6, which misclassified same-optimum rows whose Newton loops
    # stopped at different residual FLOORS — measured dnRMS ~3e-6 on
    # identical-element rows — as "flips".)
    all_sig = np.abs(el_m - el_f) / np.maximum(sig_f, 1e-300)
    all_sig = np.where(both[:, None], all_sig, np.inf)
    same_basin = both & (all_sig.max(axis=1) < 0.5)
    rel = np.abs(el_m[same_basin] - el_f[same_basin]) / (
        1.0 + np.abs(el_f[same_basin])
    )
    in_sigma = all_sig[same_basin]
    seed_both = ok_m & ok_f
    rel_seed = np.abs(eqv_m[seed_both] - eqv_f[seed_both]) / (
        1.0 + np.abs(eqv_f[seed_both])
    )
    row_sig = in_sigma.max(axis=1)  # worst element per row, in sigmas
    log(
        f"ACCURACY CERTIFICATE (mixed vs f64, {n_traj} trajectories): "
        f"LSQ elements rel diff median {np.median(rel):.2e}; in units of "
        f"the fit's own formal 1-sigma: median {np.median(in_sigma):.2e}, "
        f"{(row_sig < 0.1).mean()*100:.1f}% of rows within 0.1 sigma on "
        f"every element ({int(same_basin.sum())} same-optimum rows; the "
        f"tail rows sit in flat chi2 valleys where equal-quality fits are "
        f"not unique); {int(both.sum())} rows converged in both precisions "
        f"({both.mean()*100:.1f}%), of which "
        f"{int((both & ~same_basin).sum())} settled at a different point "
        f"of the chi2 surface (seed sensitivity on noisy arcs, not "
        f"precision error); IOD seeds median {np.median(rel_seed):.2e} "
        f"(seed grade; the correction contracts them to the LSQ figure)"
    )
    # quantify the FLIP rows: are the different
    # optima mixed mode settles in statistically as good as the f64 ones?
    # dnRMS = nRMS(mixed) - nRMS(f64) per flip row: <= 0 means mixed found
    # an equal-or-BETTER chi2 point; the certificate prints the
    # distribution and the fraction meaningfully worse (> 0.1 in nRMS,
    # i.e. a visible quality loss on the sqrt-reduced-chi2 scale)
    flip = both & ~same_basin
    if flip.any():
        dn = nr_m_s[flip] - nr_f_s[flip]
        worse = float((dn > 0.1).mean())
        log(
            f"FLIP-ROW QUALITY ({int(flip.sum())} rows at genuinely "
            f"different chi2 points): dnRMS(mixed-f64) "
            f"median {np.median(dn):+.2e}, p5 {np.percentile(dn, 5):+.2e}, "
            f"p95 {np.percentile(dn, 95):+.2e}, max {dn.max():+.2e}; "
            f"{(dn <= 0).mean()*100:.1f}% of flips land on an "
            f"equal-or-better chi2 point, {worse*100:.2f}% are worse by "
            f"> 0.1 nRMS; the zero-noise regression (tests/test_lsq.py) "
            f"pins flip count == 0 when the chi2 surface is not "
            f"seed-degenerate"
        )

    # --- four-class row accounting + one-precision-only recovery ----------
    # (some rows converge in only ONE precision; a mixed-precision user
    # needs the direction split and whether the escalating tier recovers
    # them.)  The recovery probes are the
    # kernel-level expressible parts of the escalating tier: (a) the rich
    # CORRECTION budget (deeper Newton/prewarm + extra grace), and (b) the
    # OTHER precision's IOD seed (is the failure seed-driven or
    # arithmetic-driven?).
    mixed_only = (st_m == 1) & (st_f != 1)  # the f64 side failed
    f64_only = (st_f == 1) & (st_m != 1)  # the mixed side failed
    neither = (st_m != 1) & (st_f != 1)

    def _recover(side_mask, precision, seed_eq, seed_ep, x_eq, x_ep):
        """(n_rich, n_xseed, n_either) rows of ``side_mask`` recovered by
        the rich correction budget / the cross-precision seed."""
        if not side_mask.any():
            return 0, 0, 0
        rich = run_lsq(
            seed_eq, seed_ep, precision,
            divergence_grace_iterations=3,
            max_newton_iterations=8, prewarm_max_iterations=32,
        )
        xseed = run_lsq(x_eq, x_ep, precision)
        ok_r = (np.asarray(rich.status) == 1) & side_mask
        ok_x = (np.asarray(xseed.status) == 1) & side_mask
        return int(ok_r.sum()), int(ok_x.sum()), int((ok_r | ok_x).sum())

    # mixed-only rows: retry the FAILING f64 side; f64-only rows: retry
    # the failing mixed side
    rf, xf, ef = _recover(mixed_only, "f64", sd_eq_f, sd_ep_f,
                          sd_eq_m, sd_ep_m)
    rm, xm, em = _recover(f64_only, "mixed", sd_eq_m, sd_ep_m,
                          sd_eq_f, sd_ep_f)
    log(
        f"PRECISION ROW CLASSES ({n_traj} rows): "
        f"{int(same_basin.sum())} both/same-optimum, "
        f"{int(flip.sum())} both/flip, "
        f"{int(mixed_only.sum())} mixed-only (f64 side failed: rich "
        f"correction budget recovers {rf}, mixed's seed recovers {xf}, "
        f"either {ef}), "
        f"{int(f64_only.sum())} f64-only (mixed side failed: rich budget "
        f"recovers {rm}, f64's seed recovers {xm}, either {em}), "
        f"{int(neither.sum())} neither (underdetermined noisy arcs); "
        f"unrecovered one-precision rows are candidates for the "
        f"escalating tier's rich-IOD refit (fit_lsq_stream_escalating)"
    )


#: metric-label fragments per stream mode (the label must say which mode
#: produced the recorded number; slim keeps elements exact f64)
_MODE_LABELS = {
    "minimal": (
        "pipelined service mode, slim fetch + columnar results + deferred "
        "IOD elements: f32 covariance reporting, elements exact f64"
    ),
    "table": (
        "pipelined service mode, slim fetch + columnar results: "
        "f32 covariance reporting, elements exact f64"
    ),
    "slim": (
        "pipelined service mode, slim fetch: f32 covariance reporting, "
        "elements exact f64"
    ),
    "default": "pipelined service mode",
}


# --------------------------------------------------------------------------
# Supervisor / child architecture: a hung stage costs one stage, not the run
# --------------------------------------------------------------------------

#: trajectories per dataset of the 12-obs stages
N_TRAJ = 8192


def _fits_line(value, desc):
    return {
        "metric": "full IOD+LSQ fits/sec/chip, " + desc,
        "value": round(value, 2),
        "unit": "fits/sec/chip",
    }


class _Emitter:
    """Child-side result channel: JSON lines appended (line-buffered) to
    the result file, so a SIGKILLed child still leaves every completed
    sub-result for the parent to collect."""

    def __init__(self, path):
        self._f = open(path, "a", buffering=1)

    def ranked(self, tier, result):
        self._write({"kind": "ranked", "tier": tier, "result": result})

    def extra(self, result):
        self._write({"kind": "extra", "result": result})

    def _write(self, obj):
        line = json.dumps(obj)
        self._f.write(line + "\n")
        log("RESULT " + line)


def _stage_prop(emit):
    prop = bench_propagation_fallback()
    emit.ranked(0, {
        "metric": "batched two-body propagation steps/sec/chip "
                  "(provisional fallback)",
        "value": round(prop, 2),
        "unit": "steps/sec/chip",
    })


def _stage_kernels(emit):
    # 8192 trajectories (~65k IOD lanes) per dispatch
    kern = bench_iod_lsq(N_TRAJ)
    log(f"KERNELS ONLY (warm device dispatch): {kern:.0f} fits/sec/chip")
    emit.ranked(1, _fits_line(
        kern, "warm device dispatch only (provisional - host prep "
        "excluded; later stages include it)",
    ))


def _stage_stream(emit):
    # known-best mode first so its number lands even if the stage dies
    # mid-run; the bit-parity reference mode follows for the record
    bench_e2e_stream(
        n_traj=N_TRAJ, n_datasets=12, modes=("minimal", "default"),
        # emit each mode the moment it finishes: a kill between modes
        # must not lose the completed stream number
        on_result=lambda mode, fps: emit.ranked(2, _fits_line(
            fps, "dataset->results incl. all host prep ("
            + _MODE_LABELS[mode] + ")",
        )),
    )


def _stage_e2e_seq(emit):
    e2e = bench_e2e(N_TRAJ)
    log(f"END-TO-END sequential (dataset->results incl. ALL host prep): "
        f"{e2e:.0f} fits/sec/chip")
    # an e2e number REPLACES the kernels-only provisional even when
    # smaller (tier 2 > tier 1): the honest headline includes host costs
    emit.ranked(2, _fits_line(
        e2e, "dataset->results incl. all host prep (sequential mode)",
    ))


def _stage_ragged(emit):
    eph = bench_eph()
    rag = bench_e2e(
        n_traj=N_TRAJ,
        builder=lambda seed: synthetic_dataset_ragged(N_TRAJ, eph, seed=seed),
        tag="e2e-ragged", stream=True,
    )
    log(f"END-TO-END RAGGED pipelined (n_obs ~ U[8,23]): {rag:.0f} "
        f"fits/sec/chip")
    # its own driver-visible JSON line: a different workload must not
    # compete with the fixed-shape headline in the Reporter ranking
    emit.extra(_fits_line(
        rag, "RAGGED workload (n_obs ~ U[8,23]; dataset->results incl. "
        "all host prep, pipelined)",
    ))


def _stage_real(emit):
    nt = 4096
    real = bench_e2e(
        n_traj=nt, repeats=6,
        builder=lambda seed: real_cadence_dataset(nt, seed=seed),
        tag="e2e-real-cadence", stream=True, escalate=True,
    )
    log(f"END-TO-END REAL-CADENCE pipelined escalating (real MPC arcs "
        f"tiled, mean 75.7 obs/traj; lean stream + batched rich refit of "
        f"failures): {real:.0f} fits/sec/chip")
    emit.extra(_fits_line(
        real, "REAL-CADENCE workload (real MPC arcs tiled, mean 75.7 "
        "obs/traj; escalating lean stream + batched rich refit)",
    ))


def _stage_f64(emit):
    # the mode that carries the reference's 1e-10 oracles
    f64k = bench_iod_lsq(N_TRAJ, precision="f64")
    log(f"KERNELS ONLY, PURE-F64 PARITY MODE: {f64k:.0f} fits/sec/chip")
    emit.extra(_fits_line(
        f64k, "warm device dispatch only, PURE-F64 reference-parity mode "
        "(informational; the headline uses the opt-in mixed mode)",
    ))


def _stage_dop(emit):
    dop = bench_dop853_nbody(4096)
    log(f"DOP853 N-BODY (42-state STM, full planets): {dop:.0f} "
        "accepted steps/sec/chip")
    emit.extra({
        "metric": "batched DOP853 N-body propagation accepted "
                  "steps/sec/chip (42-state STM, full planet "
                  "perturbers; secondary BASELINE.md metric)",
        "value": round(dop, 2),
        "unit": "steps/sec/chip",
    })


def _stage_ephemeris(emit):
    ephg = bench_ephemeris_gen(4096, 64)
    log(f"EPHEMERIS GENERATION: {ephg:.0f} entries/sec/chip "
        "(position + geometry, 2nd-order aberration)")
    emit.extra({
        "metric": "apparent ephemeris entries/sec/chip (batched "
                  "position + geometry, 2nd-order aberration; "
                  "BASELINE.json ephemeris-generation config class)",
        "value": round(ephg, 2),
        "unit": "entries/sec/chip",
    })


def _stage_accuracy(emit):
    accuracy_certificate(1024)


def _stage_noop(emit):
    """Test-only stage: emits a constant metric without touching jax, so
    supervisor-mechanism tests (kill-and-continue, final-line contract)
    run in seconds."""
    emit.ranked(0, {
        "metric": "noop (supervisor test stage)",
        "value": 1.0, "unit": "none",
    })


def _stage_wedge(emit):
    """Test-only stage: hangs forever, silently, so
    tests/test_bench_supervisor.py can prove the supervisor kills it and
    carries on."""
    log("wedge stage: sleeping forever (supervisor kill test)")
    time.sleep(10 ** 9)


def _stage_slow(emit):
    """Test-only stage: progresses forever (chatty, never silent) so the
    CAP kill path — distinct from the stall/wedge path — is testable:
    the supervisor must classify the kill as "slow but progressing" and
    grant one retry from the cap pool without burning a wedge slot."""
    log("slow stage: progressing forever (cap kill test)")
    while True:
        time.sleep(0.5)
        log("slow stage: still working")


#: (name, historical cost s, hard cap s, done-bar/retryable, runner);
#: order is the execution order — the done-bar stages (headline stream,
#: escalating real-cadence, DOP853) run before the informational ones so
#: a shrinking budget sheds the right stages first, and the supervisor
#: additionally reserves the later done-bar stages' costs when capping
#: the earlier ones
_STAGE_DEFS = [
    # costs are budgeting estimates with margin, to be re-measured on the
    # card.  Kill semantics: the STALL detector (no output for stall_s;
    # compiles emit heartbeats) catches a hung dispatch and earns a
    # fresh-process retry; the CAP bounds a slow-but-progressing stage
    # (cold compiles) and earns at most one warm-cache retry from a
    # separate pool
    ("prop-fallback", 60, 240, False, _stage_prop),
    ("kernels-only", 120, 420, False, _stage_kernels),
    ("stream", 150, 600, True, _stage_stream),
    ("e2e-real-cadence", 160, 700, True, _stage_real),
    ("dop853-nbody", 60, 300, True, _stage_dop),
    ("ephemeris-gen", 60, 240, False, _stage_ephemeris),
    ("e2e-sequential", 200, 420, False, _stage_e2e_seq),
    ("e2e-ragged", 90, 360, False, _stage_ragged),
    ("kernels-f64-parity", 120, 420, False, _stage_f64),
    ("accuracy-certificate", 180, 480, False, _stage_accuracy),
    ("wedge", 5, 60, False, _stage_wedge),  # test-only, never in default order
    ("noop", 2, 30, False, _stage_noop),  # test-only, never in default order
    # test-only: chatty never-finishing stage; retryable=True so the
    # cap-retry pool is exercised (cap 10 s keeps the test fast)
    ("slow", 3, 10, True, _stage_slow),
]

#: stages excluded from the default execution order (test fixtures)
_TEST_ONLY_STAGES = ("wedge", "noop", "slow")


#: main-thread frame names that mean "an XLA compile is in flight" —
#: compile-specific entry points of jax's dispatch path (execution blocks
#: under different frames: pjit call / executable execute)
_COMPILE_FRAME_NAMES = frozenset((
    "backend_compile",
    "compile_or_get_cached",
    "_cached_compilation",
    "backend_compile_and_load",
    "compile_unloaded",
    "from_hlo",
))


def _install_compile_heartbeat(stage_name, interval_s=60.0):
    """Daemon thread that logs a heartbeat ONLY while the main thread is
    blocked inside an XLA compile (stack inspection): cold compiles are
    silent for minutes and must not trip the supervisor's stall
    detector, while a hung device dispatch blocks under execute frames,
    gets no heartbeat, and is still killed at the stall timeout."""
    import sys as _sys

    main_id = threading.main_thread().ident

    def _beat():
        while True:
            time.sleep(interval_s)
            f = _sys._current_frames().get(main_id)
            names = []
            while f is not None and len(names) < 60:
                names.append(f.f_code.co_name)
                f = f.f_back
            hit = next((n for n in names if n in _COMPILE_FRAME_NAMES), None)
            if hit is not None:
                log(f"stage {stage_name}: XLA compile in flight "
                    f"({hit}; heartbeat)")

    threading.Thread(target=_beat, daemon=True,
                     name="compile-heartbeat").start()


def child_main(stage_name, result_path):
    """Entry for ``python bench.py --stage NAME --result-file PATH``."""
    defs = {d[0]: d for d in _STAGE_DEFS}
    if stage_name not in defs:
        log(f"unknown stage {stage_name!r}")
        return 2
    emit = _Emitter(result_path)
    if os.environ.get("OUTFIT_BENCH_FORCE_WEDGE") == stage_name:
        log(f"FORCE_WEDGE: stage {stage_name} sleeping forever (test mode)")
        time.sleep(10 ** 9)
    runner = defs[stage_name][4]
    t0 = time.time()
    try:
        if stage_name not in _TEST_ONLY_STAGES:
            import jax

            dev = jax.devices()[0]
            if dev.platform != "gpu":
                raise RuntimeError(
                    f"stage {stage_name} needs a GPU; JAX found "
                    f"{dev.platform} ({dev.device_kind})")
            log(f"stage {stage_name}: {dev.platform} {dev.device_kind} "
                f"x {len(jax.devices())}")
            from outfit_tpu.utils.compile_cache import enable_compile_cache

            enable_compile_cache()
            _install_compile_tracker()
            _install_compile_heartbeat(stage_name)
        runner(emit)
    except Exception as e:
        log(f"stage {stage_name} FAILED after {time.time()-t0:.1f}s "
            f"({type(e).__name__}: {e}; {_COMPILES[0]} XLA compiles, "
            f"{_COMPILES[1]:.1f}s)")
        return 1
    log(f"stage {stage_name}: {time.time()-t0:.1f}s "
        f"({_COMPILES[0]} XLA compiles, {_COMPILES[1]:.1f}s)")
    return 0


def _drain_results(rpath, offset, last_activity=None):
    """Feed complete result-file lines past ``offset`` into the parent
    Reporter; returns the new consumed byte offset.  Partial trailing
    lines (a child killed mid-write) are left for the next drain."""
    try:
        with open(rpath, "r") as f:
            f.seek(offset)
            chunk = f.read()
    except OSError:
        return offset
    end = chunk.rfind("\n")
    if end < 0:
        return offset
    for line in chunk[: end + 1].splitlines():
        line = line.strip()
        if not line:
            continue
        if last_activity is not None:
            last_activity[0] = time.time()
        try:
            obj = json.loads(line)
            result = obj["result"]
        except (ValueError, KeyError, TypeError):
            log(f"unparseable result line: {line[:200]}")
            continue
        if obj.get("kind") == "ranked":
            REPORTER.report(result, tier=int(obj.get("tier", 0)))
        else:
            key = json.dumps(result, sort_keys=True)
            if key not in _EXTRAS_PRINTED:
                _EXTRAS_PRINTED[key] = result
                print(json.dumps(result), flush=True)
    return offset + end + 1


def _run_stage_child(name, cap_s, stall_s, child_env):
    """Run one stage in its own process group, tailing its result file and
    merged output.  Returns the kill kind: ``"stall"`` (no output for
    ``stall_s`` — the true wedge signature), ``"cap"`` (exceeded its wall
    cap while still producing output — slow, e.g. cold compiles, but
    progressing), or ``None`` (ran to completion)."""
    import subprocess
    import tempfile

    fd, rpath = tempfile.mkstemp(prefix=f"outfit_bench_{name}_",
                                 suffix=".jsonl")
    os.close(fd)
    last_activity = [time.time()]
    p = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--stage", name,
         "--result-file", rpath],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=child_env, start_new_session=True, text=True,
    )
    _CHILD_PID[0] = p.pid

    def _pump():
        # any stray child stdout rides the parent's stderr: the parent owns
        # the metric-line stdout protocol
        for line in p.stdout:
            last_activity[0] = time.time()
            sys.stderr.write(line)
            sys.stderr.flush()

    pump = threading.Thread(target=_pump, daemon=True,
                            name=f"pump-{name}")
    pump.start()

    consumed = 0
    t0 = time.time()
    killed = kind = None
    while True:
        consumed = _drain_results(rpath, consumed, last_activity)
        if p.poll() is not None:
            break
        now = time.time()
        if now - t0 > cap_s:
            killed, kind = f"exceeded its {cap_s:.0f}s cap", "cap"
        elif now - last_activity[0] > stall_s:
            killed = (f"produced no output for {stall_s:.0f}s "
                      "(wedge signature: indefinite silence)")
            kind = "stall"
        if killed:
            log(f"stage {name}: KILLED after {now-t0:.1f}s - {killed}; "
                "continuing with the next stage on a fresh client")
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except OSError:
                pass
            p.wait()
            break
        time.sleep(1.0)
    _CHILD_PID[0] = None
    pump.join(timeout=5.0)
    consumed = _drain_results(rpath, consumed)
    if killed is None:
        rc = p.returncode
        if rc != 0:
            log(f"stage {name}: child exited rc={rc} "
                f"({time.time()-t0:.1f}s wall)")
        else:
            log(f"stage {name}: done ({time.time()-t0:.1f}s wall)")
    try:
        os.unlink(rpath)
    except OSError:
        pass
    return kind


def supervisor_main():
    _install_flush_guards()

    child_env = dict(os.environ)

    names = os.environ.get("OUTFIT_BENCH_STAGES")
    if names:
        order = [n.strip() for n in names.split(",") if n.strip()]
    else:
        order = [d[0] for d in _STAGE_DEFS
                 if d[0] not in _TEST_ONLY_STAGES]
        if os.environ.get("OUTFIT_BENCH_SKIP_RAGGED"):
            order = [n for n in order
                     if n not in ("e2e-ragged", "e2e-real-cadence")]
    defs = {d[0]: d for d in _STAGE_DEFS}
    stall_s = float(os.environ.get("OUTFIT_BENCH_STALL_S", "240"))
    reserve_s = 20.0
    retries_left = 2  # total wedge-retry budget across the whole run
    retried = set()
    cap_retried = set()  # separate pool: cap retries must not burn wedge slots

    def _downstream_done_bar_cost(q):
        """Budget the later done-bar (retryable) stages still in the queue
        need: the loose caps on the early compile-heavy stages must never
        let a slow stream/real-cadence run shed the DOP853 line."""
        return sum(
            defs[n][1] * 1.2 for n in q if n in defs and defs[n][3]
        )

    queue = list(order)
    while queue:
        name = queue.pop(0)
        d = defs.get(name)
        if d is None:
            log(f"SKIP unknown stage {name!r}")
            continue
        _n, cost_s, cap_s, retryable, _fn = d
        if _remaining() < cost_s * 1.2 + reserve_s:
            log(
                f"SKIP stage {name}: needs ~{cost_s:.0f}s, "
                f"{_remaining():.0f}s left of the {_BUDGET_S:.0f}s budget"
            )
            continue
        # a stage may use the full budget MINUS what the remaining
        # done-bar stages need, but always gets at least its own
        # estimated cost's window
        cap = min(cap_s, max(
            _remaining() - reserve_s - _downstream_done_bar_cost(queue),
            cost_s * 1.2,
        ))
        cap = min(cap, _remaining() - reserve_s)
        if cap < cap_s:
            log(f"stage {name}: cap clamped {cap_s:.0f}->{cap:.0f}s "
                f"({_remaining():.0f}s budget left, "
                f"{_downstream_done_bar_cost(queue):.0f}s reserved for "
                "remaining done-bar stages)")
        kind = _run_stage_child(name, cap, stall_s, child_env)
        if kind == "stall":
            # hung dispatch: retry once in a fresh process, budgeted
            # run-wide
            if (retryable and retries_left > 0 and name not in retried
                    and _remaining() > cost_s * 2 + reserve_s
                    + _downstream_done_bar_cost(queue)):
                log(f"stage {name}: wedge-retrying once on a fresh client "
                    f"({retries_left - 1} retries left after this)")
                retries_left -= 1
                retried.add(name)
                queue.insert(0, name)
        elif kind == "cap":
            # slow but progressing (cold compiles): the persistent
            # compile cache keeps the killed attempt's artifacts, so a
            # retry resumes from warm kernels instead of starting over
            # — and must not consume the wedge-retry pool
            if (retryable and name not in cap_retried
                    and _remaining() > cost_s * 2 + reserve_s
                    + _downstream_done_bar_cost(queue)):
                log(f"stage {name}: cap overrun was still progressing; "
                    "retrying once on the now-warm compile cache")
                cap_retried.add(name)
                queue.insert(0, name)

    had = _flush_tail("final: re-printing the headline metric line")
    return 0 if had else 3


def main():
    """Back-compat entry: the supervisor."""
    sys.exit(supervisor_main())


if __name__ == "__main__":
    if "--stage" in sys.argv:
        i = sys.argv.index("--stage")
        j = sys.argv.index("--result-file")
        sys.exit(child_main(sys.argv[i + 1], sys.argv[j + 1]))
    sys.exit(supervisor_main())
