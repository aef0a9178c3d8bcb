"""On-card smoke test: drive the main paths once, at the sizes users run,
through the public entry points on an NVIDIA GPU, and check each against
the same public call on the CPU backend.

    python chip_smoke.py          # phases 1-5 on one GPU
    python chip_smoke.py --four   # the mesh="auto" fit path on four GPUs

Phases of the one-card run, in order:

0. device check: the first JAX device must be a GPU (no CPU fallback);
   prints the card's name and power limit (``nvidia-smi``), its
   ``device_kind`` and the JAX version.
1. service stream: three seeded 8192 x 12-obs datasets through
   ``fit_lsq_stream`` in the service configuration, run twice; one
   dataset through ``fit_lsq`` with the default (f64 reference-parity)
   ``IODParams()`` and ``DifferentialCorrectionConfig()``.
2. real cadence: two ``bench.real_cadence_dataset(4096)`` datasets (real
   MPC arcs of 37, 61 and 129 obs) through ``fit_lsq_stream_escalating``.
3. N-body: ``propagate_nbody`` on 4096 lanes over 25-30 days with every
   planet perturbing and the 42-state STM.
4. ephemerides: ``compute_ephemerides_batch`` on 4096 orbits x 64 epochs,
   second-order aberration, Combined output.
5. Chebyshev interpolation: ``interpolate_body`` at phase 4's query
   count; the coefficient-row bytes per second it reads, timed over 32
   query sets in one call, beside a plain device copy.

Each phase prints its compile time, warm wall time, ok/converged share
and the process's ``peak_bytes_in_use``.  The CPU reference runs in a
child process with ``JAX_PLATFORMS=cpu`` (only this process opens the
card) on a seeded subset of each phase's inputs; the comparisons and
their tolerances are in ``check_*`` below.  Any failure exits non-zero
and prints no result line.  The last stdout line is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: Fit parity (``check_fits``).  The ok/error status must agree on
#: ``MIN_STATUS`` of the rows, each mismatch printed with both nRMS
#: values.  Every row ok on both sides must then be accepted for one of
#: these reasons, or the check fails:
#:
#: * same point: both results of one kind (least-squares orbit, or IOD
#:   fallback with the same status) and every element within rtol 1e-8 /
#:   atol 1e-12, the public-API parity contract (tests/test_parallel.py);
#: * same optimum: both converged through least squares, every element
#:   within ``sigmas`` of its formal 1-sigma and, where ``nrms_rel`` is
#:   set, nRMS equal to it (relative);
#: * no orbit (where ``no_orbit`` is set): nRMS above it on both sides, so
#:   neither result fits the data (chi-squared per residual above 9).
#:
#: Elements are compared at the reference's epoch.  A fit's epoch is that
#: of its IOD triplet's middle observation (light-time corrected), and
#: mixed precision can pick another triplet of the same arc; both fits
#: use the two-body model, under which moving an orbit to another epoch
#: changes only its mean longitude, by n dt with n = sqrt(mu / a^3).
MIN_STATUS = 0.99
#: f64: the card and the CPU run the same arithmetic up to rounding, so a
#: row outside rtol 1e-8 must be the same optimum to 1e-6 of a sigma and
#: of its nRMS
FIT_F64 = dict(rtol=1e-8, atol=1e-12, sigmas=1e-6, nrms_rel=1e-6,
               no_orbit=None)
#: mixed: the f32 pre-warm and the f32 Jacobians of the f64 loop end each
#: run at its own point near the f64 optimum (up to 6.4e-3 sigma from it
#: on the CPU), and the f32 IOD scoring can pick another triplet, so
#: rtol 1e-8 holds for few rows; the same optimum is every element within
#: 0.05 sigma.  The service profile's nRMS is not compared: at elements
#: 0.009 sigma apart the card itself reports 0.985 at batch 256 and 1.443
#: at batch 8192 for one row.  Rows that fit the data on neither side
#: (nRMS > 3) are chaotic in the rounding and are listed, not compared.
FIT_MIXED = dict(rtol=1e-8, atol=1e-12, sigmas=0.05, nrms_rel=None,
                 no_orbit=3.0)
#: |dRA|, |dDec| bound (rad).  CPU batch-vs-per-orbit parity is 1e-13;
#: the slack covers GPU-vs-CPU differences in transcendental functions,
#: amplified by the light-time iteration
EPHEM_TOL = 1e-11
#: Chebyshev interpolation agreement (AU)
INTERP_ATOL = 1e-14
#: N-body bound factor.  DOP853 keeps each accepted step's local error
#: under atol + rtol|y| on every one of the 42 components, so one run's
#: global error is at most n_steps times that; the card and the CPU may
#: accept different step sequences, so two runs differ by up to twice
#: it, and the element Jacobian sums six STM products: 2 x 6 = 12
NBODY_FACTOR = 12.0

# sizes of the one-card run (the users' sizes; there is no reduced run)
N_TRAJ = 8192  # 12-obs trajectories per service dataset
N_OBS = 12
N_STREAM = 3  # service datasets
N_REAL = 4096  # real-cadence trajectories per dataset
N_LANES = 4096  # N-body lanes
N_ORBITS = 4096  # ephemeris orbits
N_EPOCHS = 64  # ephemeris epochs
SUB_FIT = 256  # CPU-checked rows of each 12-obs fit
SUB_REAL = 96  # CPU-checked real-cadence rows
SUB_NBODY = 64
SUB_EPHEM = 64
#: phase 5 times this many query sets of phase 4's size in one call
INTERP_SETS = 32
COPY_BYTES = 2 ** 30  # plain device copy beside phase 5
#: the CPU reference must be done this long after the start
DEADLINE_S = 1100.0


class CheckFailed(AssertionError):
    """A GPU result disagrees with its CPU reference beyond tolerance."""


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------------
# instrumentation
# --------------------------------------------------------------------------

#: [count, seconds] of XLA backend compiles in this process
_COMPILES = [0, 0.0]


def _install_compile_counter():
    import jax.monitoring as mon

    def _on(key, dur, **_kw):
        if key == "/jax/core/compile/backend_compile_duration":
            _COMPILES[0] += 1
            _COMPILES[1] += dur

    mon.register_event_duration_secs_listener(_on)


class Phase:
    """Wall clock and compile accounting of one phase's calls."""

    def __init__(self, name):
        self.name = name
        self.first_s = self.warm_s = None
        self.compiles = [0, 0.0]

    def call(self, fn, warm=False):
        """Run ``fn`` (which must block on its result); record its wall
        time as the first (compile) call or the warm call."""
        c0, s0 = _COMPILES
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        if warm:
            self.warm_s = dt
        else:
            self.first_s = dt
        self.compiles[0] += _COMPILES[0] - c0
        self.compiles[1] += _COMPILES[1] - s0
        return out

    def report(self, share_name, share, extra=""):
        import jax

        stats = jax.devices()[0].memory_stats() or {}
        log(
            f"phase {self.name}: first call {self.first_s:.2f} s "
            f"({self.compiles[0]} XLA compiles, {self.compiles[1]:.2f} s "
            f"compiling); warm {self.warm_s:.4g} s; {share_name} "
            f"{share * 100:.2f}%; peak_bytes_in_use "
            f"{stats.get('peak_bytes_in_use', 'n/a')}{extra}"
        )


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------


def pick(n_total, n, seed):
    """Seeded sorted subset of ``range(n_total)``."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n_total, size=min(n, n_total), replace=False))


def subset_traj(ds, tids):
    """Dataset of the given trajectories only (every column kept)."""
    want = set(tids)
    rows = [g for tid, g in ds.trajectory_groups() if tid in want]
    return ds.subset(np.concatenate(rows))


def make_ephem(tables=None):
    """The benchmark's analytic ephemeris, or one over given tables."""
    import bench
    from outfit_tpu.ephem import JPLEphem

    if tables is None:
        return bench.bench_eph()
    return JPLEphem(tables, kind="analytic")


def host_tables(eph):
    """The ephemeris tables as host arrays (to hand to the CPU child)."""
    from outfit_tpu.ephem import BodyTable

    return {
        b: BodyTable(t.t0, t.granule_days, np.asarray(t.coeffs))
        for b, t in eph.tables.items()
    }


def nbody_inputs(n):
    import bench

    el, rng = bench.random_orbits(n, seed=3)
    return el, 57000.0 + rng.uniform(25.0, 30.0, n)


def interp_queries(n_orbits, n_epochs):
    """Phase 5's query epochs: phase 4's count, seeded."""
    return (57000.0 + np.arange(n_epochs)[None, :]
            + np.random.default_rng(9).uniform(0, 1, (n_orbits, n_epochs))
            ).ravel()


def ephem_inputs(n_orbits, n_epochs):
    import bench

    el, rng = bench.random_orbits(n_orbits, seed=5)
    epochs = 57000.0 + np.arange(n_epochs) + rng.uniform(0, 1, n_epochs)
    return el, epochs


# --------------------------------------------------------------------------
# the public calls (run unchanged on the card and on the CPU)
# --------------------------------------------------------------------------


def stream_fit(datasets, eph, mesh="auto"):
    """Phase 1: the 12-obs service stream; one LsqTable per dataset."""
    import bench
    from outfit_tpu.lsq import fit_lsq_stream

    params, cfg = bench.profiles()["service"]
    return [
        res for _ds, res in fit_lsq_stream(
            list(datasets), eph, params, cfg, seed=7, mesh=mesh,
            **bench.SERVICE_STREAM_KW,
        )
    ]


def f64_fit(ds, eph, mesh="auto"):
    """Phase 1: ``fit_lsq`` with the default (f64) parameters."""
    from outfit_tpu.iod import IODParams
    from outfit_tpu.lsq import DifferentialCorrectionConfig, fit_lsq

    return fit_lsq(
        ds, eph, IODParams(), DifferentialCorrectionConfig(), seed=7,
        mesh=mesh,
    )


def escalating_fit(datasets, eph, mesh="auto"):
    """Phase 2: lean stream + batched rich refit; one LsqTable each."""
    import bench
    from outfit_tpu.lsq import fit_lsq_stream_escalating

    prof = bench.profiles()
    datasets = list(datasets)
    return [
        res for _ds, res in fit_lsq_stream_escalating(
            datasets, eph, [prof["lean"], prof["rich"]], seed=7, mesh=mesh,
            flush_every=len(datasets), depth=3, **bench.SERVICE_STREAM_KW,
        )
    ]


def mesh_parity_fit(ds, eph, mesh="auto"):
    """``--four``: ``fit_lsq`` in f64 with two noise realizations, the
    configuration of the public-API mesh-parity contract
    (``__graft_entry__.dryrun_multichip``)."""
    from outfit_tpu.iod import IODParams
    from outfit_tpu.lsq import DifferentialCorrectionConfig, fit_lsq

    return fit_lsq(
        ds, eph, IODParams(n_noise_realizations=2),
        DifferentialCorrectionConfig(), seed=7, mesh=mesh,
    )


#: jitted phase functions by id of the object they close over; the
#: object is kept with its function so the id cannot be reused
_JITS = {}


def _jitted(kind, obj, make):
    key = (kind, id(obj))
    if key not in _JITS:
        _JITS[key] = (obj, make())
    return _JITS[key][1]


def nbody(el, t1, eph):
    """Phase 3: ``propagate_nbody`` with planets and the 42-state STM."""
    import jax
    import jax.numpy as jnp

    from outfit_tpu.elements.types import EquinoctialElements
    from outfit_tpu.propagator import NBodyConfig, propagate_nbody

    cfg = NBodyConfig.with_planets()
    fn = _jitted("nbody", eph, lambda: jax.jit(
        lambda q, t: propagate_nbody(q, t, eph, cfg)))
    n = len(el)
    eq = EquinoctialElements(
        jnp.full(n, 57000.0), *(jnp.asarray(el[:, j]) for j in range(6))
    )
    out = jax.device_get(fn(eq, jnp.asarray(t1)))
    return {f: np.asarray(getattr(out, f)) for f in out._fields}


def ephemerides(el, epochs, eph):
    """Phase 4: ``compute_ephemerides_batch`` (2nd-order aberration,
    Combined output) from a geocentric observer."""
    from outfit_tpu.ephemeris import (
        AberrationOrder,
        Combined,
        EphemerisConfig,
        EphemerisMode,
        EphemerisRequest,
        compute_ephemerides_batch,
    )
    from outfit_tpu.observations.observatories import Observer

    req = EphemerisRequest(
        EphemerisConfig(aberration=AberrationOrder.SECOND), output=Combined,
    ).add(Observer.geocenter(), EphemerisMode.at(epochs))
    orbits = {f"E{i:05d}": (57000.0, el[i]) for i in range(len(el))}
    return compute_ephemerides_batch(orbits, req, eph)


def _interp_fn(table):
    import jax

    from outfit_tpu.ephem import interpolate_body

    return _jitted("interp", table, lambda: jax.jit(
        lambda q: interpolate_body(table, q)[0]))


def interpolation(table, t):
    """Phase 5: ``interpolate_body`` (positions, AU) on the XLA path."""
    import jax.numpy as jnp

    return np.asarray(_interp_fn(table)(jnp.asarray(t)))


# --------------------------------------------------------------------------
# comparisons
# --------------------------------------------------------------------------


def fit_rows(res, tids=None):
    """Per-row status, nRMS, epoch, elements and formal 1-sigma of a fit
    result (``LsqTable`` or ``{tid: LsqResult}``) as arrays, for rows
    ``tids``."""
    if isinstance(res, dict):
        tids = list(res) if tids is None else list(tids)
        rs = [res[t] for t in tids]

        def vec(v):
            return np.full(6, np.nan) if v is None else np.asarray(v, float)

        return {
            "tids": tids,
            "ok": np.array([r.ok for r in rs], bool),
            "fell_back": np.array([r.fell_back_to_iod for r in rs], bool),
            "status": np.array([r.status for r in rs], np.int64),
            "nrms": np.array([r.normalised_rms for r in rs], float),
            "epoch": np.array([r.epoch for r in rs], float),
            "eq": np.array([vec(r.equinoctial) for r in rs]).reshape(-1, 6),
            "sig": np.array([vec(r.uncertainties) for r in rs]).reshape(-1, 6),
        }
    index = {t: i for i, t in enumerate(res.traj_ids)}
    tids = list(res.traj_ids) if tids is None else list(tids)
    i = np.array([index[t] for t in tids], np.int64)
    return {
        "tids": tids,
        "ok": np.asarray(res.ok, bool)[i],
        "fell_back": np.asarray(res.fell_back_to_iod, bool)[i],
        "status": np.asarray(res.status, np.int64)[i],
        "nrms": np.asarray(res.normalised_rms, float)[i],
        "epoch": np.asarray(res.epoch, float)[i],
        "eq": np.asarray(res.equinoctial, float)[i],
        "sig": np.asarray(res.uncertainties, float)[i],
    }


def element_diff(got, ref):
    """|got - ref| per element, ``got`` moved to ``ref``'s epochs first
    (two-body: only the mean longitude moves, by n dt); the mean
    longitude difference is wrapped to [-pi, pi)."""
    from outfit_tpu.constants import GAUSS_GRAV_SQUARED

    eq = np.array(got["eq"], float)
    a = eq[:, 0]
    dt = ref["epoch"] - got["epoch"]
    move = (a > 0) & np.isfinite(dt) & (dt != 0)
    eq[move, 5] += np.sqrt(GAUSS_GRAV_SQUARED / a[move] ** 3) * dt[move]
    d = eq - ref["eq"]
    d[:, 5] = (d[:, 5] + np.pi) % (2.0 * np.pi) - np.pi
    return np.abs(d)


def check_fits(name, got, ref, rtol, atol, sigmas, nrms_rel, no_orbit):
    """Fit parity row by row (see ``FIT_F64`` / ``FIT_MIXED``).  Returns
    the number of rows in each class; raises ``CheckFailed``."""
    assert list(got["tids"]) == list(ref["tids"]), "row sets differ"
    tids = got["tids"]

    def nrms(k):
        return f"nRMS {got['nrms'][k]:.9g}/{ref['nrms'][k]:.9g}"

    flip = got["ok"] != ref["ok"]
    for k in np.flatnonzero(flip):
        log(f"  {name}: ok/error differs on {tids[k]}: ok "
            f"{got['ok'][k]}/{ref['ok'][k]}, {nrms(k)}")
    both = got["ok"] & ref["ok"]
    conv = (both & ~got["fell_back"] & ~ref["fell_back"]
            & (got["status"] == 1) & (ref["status"] == 1))
    same_kind = (both & (got["fell_back"] == ref["fell_back"])
                 & (got["status"] == ref["status"]))
    d = element_diff(got, ref)
    with np.errstate(invalid="ignore", divide="ignore"):
        in_sig = d / ref["sig"]
        d_nrms = np.abs(got["nrms"] - ref["nrms"]) / ref["nrms"]
    point = same_kind & np.all(d <= atol + rtol * np.abs(ref["eq"]), axis=1)
    optimum = conv & ~point & np.all(in_sig <= sigmas, axis=1)
    if nrms_rel is not None:
        optimum &= d_nrms <= nrms_rel
    none = np.zeros_like(both)
    if no_orbit is not None:
        none = (both & ~point & ~optimum & (got["nrms"] > no_orbit)
                & (ref["nrms"] > no_orbit))
    bad = both & ~point & ~optimum & ~none
    moved = both & (got["epoch"] != ref["epoch"])
    for k in np.flatnonzero(none):
        log(f"  {name}: no orbit on either side {tids[k]}: {nrms(k)}, "
            f"status {got['status'][k]}/{ref['status'][k]}")
    for k in np.flatnonzero(bad):
        log(f"  {name}: {tids[k]} differs: status {got['status'][k]}/"
            f"{ref['status'][k]}, fallback {got['fell_back'][k]}/"
            f"{ref['fell_back'][k]}, epoch {got['epoch'][k]:.6f}/"
            f"{ref['epoch'][k]:.6f}, max |d| {np.nanmax(d[k]):.3e}, "
            f"{np.nanmax(in_sig[k]):.3g} sigma, {nrms(k)}")
    share = 1.0 - float(flip.mean()) if flip.size else 1.0
    counts = dict(point=int(point.sum()), optimum=int(optimum.sum()),
                  none=int(none.sum()), bad=int(bad.sum()))
    m_sig = float(np.nanmax(in_sig[optimum])) if optimum.any() else 0.0
    m_nrms = float(np.nanmax(d_nrms[optimum])) if optimum.any() else 0.0
    log(f"parity {name}: {flip.size} rows, ok/error agrees on "
        f"{share * 100:.2f}%; of {int(both.sum())} rows ok on both sides "
        f"({int(moved.sum())} at another epoch): {counts['point']} at the "
        f"same point, {counts['optimum']} at the same optimum (max "
        f"{m_sig:.3e} sigma apart, nRMS up to {m_nrms:.3e} apart, "
        f"relative), {counts['none']} with no orbit on either side, "
        f"{counts['bad']} differ")
    if share < MIN_STATUS:
        raise CheckFailed(
            f"{name}: ok/error agrees on {share:.4f} < {MIN_STATUS}")
    if not both.any():
        raise CheckFailed(f"{name}: no row to compare")
    if counts["bad"]:
        raise CheckFailed(f"{name}: {counts['bad']} rows differ")
    return counts


def check_nbody(got, ref, atol, rtol):
    """N-body parity per array: status equal, and
    ``|d| <= NBODY_FACTOR * n_steps * (atol + rtol * |ref|)`` elementwise,
    with ``n_steps`` the larger accepted-step count of the two runs."""
    if not np.array_equal(got["status"], ref["status"]):
        raise CheckFailed("nbody: status differs")
    steps = np.maximum(got["n_steps"], ref["n_steps"]).astype(float)
    worst = {}
    for f in ("position", "velocity", "dpos_delem", "dvel_delem"):
        a, b = got[f], ref[f]
        s = steps.reshape(steps.shape + (1,) * (a.ndim - 1))
        bound = NBODY_FACTOR * s * (atol + rtol * np.abs(b))
        d = np.abs(a - b)
        worst[f] = (float(d.max()), float(np.max(d / bound)))
        if not np.all(d <= bound):
            raise CheckFailed(
                f"nbody {f}: max |d| {d.max():.3e} exceeds its bound "
                f"(max |d|/bound {np.max(d / bound):.3e})")
    log("parity nbody: " + ", ".join(
        f"{f} max |d| {m:.3e} ({r:.2e} of bound)"
        for f, (m, r) in worst.items()))
    return worst


def ephem_cols(table, rows=slice(None)):
    """``ok``, ``ra`` and ``dec`` of an EphemerisTable's ``rows``."""
    return {f: np.asarray(getattr(table, f))[rows] for f in ("ok", "ra", "dec")}


def check_ephemerides(got, ref, tol=EPHEM_TOL):
    """Ephemeris parity on ``ephem_cols``: ``ok`` equal, |dRA| (wrapped)
    and |dDec| <= tol."""
    if not np.array_equal(got["ok"], ref["ok"]):
        raise CheckFailed("ephemerides: ok masks differ")
    ok = ref["ok"]
    dra = np.abs(np.angle(np.exp(1j * (got["ra"][ok] - ref["ra"][ok]))))
    ddec = np.abs(got["dec"][ok] - ref["dec"][ok])
    m_ra = float(dra.max()) if dra.size else 0.0
    m_dec = float(ddec.max()) if ddec.size else 0.0
    log(f"parity ephemerides: {int(ok.sum())} entries, max |dRA| "
        f"{m_ra:.3e} rad, max |dDec| {m_dec:.3e} rad (bound {tol:g})")
    if not ok.any():
        raise CheckFailed("ephemerides: no entry is ok")
    if m_ra > tol or m_dec > tol:
        raise CheckFailed("ephemerides: outside tolerance")
    return m_ra, m_dec


def check_interp(got, ref, atol=INTERP_ATOL):
    d = float(np.max(np.abs(got - ref)))
    log(f"parity interpolation: {got.shape[0]} queries, max |d| {d:.3e} AU "
        f"(bound {atol:g})")
    if not d <= atol:
        raise CheckFailed("interpolation: outside tolerance")
    return d


# --------------------------------------------------------------------------
# CPU reference (child process)
# --------------------------------------------------------------------------


def cpu_reference(inputs):
    """Every phase's public call on its CPU subset, ``mesh=None``."""
    import outfit_tpu  # noqa: F401  (x64, highest matmul precision)
    from outfit_tpu.ephem import Body

    eph = make_ephem(inputs["tables"])
    return {
        "stream": stream_fit([inputs["fit_sub"]], eph, mesh=None)[0],
        "f64": f64_fit(inputs["fit_sub"], eph, mesh=None),
        "real": escalating_fit([inputs["real_sub"]], eph, mesh=None)[0],
        "nbody": nbody(*inputs["nbody"], eph),
        "ephem": ephemerides(*inputs["ephem"], eph),
        "interp": interpolation(eph.tables[Body.EMB], inputs["interp"]),
    }


def _cpu_child_main(workdir):
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    t0 = time.perf_counter()
    out = cpu_reference(inputs)
    with open(os.path.join(workdir, "reference.pkl"), "wb") as f:
        pickle.dump(out, f)
    log(f"cpu reference: {time.perf_counter() - t0:.1f} s")
    return 0


def start_cpu_reference(inputs, workdir):
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-reference",
         workdir],
        env=env, cwd=REPO,
        stdout=open(os.path.join(workdir, "child.log"), "w"),
        stderr=subprocess.STDOUT,
    )


def finish_cpu_reference(proc, workdir, timeout_s):
    try:
        rc = proc.wait(timeout=max(timeout_s, 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError(f"CPU reference exceeded {timeout_s:.0f} s")
    with open(os.path.join(workdir, "child.log")) as f:
        tail = f.read()[-4000:]
    if rc != 0:
        raise RuntimeError(f"CPU reference failed (rc={rc}):\n{tail}")
    log(tail.strip().splitlines()[-1])
    with open(os.path.join(workdir, "reference.pkl"), "rb") as f:
        return pickle.load(f)


# --------------------------------------------------------------------------
# the runs
# --------------------------------------------------------------------------


def run_one():
    """Phases 1-5 on the default device, checked against the CPU child."""
    import bench

    t_start = time.perf_counter()
    eph = make_ephem()
    datasets = [bench.synthetic_dataset(N_TRAJ, N_OBS, eph, seed=400 + i)
                for i in range(N_STREAM)]
    real = [bench.real_cadence_dataset(N_REAL, seed=101 + i)
            for i in range(2)]
    nb_el, nb_t1 = nbody_inputs(N_LANES)
    ep_el, ep_epochs = ephem_inputs(N_ORBITS, N_EPOCHS)
    q = interp_queries(N_ORBITS, N_EPOCHS)

    fit_tids = [datasets[0].traj_ids[i] for i in pick(N_TRAJ, SUB_FIT, 11)]
    real_tids = [real[0].traj_ids[i] for i in pick(N_REAL, SUB_REAL, 12)]
    nb_i = pick(N_LANES, SUB_NBODY, seed=13)
    ep_i = pick(N_ORBITS, SUB_EPHEM, seed=14)
    inputs = {
        "tables": host_tables(eph),
        "fit_sub": subset_traj(datasets[0], fit_tids),
        "real_sub": subset_traj(real[0], real_tids),
        "nbody": (nb_el[nb_i], nb_t1[nb_i]),
        "ephem": (ep_el[ep_i], ep_epochs),
        "interp": q,
    }
    log(f"inputs built in {time.perf_counter() - t_start:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        child = start_cpu_reference(inputs, workdir)
        try:
            gpu = _device_phases(eph, datasets, real, nb_el, nb_t1,
                                 ep_el, ep_epochs, q)
            ref = finish_cpu_reference(
                child, workdir, DEADLINE_S - (time.perf_counter() - t_start))
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()

    from outfit_tpu.propagator import NBodyConfig

    cfg = NBodyConfig.with_planets()
    checks = [
        (check_fits, ("stream mixed", fit_rows(gpu["stream"], fit_tids),
                      fit_rows(ref["stream"], fit_tids)), FIT_MIXED),
        (check_fits, ("fit_lsq f64", fit_rows(gpu["f64"], fit_tids),
                      fit_rows(ref["f64"], fit_tids)), FIT_F64),
        (check_fits, ("real-cadence escalating",
                      fit_rows(gpu["real"], real_tids),
                      fit_rows(ref["real"], real_tids)), FIT_MIXED),
        (check_nbody, ({k: v[nb_i] for k, v in gpu["nbody"].items()},
                       ref["nbody"], cfg.abs_tol, cfg.rel_tol), {}),
        (check_ephemerides, (ephem_cols(gpu["ephem"], ep_i),
                             ephem_cols(ref["ephem"])), {}),
        (check_interp, (gpu["interp"], ref["interp"]), {}),
    ]
    # every comparison is printed before the first failure is raised
    failed = []
    for fn, check_args, kw in checks:
        try:
            fn(*check_args, **kw)
        except CheckFailed as e:
            failed.append(str(e))
    if failed:
        raise CheckFailed("; ".join(failed))
    log(f"all phases ok in {time.perf_counter() - t_start:.1f} s")


def _device_phases(eph, datasets, real, nb_el, nb_t1, ep_el, ep_epochs, q):
    import jax
    import jax.numpy as jnp

    from outfit_tpu.ephem import Body, interpolate_body

    out = {}

    # -- 1. service stream + f64 defaults ------------------------------------
    ph = Phase("1 service stream")
    first = ph.call(lambda: stream_fit(datasets[:1], eph))
    tables = ph.call(lambda: stream_fit(datasets, eph), warm=True)
    n_fit = sum(len(t) for t in tables)
    conv = sum(int(np.asarray(t.converged).sum()) for t in tables) / n_fit
    ph.report("converged", conv,
              f"; {n_fit} fits over {len(datasets)} datasets")
    a, b = fit_rows(first[0]), fit_rows(tables[0])
    same = (a["ok"] == b["ok"]) & (a["status"] == b["status"])
    both = same & a["ok"] & b["ok"]
    log(f"phase 1 determinism (two GPU runs of dataset 0): "
        f"{int((~same).sum())} status differences, max |d elements| "
        f"{float(np.max(np.abs(a['eq'][both] - b['eq'][both]))):.3e}")
    out["stream"] = tables[0]

    ph = Phase("1 fit_lsq f64 defaults")
    out["f64"] = ph.call(lambda: f64_fit(datasets[0], eph))
    ph.call(lambda: f64_fit(datasets[1], eph), warm=True)
    r = fit_rows(out["f64"])
    ph.report("converged", float(np.mean(r["ok"] & ~r["fell_back"])),
              f"; {len(r['tids'])} fits")

    # -- 2. real-cadence escalating stream -----------------------------------
    ph = Phase("2 real-cadence escalating")
    ph.call(lambda: escalating_fit(real[:1], eph))
    tables = ph.call(lambda: escalating_fit(real, eph), warm=True)
    n_fit = sum(len(t) for t in tables)
    conv = sum(int(np.asarray(t.converged).sum()) for t in tables) / n_fit
    ph.report("converged", conv,
              f"; {n_fit} fits over {len(real)} datasets")
    out["real"] = tables[0]

    # -- 3. N-body -------------------------------------------------------------
    ph = Phase("3 nbody")
    ph.call(lambda: nbody(nb_el, nb_t1, eph))
    out["nbody"] = ph.call(lambda: nbody(nb_el, nb_t1, eph), warm=True)
    ph.report("ok", float(np.mean(out["nbody"]["status"] == 0)),
              f"; {len(nb_el)} lanes, "
              f"{int(out['nbody']['n_steps'].sum())} accepted steps")

    # -- 4. ephemerides --------------------------------------------------------
    ph = Phase("4 ephemerides")
    ph.call(lambda: ephemerides(ep_el, ep_epochs, eph))
    out["ephem"] = ph.call(lambda: ephemerides(ep_el, ep_epochs, eph),
                           warm=True)
    ph.report("ok", float(np.mean(out["ephem"].ok)),
              f"; {out['ephem'].ok.size} entries")

    # -- 5. Chebyshev interpolation -------------------------------------------
    # the timed call evaluates INTERP_SETS query sets of phase 4's size in
    # one jitted call (lax.map), so launch and dispatch are a small part
    # of its wall time; every run is printed
    ph = Phase("5 interpolation")
    table = eph.tables[Body.EMB]
    out["interp"] = ph.call(lambda: interpolation(table, q))
    ph.call(lambda: interpolation(table, q), warm=True)
    qs = jnp.asarray(q[None, :] + 1e-3 * np.arange(INTERP_SETS)[:, None])
    many = jax.jit(lambda v: jax.lax.map(
        lambda x: interpolate_body(table, x)[0], v))
    jax.block_until_ready(many(qs))
    t_many = _runs(lambda: jax.block_until_ready(many(qs)))
    row_bytes = 8 * int(np.prod(np.shape(table.coeffs)[1:]))
    x = jnp.zeros(COPY_BYTES // 8)
    copy = jax.jit(lambda v: v + 1.0)
    jax.block_until_ready(copy(x))
    t_copy = _runs(lambda: jax.block_until_ready(copy(x)))
    del x
    n_read = INTERP_SETS * q.size * row_bytes
    ph.report(
        "finite", float(np.mean(np.isfinite(out["interp"]))),
        f"; {INTERP_SETS} x {q.size} queries x {row_bytes} B rows in one "
        f"call, s: {_fmt(t_many)}, row bytes/s: "
        f"{_fmt([n_read / t for t in t_many])}; plain copy of {COPY_BYTES} B "
        f"(read + write), bytes/s: {_fmt([2 * COPY_BYTES / t for t in t_copy])}",
    )
    return out


def _runs(fn, n=5):
    """Wall time of ``n`` calls of ``fn`` (which must block)."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def _fmt(xs):
    return "[" + ", ".join(f"{x:.4e}" for x in xs) + "]"


def run_four():
    """``--four``: the real-cadence workload through ``fit_lsq`` and
    ``fit_lsq_stream_escalating`` with ``mesh="auto"`` on every visible
    device, each against ``mesh=None`` on one of them."""
    import bench

    eph = make_ephem()
    real = [bench.real_cadence_dataset(N_REAL, seed=101 + i)
            for i in range(2)]

    ph = Phase("four fit_lsq f64 mesh=auto")
    ph.call(lambda: mesh_parity_fit(real[0], eph))
    mesh_res = ph.call(lambda: mesh_parity_fit(real[1], eph), warm=True)
    rows = fit_rows(mesh_res)
    ph.report("converged", float(np.mean(rows["ok"] & ~rows["fell_back"])))
    one = mesh_parity_fit(real[1], eph, mesh=None)

    ph = Phase("four escalating mesh=auto")
    ph.call(lambda: escalating_fit(real[:1], eph))
    tables = ph.call(lambda: escalating_fit(real, eph), warm=True)
    n_fit = sum(len(t) for t in tables)
    ph.report("converged",
              sum(int(np.asarray(t.converged).sum()) for t in tables) / n_fit)
    ones = escalating_fit(real, eph, mesh=None)

    checks = [("fit_lsq f64 mesh=auto vs mesh=None", rows,
               fit_rows(one, rows["tids"]), FIT_F64)]
    checks += [(f"escalating dataset {k} mesh=auto vs mesh=None",
                fit_rows(t), fit_rows(o, list(t.traj_ids)), FIT_MIXED)
               for k, (t, o) in enumerate(zip(tables, ones))]
    failed = []
    for name, got, ref, kw in checks:
        try:
            check_fits(name, got, ref, **kw)
        except CheckFailed as e:
            failed.append(str(e))
    if failed:
        raise CheckFailed("; ".join(failed))


# --------------------------------------------------------------------------
# entry
# --------------------------------------------------------------------------


def _nvidia_smi():
    """``name, power.limit`` of each card, from a child that never
    touches JAX."""
    p = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return p.stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the mesh path, on four GPUs")
    ap.add_argument("--cpu-reference", metavar="DIR",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_reference:
        return _cpu_child_main(args.cpu_reference)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found "
              f"{devs[0].platform} ({devs[0].device_kind})", file=sys.stderr)
        return 2
    if args.four and len(devs) != 4:
        print(f"chip_smoke --four: needs 4 GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        return 2
    for line in _nvidia_smi().splitlines():
        log(f"nvidia-smi: {line}")
    log(f"jax {jax.__version__}; device_kind {devs[0].device_kind}; "
        f"{len(devs)} device(s)")

    import outfit_tpu  # noqa: F401  (x64, highest matmul precision)
    from outfit_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    _install_compile_counter()
    if args.four:
        run_four()
    else:
        run_one()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
