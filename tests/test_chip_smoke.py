"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phase functions and comparison helpers work at tiny sizes — each helper
passes a result against itself and rejects a perturbed copy."""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest

import bench
import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_to_run_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "needs an NVIDIA GPU" in p.stderr, p.stderr[-2000:]


@pytest.fixture(scope="module")
def eph():
    return cs.make_ephem()


@pytest.fixture(scope="module")
def stream_rows(eph):
    ds = bench.synthetic_dataset(8, 12, eph, seed=400)
    res = cs.stream_fit([ds], eph, mesh=None)
    assert len(res) == 1 and len(res[0]) == 8
    return cs.fit_rows(res[0])


@pytest.mark.parametrize("contract", ["f64", "mixed"])
def test_fit_check_rejects_perturbed_elements(stream_rows, contract):
    kw = cs.FIT_F64 if contract == "f64" else cs.FIT_MIXED
    counts = cs.check_fits("same", stream_rows, copy.deepcopy(stream_rows),
                           **kw)
    assert counts["bad"] == 0 and counts["point"] >= 2
    conv = np.flatnonzero(stream_rows["ok"] & ~stream_rows["fell_back"])
    assert conv.size >= 2
    bad = copy.deepcopy(stream_rows)
    if contract == "f64":
        bad["eq"][conv[0], 0] *= 1.0 + 1e-7  # semi-major axis, 10x rtol
    else:
        bad["eq"][conv[0], 1] += 0.1 * stream_rows["sig"][conv[0], 1]
    with pytest.raises(cs.CheckFailed, match="1 rows differ"):
        cs.check_fits("perturbed", bad, stream_rows, **kw)


def test_fit_check_rejects_status_flips(stream_rows):
    bad = copy.deepcopy(stream_rows)
    k = int(np.flatnonzero(bad["ok"])[0])
    bad["ok"][k] = False  # one of 8 rows: 87.5% agreement < 99%
    for kw in (cs.FIT_F64, cs.FIT_MIXED):
        with pytest.raises(cs.CheckFailed, match="ok/error agrees"):
            cs.check_fits("flipped", bad, stream_rows, **kw)


def _moved(rows, k, dt):
    """``rows`` with row ``k`` moved by ``dt`` days along its two-body
    orbit (only the mean longitude changes)."""
    from outfit_tpu.constants import GAUSS_GRAV_SQUARED

    out = copy.deepcopy(rows)
    a = out["eq"][k, 0]
    out["epoch"][k] += dt
    out["eq"][k, 5] += np.sqrt(GAUSS_GRAV_SQUARED / a ** 3) * dt
    return out


@pytest.mark.parametrize("contract", ["f64", "mixed"])
def test_fit_check_compares_at_the_reference_epoch(stream_rows, contract):
    """The same orbit reported at another triplet's epoch is the same
    point; a mean longitude that does not follow the epoch is not."""
    kw = cs.FIT_F64 if contract == "f64" else cs.FIT_MIXED
    k = int(np.flatnonzero(stream_rows["ok"] & ~stream_rows["fell_back"])[0])
    moved = _moved(stream_rows, k, 1.7)
    d = cs.element_diff(moved, stream_rows)
    assert d[k].max() <= 1e-12 + 1e-8 * np.abs(stream_rows["eq"][k]).max()
    assert cs.check_fits("moved", moved, stream_rows, **kw)["bad"] == 0
    wrong = copy.deepcopy(moved)
    wrong["eq"][k, 5] = stream_rows["eq"][k, 5]  # epoch changed alone
    with pytest.raises(cs.CheckFailed, match="1 rows differ"):
        cs.check_fits("epoch only", wrong, stream_rows, **kw)


def test_fit_check_same_optimum_bounds(stream_rows):
    """Mixed accepts a row a hundredth of a sigma away and rejects one
    0.06 sigma away; f64 accepts neither."""
    k = int(np.flatnonzero(stream_rows["ok"] & ~stream_rows["fell_back"])[0])
    for frac, mixed_ok in ((0.01, True), (0.06, False)):
        off = copy.deepcopy(stream_rows)
        off["eq"][k, 2] += frac * stream_rows["sig"][k, 2]
        counts = None
        try:
            counts = cs.check_fits("off", off, stream_rows, **cs.FIT_MIXED)
        except cs.CheckFailed:
            pass
        assert (counts is not None and counts["optimum"] == 1) == mixed_ok
        with pytest.raises(cs.CheckFailed, match="1 rows differ"):
            cs.check_fits("off", off, stream_rows, **cs.FIT_F64)


def test_fit_check_no_orbit_rows(stream_rows):
    """A row that fits the data on neither side (nRMS > 3) is listed, not
    compared, under the mixed contract only; one good side is not enough."""
    k = int(np.flatnonzero(stream_rows["ok"] & ~stream_rows["fell_back"])[0])
    a, b = copy.deepcopy(stream_rows), copy.deepcopy(stream_rows)
    a["eq"][k, 0] *= 1.5
    a["nrms"][k], b["nrms"][k] = 40.0, 12.0
    assert cs.check_fits("junk", a, b, **cs.FIT_MIXED)["none"] == 1
    with pytest.raises(cs.CheckFailed, match="1 rows differ"):
        cs.check_fits("junk", a, b, **cs.FIT_F64)
    b["nrms"][k] = 0.9
    with pytest.raises(cs.CheckFailed, match="1 rows differ"):
        cs.check_fits("junk", a, b, **cs.FIT_MIXED)


def test_fit_check_rejects_fallback_against_orbit(stream_rows):
    """A least-squares orbit against an IOD fallback is never the same
    point, even with equal elements."""
    k = int(np.flatnonzero(stream_rows["ok"] & ~stream_rows["fell_back"])[0])
    fb = copy.deepcopy(stream_rows)
    fb["fell_back"][k] = True
    fb["status"][k] = 3
    for kw in (cs.FIT_F64, cs.FIT_MIXED):
        with pytest.raises(cs.CheckFailed, match="1 rows differ"):
            cs.check_fits("fallback", fb, stream_rows, **kw)


def test_nbody_check_rejects_perturbed_state(eph):
    out = cs.nbody(*cs.nbody_inputs(4), eph)
    assert out["position"].shape == (4, 3)
    assert out["dpos_delem"].shape == (4, 6, 3)
    assert (out["status"] == 0).all() and (out["n_steps"] > 0).all()
    cs.check_nbody(out, copy.deepcopy(out), 1e-12, 1e-12)
    bad = copy.deepcopy(out)
    bad["velocity"][1, 2] += 1e-6
    with pytest.raises(cs.CheckFailed, match="velocity"):
        cs.check_nbody(bad, out, 1e-12, 1e-12)


def test_ephemerides_check_rejects_perturbed_dec(eph):
    el, epochs = cs.ephem_inputs(4, 3)
    table = cs.ephemerides(el, epochs, eph)
    cols = cs.ephem_cols(table)
    assert cols["ra"].shape == (4, 3) and cols["ok"].all()
    wrapped = copy.deepcopy(cols)
    wrapped["ra"] = wrapped["ra"] + 2 * np.pi  # same direction on the sky
    assert cs.check_ephemerides(wrapped, cols)[0] < 1e-12
    bad = copy.deepcopy(cols)
    bad["dec"][2, 1] += 1e-10
    with pytest.raises(cs.CheckFailed):
        cs.check_ephemerides(bad, cols)


def test_interpolation_check_rejects_perturbed_position(eph):
    from outfit_tpu.ephem import Body

    q = 57000.0 + np.linspace(0.0, 100.0, 37)
    pos = cs.interpolation(eph.tables[Body.EMB], q)
    assert pos.shape == (37, 3) and np.isfinite(pos).all()
    assert cs.check_interp(pos, pos.copy()) == 0.0
    bad = pos.copy()
    bad[5, 0] += 1e-13
    with pytest.raises(cs.CheckFailed):
        cs.check_interp(bad, pos)
