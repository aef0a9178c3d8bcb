"""Orbital element types, conversions, Jacobians, two-body propagation.

Oracles from the reference's inline tests
(``src/orbit_type/equinoctial_element.rs:1214-1428``) plus autodiff
cross-checks (jax.jacfwd) the Rust implementation could not perform.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from outfit_tpu.elements import (
    CometaryElements,
    EquinoctialElements,
    EquinoctialLimits,
    KeplerianElements,
    ccek1,
    cometary_to_keplerian,
    equinoctial_to_keplerian,
    is_bizarre,
    jacobian_cometary_to_keplerian,
    jacobian_equinoctial_to_keplerian,
    jacobian_keplerian_to_equinoctial,
    keplerian_to_equinoctial,
    propagate_covariance,
    propagate_twobody,
    solve_generalized_kepler,
    uncertainties_from_covariance,
)
from outfit_tpu.kepler import propagate_universal


def _eq(**kw):
    defaults = dict(
        reference_epoch=0.0,
        semi_major_axis=1.8017360713154256,
        h=0.2693736809092272,
        k=8.85641526001356e-2,
        p=8.089970166396302e-4,
        q=0.10168201109730375,
        mean_longitude=1.6936970079414786,
    )
    defaults.update(kw)
    return EquinoctialElements(
        jnp.float64(defaults["reference_epoch"]),
        jnp.float64(defaults["semi_major_axis"]),
        jnp.float64(defaults["h"]),
        jnp.float64(defaults["k"]),
        jnp.float64(defaults["p"]),
        jnp.float64(defaults["q"]),
        jnp.float64(defaults["mean_longitude"]),
    )


class TestConversions:
    def test_equinoctial_to_keplerian_oracle(self):
        # equinoctial_element.rs:1240-1264
        eq = _eq(
            semi_major_axis=1.8017360713,
            h=0.2693736809404963,
            k=0.08856415260522467,
            p=0.0008089970142830734,
            q=0.10168201110394352,
            mean_longitude=1.693697008,
        )
        kep = equinoctial_to_keplerian(eq)
        assert float(kep.semi_major_axis) == pytest.approx(1.8017360713, abs=1e-12)
        assert float(kep.eccentricity) == pytest.approx(0.2835591457, abs=1e-10)
        assert float(kep.inclination) == pytest.approx(0.20267383289999996, abs=1e-10)
        assert float(kep.ascending_node_longitude) == pytest.approx(0.007955979, abs=1e-9)
        assert float(kep.periapsis_argument) == pytest.approx(1.2451951388, abs=1e-9)
        assert float(kep.mean_anomaly) == pytest.approx(0.4405458902000001, abs=1e-9)

    def test_roundtrip(self):
        eq = _eq()
        kep = equinoctial_to_keplerian(eq)
        eq2 = keplerian_to_equinoctial(kep)
        np.testing.assert_allclose(np.asarray(eq.vector), np.asarray(eq2.vector), atol=1e-14)

    def test_cometary_hyperbolic(self):
        com = CometaryElements(
            jnp.float64(0.0),
            jnp.float64(0.5),
            jnp.float64(1.5),
            jnp.float64(0.3),
            jnp.float64(1.0),
            jnp.float64(2.0),
            jnp.float64(0.4),
        )
        kep = cometary_to_keplerian(com)
        assert float(kep.semi_major_axis) < 0  # hyperbolic
        # a = -q(1+e)/(e^2-1) = -q/(e-1)
        assert float(kep.semi_major_axis) == pytest.approx(-0.5 / 0.5, abs=1e-12)

    def test_is_bizarre(self):
        assert not bool(is_bizarre(_eq(), EquinoctialLimits()))
        assert bool(is_bizarre(_eq(semi_major_axis=1e-6), EquinoctialLimits()))


class TestJacobians:
    def test_roundtrip_identity(self):
        eq = _eq()
        kep = equinoctial_to_keplerian(eq)
        j1 = np.asarray(jacobian_equinoctial_to_keplerian(eq))
        j2 = np.asarray(jacobian_keplerian_to_equinoctial(kep))
        np.testing.assert_allclose(j2 @ j1, np.eye(6), atol=1e-10)

    def test_eq_to_kep_vs_autodiff(self):
        eq = _eq()

        def f(vec):
            e = EquinoctialElements.from_vector(jnp.float64(0.0), vec)
            return equinoctial_to_keplerian(e).vector

        jac_ad = np.asarray(jax.jacfwd(f)(eq.vector))
        jac_an = np.asarray(jacobian_equinoctial_to_keplerian(eq))
        np.testing.assert_allclose(jac_an, jac_ad, atol=1e-9)

    def test_kep_to_eq_vs_autodiff(self):
        kep = equinoctial_to_keplerian(_eq())

        def f(vec):
            k = KeplerianElements(jnp.float64(0.0), *[vec[i] for i in range(6)])
            return keplerian_to_equinoctial(k).vector

        jac_ad = np.asarray(jax.jacfwd(f)(kep.vector))
        jac_an = np.asarray(jacobian_keplerian_to_equinoctial(kep))
        np.testing.assert_allclose(jac_an, jac_ad, atol=1e-9)

    def test_cometary_vs_autodiff_elliptic_and_hyperbolic(self):
        for e_val in (0.7, 1.8):
            com = CometaryElements(
                jnp.float64(0.0),
                jnp.float64(0.8),
                jnp.float64(e_val),
                jnp.float64(0.2),
                jnp.float64(0.9),
                jnp.float64(1.1),
                jnp.float64(0.5),
            )

            def f(vec):
                c = CometaryElements(jnp.float64(0.0), *[vec[i] for i in range(6)])
                kk = cometary_to_keplerian(c)
                return kk.vector

            jac_ad = np.asarray(jax.jacfwd(f)(com.vector))
            jac_an = np.asarray(jacobian_cometary_to_keplerian(com))
            # reference formulas for dM/de, dM/dnu: compare only defined rows
            np.testing.assert_allclose(jac_an, jac_ad, atol=1e-8)


class TestTwoBody:
    def test_kepler_equation_oracle(self):
        # equinoctial_element.rs:1267-1286
        eq = _eq()
        f, sf, cf, conv = solve_generalized_kepler(
            eq, jnp.float64(1.8432075709935847)
        )
        assert bool(conv)
        assert float(f) == pytest.approx(2.0450042417470673, abs=1e-12)
        # the rotation-carried trig must match libm to ~ulp
        assert float(sf) == pytest.approx(float(np.sin(2.0450042417470673)), abs=5e-15)
        assert float(cf) == pytest.approx(float(np.cos(2.0450042417470673)), abs=5e-15)

    def test_residual_acceptance_on_step_stall(self):
        """Regression (f64 without exact rounding): a lane whose Newton STEP
        stalls just above 100*eps while the residual is already at rounding
        level must be flagged converged — the step-only criterion misfired
        on ~7% of such solves per propagation, which the inf-gated RMS
        scoring compounded into NoViableOrbit for ~45% of trajectories.
        Simulated deterministically: a warm start 6e-13 off the root with a
        1-iteration budget (step test can't fire; |res| ~ 6e-13 <= 1e-12
        must)."""
        eq = _eq()
        lam = jnp.float64(1.8432075709935847)
        f_root = 2.0450042417470673
        f0 = f_root + 6e-13
        warm = (jnp.float64(f0), jnp.float64(np.sin(f0)), jnp.float64(np.cos(f0)))
        f, sf, cf, conv = solve_generalized_kepler(eq, lam, max_iter=1, warm=warm)
        assert bool(conv)
        assert float(f) == pytest.approx(f_root, abs=1e-11)
        # a genuinely-unconverged solve must still report False: cold start,
        # no iterations allowed
        _, _, _, conv0 = solve_generalized_kepler(eq, lam, max_iter=0)
        assert not bool(conv0)

    def test_propagation_oracle(self):
        # equinoctial_element.rs:1288-1315
        eq = _eq()
        res = propagate_twobody(eq, 0.0, 21.019733018845727, compute_derivatives=False)
        assert bool(res.converged)
        np.testing.assert_allclose(
            np.asarray(res.position),
            [-0.9321264203108841, 1.0784562905421133, 0.22313456997634373],
            atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(res.velocity),
            [-0.013800441828595238, -0.007301622877053736, -0.001477839051396935],
            atol=1e-13,
        )

    def test_derivative_oracle(self):
        # equinoctial_element.rs:1317-1427 (column-major nalgebra literals)
        eq = _eq()
        res = propagate_twobody(eq, 0.0, 21.019733018845727, compute_derivatives=True)
        dpos_oracle = np.array(
            [
                [-0.2758472919839214, -0.5803614626760855, -3.3051181917865815,
                 0.2246273101991508, 0.0017270780533123044, -1.9402080820074667],
                [0.7263403095474552, -2.2723053964839406, -1.1670672177854213,
                 -0.18762099832127083, -0.44020925155213336, -1.0265372582837307],
                [0.1497057464344368, -0.4659843688851336, -0.23441565316351645,
                 1.8451739525659905, 2.1348385937023004, -0.20776981686813492],
            ]
        ).T  # -> (6 elements, 3 coords)
        dvel_oracle = np.array(
            [
                [0.002222700614910293, -0.005788282594204328, 0.018371322890135426,
                 -0.0014557385356716304, -1.1693077165124217e-5, 0.012911021052381672],
                [0.0038856205602975087, -0.015583165352767119, -0.010403249849722409,
                 -0.0027777913132127417, 0.0029475300114507746, -0.014937857749615903],
                [0.0007948174310456126, -0.0031927019517180885, -0.0021677860848341836,
                 0.027318414370803085, -0.014453795161933127, -0.003090669964614741],
            ]
        ).T
        np.testing.assert_allclose(np.asarray(res.dpos_delem), dpos_oracle, atol=1e-10)
        np.testing.assert_allclose(np.asarray(res.dvel_delem), dvel_oracle, atol=1e-12)

    def test_partials_vs_autodiff(self):
        """Analytic 6x3 Jacobians must match jacfwd through the whole
        propagation (including the Kepler solve)."""
        eq = _eq()
        dt = 21.019733018845727

        def fpos(vec):
            e = EquinoctialElements.from_vector(jnp.float64(0.0), vec)
            r = propagate_twobody(e, 0.0, dt, compute_derivatives=False)
            return jnp.concatenate([r.position, r.velocity])

        jac = np.asarray(jax.jacfwd(fpos)(eq.vector))  # (6out, 6elem)
        res = propagate_twobody(eq, 0.0, dt, compute_derivatives=True)
        np.testing.assert_allclose(np.asarray(res.dpos_delem).T, jac[:3], atol=1e-8)
        np.testing.assert_allclose(np.asarray(res.dvel_delem).T, jac[3:], atol=1e-9)

    def test_matches_universal_propagation(self):
        """Equinoctial propagation and universal-variable propagation of the
        same physical orbit agree."""
        eq = _eq()
        st0 = propagate_twobody(eq, 0.0, 0.0, compute_derivatives=False)
        dt = 57.25
        st1 = propagate_twobody(eq, 0.0, dt, compute_derivatives=False)
        uni = propagate_universal(st0.position, st0.velocity, 0.0, dt)
        assert int(uni.status) == 0
        np.testing.assert_allclose(np.asarray(st1.position), np.asarray(uni.r1), atol=1e-11)
        np.testing.assert_allclose(np.asarray(st1.velocity), np.asarray(uni.v1), atol=1e-12)

    def test_roundtrip_via_ccek1(self):
        """state -> ccek1 -> keplerian -> equinoctial -> propagate(0) == state."""
        pos = jnp.array([-0.6235500510031639, 1.2114681148601605, 0.2520005914377604])
        vel = jnp.array([-1.5549845137774663e-2, -4.631577489268288e-3, -9.363362126133925e-4])
        out = ccek1(pos, vel)
        el = out.elements
        kep = KeplerianElements(
            jnp.float64(0.0), el[0], el[1], el[2], el[3], el[4], el[5]
        )
        eq = keplerian_to_equinoctial(kep)
        res = propagate_twobody(eq, 0.0, 0.0, compute_derivatives=False)
        np.testing.assert_allclose(np.asarray(res.position), np.asarray(pos), atol=1e-12)
        np.testing.assert_allclose(np.asarray(res.velocity), np.asarray(vel), atol=1e-13)

    def test_batched(self):
        eq0 = _eq()
        batch = EquinoctialElements(*[jnp.tile(x, 8) for x in eq0])
        dts = jnp.linspace(0.0, 100.0, 8)
        res = propagate_twobody(batch, 0.0, dts)
        assert res.position.shape == (8, 3)
        assert res.dpos_delem.shape == (8, 6, 3)
        assert bool(res.converged.all())


class TestCovariance:
    def test_propagate_and_uncertainties(self):
        rng = np.random.default_rng(7)
        m = rng.normal(size=(6, 6))
        cov = jnp.array(m @ m.T)
        eq = _eq()
        j = jacobian_equinoctial_to_keplerian(eq)
        cov_kep = propagate_covariance(cov, j)
        expected = np.asarray(j) @ np.asarray(cov) @ np.asarray(j).T
        np.testing.assert_allclose(np.asarray(cov_kep), expected, atol=1e-12)
        sig = uncertainties_from_covariance(cov_kep)
        np.testing.assert_allclose(
            np.asarray(sig), np.sqrt(np.diag(expected)), atol=1e-12
        )


def test_ccek1_reference_regression_oracle():
    """Exact-value oracle from orb_elem.rs:330-370 (reference tolerance
    5e-13; this port matches at ~7e-16)."""
    from outfit_tpu.elements import ccek1

    pos = jnp.asarray([-0.6235500510031639, 1.2114681148601605, 0.2520005914377604])
    vel = jnp.asarray(
        [-1.5549845137774663e-2, -4.631577489268288e-3, -9.363362126133925e-4]
    )
    out = ccek1(pos, vel)
    assert int(out.kind) == 0  # Keplerian
    np.testing.assert_allclose(
        np.asarray(out.elements),
        [1.8155297166304232, 0.2892182648825829, 0.20434785751952972,
         0.0072890133690443745, 1.2263737249473103, 0.44554742955734405],
        atol=5e-13,
    )


def test_uncertainty_propagation_reference_oracle():
    """Full integration oracle from tests/test_orbit_uncertainty_propag.rs:
    equinoctial elements + covariance -> Keplerian elements, 1-sigma
    uncertainties and covariance (Sigma' = J Sigma J^T).  This port matches
    at machine precision (the reference asserts 1e-10)."""
    from outfit_tpu.elements.types import jacobian_equinoctial_to_keplerian
    from outfit_tpu.elements.uncertainty import propagate_covariance

    eq = EquinoctialElements(*map(jnp.float64, (
        57049.2684537375, 1.8021517900042052, 0.2694922786015968,
        0.08955282358108035, 0.0008974287327937245, 0.10167548786557225,
        1.6921653421358704,
    )))
    cov_eq = np.array([
        [3.651448459073842e-12, -4.87907485491453e-13, 2.321298362132558e-11,
         -3.7695250201166625e-13, 8.511532638002078e-13, -3.91138523482157e-11],
        [-4.879074854914533e-13, 7.437576190456506e-12, -1.1647669978804286e-11,
         9.359797430147383e-13, -2.8577594338429333e-12, 1.853502993770551e-11],
        [2.3212983621325566e-11, -1.164766997880434e-11, 1.577521262959403e-10,
         -3.47676746499932e-12, 8.610023673871895e-12, -2.644913915663376e-10],
        [-3.7695250201166625e-13, 9.359797430147385e-13, -3.4767674649993202e-12,
         3.7739327795249603e-13, -5.048815271306508e-13, 5.7505636344116006e-12],
        [8.511532638002078e-13, -2.857759433842935e-12, 8.610023673871898e-12,
         -5.048815271306507e-13, 1.3170255261786945e-12, -1.4110008489365913e-11],
        [-3.911385234821569e-11, 1.8535029937705585e-11, -2.6449139156633765e-10,
         5.750563634411601e-12, -1.4110008489365913e-11, 4.437117125245391e-10],
    ])

    kep = equinoctial_to_keplerian(eq)
    np.testing.assert_allclose(
        [float(kep.semi_major_axis), float(kep.eccentricity),
         float(kep.inclination), float(kep.ascending_node_longitude),
         float(kep.periapsis_argument), float(kep.mean_anomaly)],
        [1.8021517900042052, 0.2839820354128493, 0.20266238925780133,
         0.008826172835575467, 1.2411480851756391, 0.4421910841246559],
        rtol=1e-13,
    )
    J = jacobian_equinoctial_to_keplerian(eq)
    cov_kep = np.asarray(propagate_covariance(jnp.asarray(cov_eq), J))
    np.testing.assert_allclose(
        np.sqrt(np.diag(cov_kep)),
        [1.910876358918557e-6, 3.926080684435881e-6, 2.2639852329024065e-6,
         6.113264876575711e-6, 4.049775340683106e-5, 2.2182426229638676e-5],
        rtol=1e-10,
    )
    # spot-check off-diagonal covariance terms against the oracle matrix
    np.testing.assert_allclose(cov_kep[0, 5], 3.899825789832625e-11, rtol=1e-10)
    np.testing.assert_allclose(cov_kep[4, 4], 1.6400680310004965e-9, rtol=1e-10)
    np.testing.assert_allclose(cov_kep[1, 4], -1.2349406349235225e-10, rtol=1e-10)


class TestTwoBodyMpmathOracle:
    """Independent 50-digit oracle for the equinoctial two-body propagation:
    the expected state is built DIRECTLY from the Keplerian elements in a
    perifocal frame at mp.dps=50 (classical Kepler equation), bypassing both
    the element conversion and the trig-free rotation-Newton solve under
    test (reference gold-standard methodology, propagation.rs:218-263)."""

    @pytest.mark.parametrize(
        "a,e,i,node,argp,m0,dt_frac",
        [
            (2.3, 0.15, 0.12, 1.1, 0.7, 0.3, 0.43),
            (1.1, 0.95, 0.5, 2.0, 4.0, 6.1, 0.015),   # high-e near perihelion
            (3.0, 0.6, 1.4, 0.2, 3.1, 2.0, 7.21),     # multi-revolution
            (1.7, 0.05, 0.01, 5.0, 0.1, 1.0, -2.3),   # near-circular, backward
        ],
    )
    def test_vs_50_digit_perifocal(self, a, e, i, node, argp, m0, dt_frac):
        import mpmath as mp

        from outfit_tpu.constants import GAUSS_GRAV_SQUARED
        from outfit_tpu.elements import KeplerianElements, keplerian_to_equinoctial

        mp.mp.dps = 50
        mu = mp.mpf(GAUSS_GRAV_SQUARED)
        am, em = mp.mpf(a), mp.mpf(e)
        period = 2 * np.pi * np.sqrt(a**3 / GAUSS_GRAV_SQUARED)
        dt = dt_frac * period

        n_mot = mp.sqrt(mu / am**3)
        M1 = mp.mpf(m0) + n_mot * mp.mpf(dt)
        E1 = mp.findroot(lambda E: E - em * mp.sin(E) - M1, M1)
        b = mp.sqrt(1 - em**2)
        rp = [am * (mp.cos(E1) - em), am * b * mp.sin(E1), mp.mpf(0)]
        r1n = am * (1 - em * mp.cos(E1))
        vp = [
            -mp.sqrt(mu * am) / r1n * mp.sin(E1),
            mp.sqrt(mu * am) / r1n * b * mp.cos(E1),
            mp.mpf(0),
        ]

        def rot(axis, ang, v):
            c, s = mp.cos(ang), mp.sin(ang)
            x, y, z = v
            if axis == 2:
                return [c * x - s * y, s * x + c * y, z]
            return [x, c * y - s * z, s * y + c * z]

        def to_inertial(v):
            return rot(2, mp.mpf(node), rot(0, mp.mpf(i), rot(2, mp.mpf(argp), v)))

        er1 = [float(x) for x in to_inertial(rp)]
        ev1 = [float(x) for x in to_inertial(vp)]

        kep = KeplerianElements(*map(jnp.float64, (57000.0, a, e, i, node, argp, m0)))
        eq = keplerian_to_equinoctial(kep)
        st = propagate_twobody(eq, 57000.0, 57000.0 + dt, compute_derivatives=False)
        assert bool(st.converged)
        assert np.linalg.norm(np.asarray(st.position) - np.array(er1)) < 1e-9
        assert np.linalg.norm(np.asarray(st.velocity) - np.array(ev1)) < 1e-9
