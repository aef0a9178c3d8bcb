"""Unrolled linear algebra utilities, small surfaces and the compile cache."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from outfit_tpu.utils.linalg import cholesky6, cholesky_inverse6


def test_cholesky_inverse_vs_numpy():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(32, 10, 6))
    a = jnp.asarray(np.einsum("bnj,bnk->bjk", g, g) + 1e-6 * np.eye(6))
    inv, ok = cholesky_inverse6(a)
    assert bool(ok.all())
    np.testing.assert_allclose(np.asarray(inv), np.linalg.inv(np.asarray(a)), rtol=1e-8, atol=1e-10)


def test_cholesky_factor():
    rng = np.random.default_rng(1)
    g = rng.normal(size=(6, 6))
    a = jnp.asarray(g @ g.T + 6 * np.eye(6))
    L, ok = cholesky6(a)
    assert bool(ok)
    np.testing.assert_allclose(np.asarray(L @ L.T), np.asarray(a), atol=1e-12)


def test_non_spd_flagged():
    a = jnp.asarray(-np.eye(6))
    _, ok = cholesky_inverse6(a)
    assert not bool(ok)


def test_singular_flagged():
    a = np.eye(6)
    a[3, 3] = 0.0
    _, ok = cholesky_inverse6(jnp.asarray(a))
    assert not bool(ok)


class TestConfigSerde:
    """Serde-feature analogue round trips (Cargo.toml:67,81: the reference's
    optional serde derives on the solver-parameter structs)."""

    def test_iod_params_roundtrip(self):
        import json

        from outfit_tpu.iod.params import IODParams

        p = IODParams(n_noise_realizations=7, precision="mixed", max_triplets=5)
        d = json.loads(json.dumps(p.to_dict()))
        assert IODParams.from_dict(d) == p

    def test_diffcor_config_roundtrip(self):
        import json

        from outfit_tpu.lsq.config import DifferentialCorrectionConfig
        from outfit_tpu.propagator.config import NBodyConfig, PropagatorKind

        cfg = DifferentialCorrectionConfig(
            max_newton_iterations=12,
            free_elements=(True, True, False, True, True, True),
            propagator=PropagatorKind(nbody=True, config=NBodyConfig.with_planets()),
            precision="mixed",
        )
        d = json.loads(json.dumps(cfg.to_dict()))
        assert DifferentialCorrectionConfig.from_dict(d) == cfg


class TestTopLevelFacade:
    def test_reference_facade_names_resolve(self):
        """Every symbol of the reference's curated pub-use facade
        (src/lib.rs:326-434) resolves from the top-level package."""
        import outfit_tpu as ot

        names = """
        KeplerianElements EquinoctialElements CometaryElements OrbitalElements
        OutfitError GaussResult IODParams FullOrbitResult IODRMS
        AU GAUSS_GRAV RADEG RADH RADSEC SECONDS_PER_DAY T2000 VLIGHT_AU
        JPLEphem AberrationOrder ApparentPosition BodyGeometry EphemerisConfig
        EphemerisEntry EphemerisMode EphemerisRequest EphemerisResult
        FullOrbitResultExt ObserverRequest Position Geometry Combined
        fit_full_iod fit_full_iod_parallel fit_iod fit_lsq
        DifferentialCorrectionConfig DifferentialCorrectionOutput
        ObsDataset ErrorModel Observer Ut1Provider
        """.split()
        missing = [n for n in names if not hasattr(ot, n)]
        assert not missing, missing
        # __dir__ lists the facade
        assert "fit_full_iod" in dir(ot)
        # unknown names still raise
        import pytest as _pytest

        with _pytest.raises(AttributeError):
            ot.no_such_symbol


class TestSmallSurfaces:
    """Direct tests for small public functions previously exercised only
    indirectly (found by a tests-reference sweep)."""

    def test_angle_helpers(self):
        import jax.numpy as jnp

        from outfit_tpu.kepler.angles import angle_diff, principal_angle

        tau = 2 * np.pi
        x = np.array([-0.1, 0.0, 1.0, tau, tau + 0.5, -7.0])
        w = np.asarray(principal_angle(jnp.asarray(x)))
        assert ((0 <= w) & (w < tau)).all()
        np.testing.assert_allclose(np.mod(w - x, tau), 0.0, atol=1e-12)
        d = np.asarray(angle_diff(jnp.float64(0.1), jnp.float64(tau - 0.1)))
        assert d == pytest.approx(0.2) or d == pytest.approx(-0.2)
        assert abs(d) <= np.pi

    def test_rad_arcsec_roundtrip(self):
        from outfit_tpu.conversion import arcsec_to_rad, rad_to_arcsec

        x = 1.2345
        assert float(rad_to_arcsec(arcsec_to_rad(x))) == pytest.approx(x, rel=1e-14)

    def test_fmt_ss_matches_time_scales(self):
        from outfit_tpu.conversion import fmt_ss

        # reference doc oracle (time.rs): fmt_ss(5.1234, 3) == "05.123"
        assert fmt_ss(5.1234, 3) == "05.123"

    def test_iso_formatting(self):
        from outfit_tpu.time.scales import iso_tt_from_mjd, iso_utc_from_mjd_tt

        # MJD 59215.0 TT == 2021-01-01T00:00:00 TT (time.rs doc oracle epoch)
        assert iso_tt_from_mjd(59215.0, 3) == "2021-01-01T00:00:00.000 TT"
        # TT -> UTC shifts by 69.184 s in 2021 (TT-TAI 32.184 + 37 leap)
        utc = iso_utc_from_mjd_tt(59215.0, 3)
        assert utc.startswith("2020-12-31T23:58:50.816")

    def test_gm_table_reference_values(self):
        """GM values in AU^3/day^2 vs planet_gm.rs:29-56 (DE440 km^3/s^2
        constants through the same unit conversion)."""
        from outfit_tpu.constants import AU, SECONDS_PER_DAY, GAUSS_GRAV_SQUARED
        from outfit_tpu.ephem.bodies import Body, gm_au3_day2

        k = SECONDS_PER_DAY**2 / AU**3
        assert gm_au3_day2(Body.SUN) == pytest.approx(1.32712440041e11 * k, rel=1e-9)
        assert gm_au3_day2(Body.JUPITER_BARY) == pytest.approx(1.267127648e8 * k, rel=1e-9)
        assert gm_au3_day2(Body.MOON) == pytest.approx(4.902800066e3 * k, rel=1e-9)
        # planet_gm.rs:86: GM_SUN within 1e-4 relative of Gauss k^2
        assert gm_au3_day2(Body.SUN) == pytest.approx(GAUSS_GRAV_SQUARED, rel=1e-4)

    def test_pad_to_multiple_and_replicate(self):
        import jax
        import jax.numpy as jnp

        from outfit_tpu.parallel import data_mesh
        from outfit_tpu.parallel.sharding import pad_to_multiple, replicate

        assert pad_to_multiple(10, 8) == 16
        assert pad_to_multiple(16, 8) == 16
        assert pad_to_multiple(1, 8) == 8
        mesh = data_mesh(jax.devices()[:2])
        r = replicate(mesh, jnp.ones((3, 3)))
        assert r.shape == (3, 3)

    def test_select_rms_interval_batch_matches_scalar(self):
        import jax.numpy as jnp

        from outfit_tpu.iod.triplets import (
            select_rms_interval,
            select_rms_interval_batch,
        )

        rng = np.random.default_rng(5)
        for extf, dtmax in ((-1.0, 30.0), (0.3, 30.0), (0.1, -1.0)):
            epochs = np.sort(rng.uniform(0, 120, 17))
            i, k = 4, 11
            s, e = select_rms_interval(epochs, i, k, extf, dtmax)
            i_start, i_end = select_rms_interval_batch(
                epochs, np.array([i]), np.array([k]), extf, dtmax
            )
            assert (int(i_start[0]), int(i_end[0])) == (s, e)

    def test_cometary_to_equinoctial_and_jacobian(self):
        """cometary -> equinoctial conversion (cometary_element.rs:418 chain
        rule) round-trips through keplerian and matches jax.jacfwd."""
        import jax
        import jax.numpy as jnp

        from outfit_tpu.elements.types import (
            CometaryElements,
            cometary_to_equinoctial,
            cometary_to_keplerian,
            jacobian_cometary_to_equinoctial,
            keplerian_to_equinoctial,
        )

        com = CometaryElements(
            *map(jnp.float64, (57000.0, 0.8, 1.7, 0.4, 1.1, 2.0, 0.3))
        )
        eq = cometary_to_equinoctial(com)
        eq2 = keplerian_to_equinoctial(cometary_to_keplerian(com))
        for a, b in zip(eq[1:], eq2[1:]):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-12, atol=1e-12)

        J = np.asarray(jacobian_cometary_to_equinoctial(com))

        def f(v):
            c = CometaryElements(com.reference_epoch, *[v[i] for i in range(6)])
            e = cometary_to_equinoctial(c)
            return jnp.stack(list(e[1:]))

        v0 = jnp.asarray([float(x) for x in com[1:]])
        J_ad = np.asarray(jax.jacfwd(f)(v0))
        np.testing.assert_allclose(J, J_ad, rtol=1e-8, atol=1e-10)


class TestPackForFetch:
    """Single-buffer result fetch (utils/fetch.py): pack/unpack must
    round-trip every production dtype bit-exactly — the fused-fit
    finalize paths rely on it for bitwise-identical results."""

    def test_roundtrip_mixed_dtypes_bitexact(self):
        import jax

        from outfit_tpu.utils.fetch import pack_for_fetch, unpack_fetched

        rng = np.random.default_rng(0)
        f64 = rng.standard_normal((7, 6))
        f64[0, 0] = np.nan
        f64[1, 1] = np.inf
        f64[2, 2] = -np.inf
        f64[3, 3] = -0.0
        tree = (
            [
                (
                    jax.device_put(f64),
                    jax.device_put(rng.standard_normal(5).astype(np.float32)),
                ),
                (jax.device_put(np.array([0, 1, -3, 2**31 - 1], np.int32)),),
            ],
            [
                (
                    jax.device_put(np.array([True, False, True])),
                    jax.device_put(np.arange(4, dtype=np.int64)),
                )
            ],
        )
        packed, spec = pack_for_fetch(tree)
        assert packed is not None
        out = unpack_fetched(jax.device_get(packed), spec)
        ref = jax.tree_util.tree_map(np.asarray, tree)
        for a, b in zip(
            jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(ref)
        ):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)

    def test_empty_tree_falls_back(self):
        from outfit_tpu.utils.fetch import pack_for_fetch, unpack_fetched

        packed, spec = pack_for_fetch([])
        assert packed is None
        assert unpack_fetched(np.empty(0), spec) == []

    def test_zero_size_leaves(self):
        import jax

        from outfit_tpu.utils.fetch import pack_for_fetch, unpack_fetched

        tree = [jax.device_put(np.empty((0, 3))), jax.device_put(np.ones(2))]
        packed, spec = pack_for_fetch(tree)
        out = unpack_fetched(jax.device_get(packed), spec)
        assert out[0].shape == (0, 3)
        np.testing.assert_array_equal(out[1], np.ones(2))


class TestCompileCache:
    """utils/compile_cache.py: $JAX_COMPILATION_CACHE_DIR is used exactly
    when set; otherwise the cache sits at a fixed path in the checkout."""

    _PROBE = (
        "import jax; from outfit_tpu.utils.compile_cache import "
        "enable_compile_cache as e; d = e(); "
        "print(d); print(jax.config.jax_compilation_cache_dir)"
    )

    def _run(self, env_update, drop=()):
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = {k: v for k, v in os.environ.items() if k not in drop}
        env.update(env_update, JAX_PLATFORMS="cpu")
        p = subprocess.run(
            [sys.executable, "-c", self._PROBE], env=env, cwd=repo,
            capture_output=True, text=True, timeout=120,
        )
        assert p.returncode == 0, p.stderr[-2000:]
        returned, configured = p.stdout.split()[-2:]
        assert returned == configured
        return repo, returned

    def test_env_var_is_used_exactly(self, tmp_path):
        want = str(tmp_path / "given" / "cache")
        _, got = self._run({"JAX_COMPILATION_CACHE_DIR": want})
        assert got == want
        assert os.path.isdir(want)
        assert os.listdir(tmp_path / "given") == ["cache"]

    def test_default_is_fixed_path_in_checkout(self):
        drop = ("JAX_COMPILATION_CACHE_DIR",)
        repo, a = self._run({}, drop)
        _, b = self._run({}, drop)
        assert a == b
        assert a.startswith(os.path.join(repo, ".jax_cache") + os.sep)
