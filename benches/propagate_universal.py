"""Criterion-parity benchmark scenarios for the universal Kepler kernel.

Mirrors the reference's ``benches/propagate_universal.rs`` groups:
per-regime propagation (real fink-fat state, quasi-circular, e=0.95 near
perihelion, near-parabolic +/-), solver-kind comparison (NR vs NR+fallback),
the 20-step daily-cadence warm-start chain, and isolated component costs
(prelim guess, s_funct).

Batched re-interpretation: the reference times one scalar call; production
on an accelerator runs many lanes per dispatch, so each scenario reports BOTH warm
per-dispatch latency at batch 4096 and the implied per-orbit throughput.

Usage: python benches/propagate_universal.py  (prints a table; any backend)
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np


def scenarios():
    from outfit_tpu.constants import GAUSS_GRAV_SQUARED as MU

    real_state = (
        np.array([-8.264959160036185e-1, 3.9196606084860963e-1, 2.2299196071828425e-2]),
        np.array([-5.4473671119342e-3, -2.107596146728544e-2, 1.5608111521258896e-3]),
        19.92,
    )

    def from_elems(a, e, at_peri=True, sign=1.0):
        r = a * (1 - e) if at_peri else a
        v = np.sqrt(MU * (2 / r - sign * 1 / a))
        return np.array([r, 0, 0]), np.array([0, v, 0.001 * v]), 30.0

    return {
        "real_state": real_state,
        "quasi_circular": from_elems(2.0, 1e-4),
        "high_ecc_0.95_peri": from_elems(2.0, 0.95),
        "near_parabolic_bound": from_elems(100.0, 0.9999),
        "near_parabolic_unbound": (
            np.array([0.5, 0, 0]),
            np.array([0, np.sqrt(2 * MU / 0.5) * 1.0001, 0.0]),
            30.0,
        ),
    }


def main():
    import jax
    import jax.numpy as jnp

    from outfit_tpu.kepler import propagate_universal
    from outfit_tpu.kepler.stumpff import s_funct
    from outfit_tpu.kepler.universal import (
        KeplerParams,
        SolverConfig,
        prelim_kepuni,
        solve_kepuni,
    )

    n = 4096
    print(f"backend: {jax.default_backend()}, batch: {n}")

    def timeit(f, *args, repeats=5):
        jax.block_until_ready(f(*args))
        best = min(
            _t(lambda: jax.block_until_ready(f(*args))) for _ in range(repeats)
        )
        return best

    # --- per-regime propagation + solver-kind comparison ---------------------
    for name, (r0, v0, dt) in scenarios().items():
        p = jnp.tile(jnp.asarray(r0), (n, 1))
        v = jnp.tile(jnp.asarray(v0), (n, 1))
        dts = jnp.full(n, dt)
        for kind, cfg in [
            ("auto", SolverConfig()),
            ("nr_only", SolverConfig(auto_fallback=False)),
        ]:
            f = jax.jit(lambda p, v, d, c=cfg: propagate_universal(p, v, 0.0, d, cfg=c))
            t = timeit(f, p, v, dts)
            out = f(p, v, dts)
            ok = float((np.asarray(out.status) == 0).mean())
            print(f"{name:24s} [{kind:7s}] {t*1e3:8.2f} ms/dispatch "
                  f"{n/t/1e6:6.2f} M orbits/s  converged {ok*100:5.1f}%")

    # --- 20-step daily-cadence warm-start chain ------------------------------
    r0, v0, _ = scenarios()["real_state"]
    p = jnp.tile(jnp.asarray(r0), (n, 1))
    v = jnp.tile(jnp.asarray(v0), (n, 1))

    def chain(p, v, psi0):
        psi = psi0
        for k in range(20):
            out = propagate_universal(p, v, 0.0, jnp.full(n, float(k + 1)), psi_guess=psi)
            psi = out.psi
        return out

    f_warm = jax.jit(lambda p, v: chain(p, v, jnp.zeros(n)))
    t = timeit(f_warm, p, v)
    print(f"{'20-step warm chain':24s} [warm   ] {t*1e3:8.2f} ms/dispatch "
          f"({t/20*1e3:.2f} ms/step)")

    # --- component costs ------------------------------------------------------
    psi = jnp.linspace(-20, 20, n)
    alpha = jnp.full(n, -0.45)
    t = timeit(jax.jit(s_funct), psi, alpha)
    print(f"{'s_funct':24s} [kernel ] {t*1e3:8.2f} ms/dispatch")

    params = KeplerParams(
        dt=jnp.full(n, 19.92), r0=jnp.full(n, 0.915), sig0=jnp.full(n, 0.0095),
        mu=jnp.full(n, 2.959e-4), alpha=jnp.full(n, -1.06), e0=jnp.full(n, 0.06),
    )
    t = timeit(jax.jit(prelim_kepuni), params)
    print(f"{'prelim_kepuni':24s} [kernel ] {t*1e3:8.2f} ms/dispatch")
    t = timeit(jax.jit(solve_kepuni), params)
    print(f"{'solve_kepuni':24s} [kernel ] {t*1e3:8.2f} ms/dispatch")


def _t(f):
    t0 = time.time()
    f()
    return time.time() - t0


if __name__ == "__main__":
    main()
