"""Accuracy check: frame-table interpolated observer cache vs the direct
GMST/nutation/rotpn chain.  Run on CPU (f64)."""

import os
import sys

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    jax.config.update("jax_enable_x64", True)
    from outfit_tpu.ephem import JPLEphem
    from outfit_tpu.frames import equequ
    from outfit_tpu.observations import ObsDataset
    from outfit_tpu.observer.cache import ObserverCache
    from outfit_tpu.observer.geometry import (
        earth_fixed_position,
        earth_fixed_velocity,
        helio_position,
        pvobs,
    )
    from outfit_tpu.time import gmst
    from outfit_tpu.time.scales import Ut1Provider

    eph = JPLEphem.analytic(53500.0, 61500.0)
    ds = ObsDataset.from_mpc_80_col("tests/data/2015AB.obs")
    ut1 = Ut1Provider()
    c = ObserverCache.build(ds, eph, ut1)
    fp = np.stack([np.asarray(earth_fixed_position(o)) for o in ds.observers])[
        ds.observer_index
    ]
    fv = np.stack([np.asarray(earth_fixed_velocity(o)) for o in ds.observers])[
        ds.observer_index
    ]
    tut = ut1.tt_mjd_to_ut1(ds.mjd_tt)
    g = gmst(jnp.asarray(tut)) + equequ(jnp.asarray(ds.mjd_tt))
    gp, gv = pvobs(jnp.asarray(ds.mjd_tt), jnp.asarray(fp), jnp.asarray(fv), g)
    hp = helio_position(eph, jnp.asarray(ds.mjd_tt), gp)
    print("geo_pos err:", float(jnp.abs(c.geo_pos_ecl - gp).max()))
    print("geo_vel err:", float(jnp.abs(c.geo_vel_ecl - gv).max()))
    print("helio err:", float(jnp.abs(c.helio_pos_equ - hp).max()))


if __name__ == "__main__":
    main()
