"""IAU-1976 precession, IAU-1980 (Wahr) nutation, mean obliquity.

Behavioral parity with the reference's ``src/earth_orientation.rs``
(obleq :119-129, nutn80 :170-423, rnut80 :459-479, equequ :508-518,
prec :561-593).  The reference evaluates the 106-term nutation series as a
hand-optimized scalar chain of compound-angle recurrences; here the series is
the standard published IAU-1980 table evaluated as

    arg   = M @ [l, l', F, D, Om]        (106x5 integer multipliers)
    dpsi  = sum((A + At*t) * sin(arg))
    deps  = sum((B + Bt*t) * cos(arg))

which vectorizes over any batch of epochs as elementwise device work.
Amplitudes are in 0.1 milliarcsec (1e-4 arcsec), as published.
"""

import jax.numpy as jnp
import numpy as np

from outfit_tpu.constants import RADEG, RADSEC, T2000

# ---------------------------------------------------------------------------
# IAU-1980 nutation series: columns (l, l', F, D, Om, A, A_t, B, B_t)
# with argument  c_l*l + c_lp*l' + c_F*F + c_D*D + c_Om*Om  and amplitudes in
# units of 1e-4 arcsec (A: sin coefficient of dpsi, B: cos coefficient of
# deps; A_t, B_t are per-Julian-century rates).  Public IAU data
# (Explanatory Supplement to the Astronomical Almanac, table 3.222.1).
# ---------------------------------------------------------------------------
_NUT_SERIES = np.array(
    [
        #  l  l'  F   D  Om        A      A_t       B     B_t
        [0, 0, 0, 0, 1, -171996.0, -174.2, 92025.0, 8.9],
        [0, 0, 0, 0, 2, 2062.0, 0.2, -895.0, 0.5],
        [-2, 0, 2, 0, 1, 46.0, 0.0, -24.0, 0.0],
        [-2, 0, 2, 0, 0, -11.0, 0.0, 0.0, 0.0],
        [-2, 0, 2, 0, 2, -3.0, 0.0, 1.0, 0.0],
        [1, -1, 0, -1, 0, -3.0, 0.0, 0.0, 0.0],
        [0, -2, 2, -2, 1, -2.0, 0.0, 1.0, 0.0],
        [2, 0, -2, 0, 1, 1.0, 0.0, 0.0, 0.0],
        [0, 0, 2, -2, 2, -13187.0, -1.6, 5736.0, -3.1],
        [0, 1, 0, 0, 0, 1426.0, -3.4, 54.0, -0.1],
        [0, 1, 2, -2, 2, -517.0, 1.2, 224.0, -0.6],
        [0, -1, 2, -2, 2, 217.0, -0.5, -95.0, 0.3],
        [0, 0, 2, -2, 1, 129.0, 0.1, -70.0, 0.0],
        [2, 0, 0, -2, 0, 48.0, 0.0, 1.0, 0.0],
        [0, 0, 2, -2, 0, -22.0, 0.0, 0.0, 0.0],
        [0, 2, 0, 0, 0, 17.0, -0.1, 0.0, 0.0],
        [0, 1, 0, 0, 1, -15.0, 0.0, 9.0, 0.0],
        [0, 2, 2, -2, 2, -16.0, 0.1, 7.0, 0.0],
        [0, -1, 0, 0, 1, -12.0, 0.0, 6.0, 0.0],
        [-2, 0, 0, 2, 1, -6.0, 0.0, 3.0, 0.0],
        [0, -1, 2, -2, 1, -5.0, 0.0, 3.0, 0.0],
        [2, 0, 0, -2, 1, 4.0, 0.0, -2.0, 0.0],
        [0, 1, 2, -2, 1, 4.0, 0.0, -2.0, 0.0],
        [1, 0, 0, -1, 0, -4.0, 0.0, 0.0, 0.0],
        [2, 1, 0, -2, 0, 1.0, 0.0, 0.0, 0.0],
        [0, 0, -2, 2, 1, 1.0, 0.0, 0.0, 0.0],
        [0, 1, -2, 2, 0, -1.0, 0.0, 0.0, 0.0],
        [0, 1, 0, 0, 2, 1.0, 0.0, 0.0, 0.0],
        [-1, 0, 0, 1, 1, 1.0, 0.0, 0.0, 0.0],
        [0, 1, 2, -2, 0, -1.0, 0.0, 0.0, 0.0],
        [0, 0, 2, 0, 2, -2274.0, -0.2, 977.0, -0.5],
        [1, 0, 0, 0, 0, 712.0, 0.1, -7.0, 0.0],
        [0, 0, 2, 0, 1, -386.0, -0.4, 200.0, 0.0],
        [1, 0, 2, 0, 2, -301.0, 0.0, 129.0, -0.1],
        [1, 0, 0, -2, 0, -158.0, 0.0, -1.0, 0.0],
        [-1, 0, 2, 0, 2, 123.0, 0.0, -53.0, 0.0],
        [0, 0, 0, 2, 0, 63.0, 0.0, -2.0, 0.0],
        [1, 0, 0, 0, 1, 63.0, 0.1, -33.0, 0.0],
        [-1, 0, 0, 0, 1, -58.0, -0.1, 32.0, 0.0],
        [-1, 0, 2, 2, 2, -59.0, 0.0, 26.0, 0.0],
        [1, 0, 2, 0, 1, -51.0, 0.0, 27.0, 0.0],
        [0, 0, 2, 2, 2, -38.0, 0.0, 16.0, 0.0],
        [2, 0, 0, 0, 0, 29.0, 0.0, -1.0, 0.0],
        [1, 0, 2, -2, 2, 29.0, 0.0, -12.0, 0.0],
        [2, 0, 2, 0, 2, -31.0, 0.0, 13.0, 0.0],
        [0, 0, 2, 0, 0, 26.0, 0.0, -1.0, 0.0],
        [-1, 0, 2, 0, 1, 21.0, 0.0, -10.0, 0.0],
        [-1, 0, 0, 2, 1, 16.0, 0.0, -8.0, 0.0],
        [1, 0, 0, -2, 1, -13.0, 0.0, 7.0, 0.0],
        [-1, 0, 2, 2, 1, -10.0, 0.0, 5.0, 0.0],
        [1, 1, 0, -2, 0, -7.0, 0.0, 0.0, 0.0],
        [0, 1, 2, 0, 2, 7.0, 0.0, -3.0, 0.0],
        [0, -1, 2, 0, 2, -7.0, 0.0, 3.0, 0.0],
        [1, 0, 2, 2, 2, -8.0, 0.0, 3.0, 0.0],
        [1, 0, 0, 2, 0, 6.0, 0.0, 0.0, 0.0],
        [2, 0, 2, -2, 2, 6.0, 0.0, -3.0, 0.0],
        [0, 0, 0, 2, 1, -6.0, 0.0, 3.0, 0.0],
        [0, 0, 2, 2, 1, -7.0, 0.0, 3.0, 0.0],
        [1, 0, 2, -2, 1, 6.0, 0.0, -3.0, 0.0],
        [0, 0, 0, -2, 1, -5.0, 0.0, 3.0, 0.0],
        [1, -1, 0, 0, 0, 5.0, 0.0, 0.0, 0.0],
        [2, 0, 2, 0, 1, -5.0, 0.0, 3.0, 0.0],
        [0, 1, 0, -2, 0, -4.0, 0.0, 0.0, 0.0],
        [1, 0, -2, 0, 0, 4.0, 0.0, 0.0, 0.0],
        [0, 0, 0, 1, 0, -4.0, 0.0, 0.0, 0.0],
        [1, 1, 0, 0, 0, -3.0, 0.0, 0.0, 0.0],
        [1, 0, 2, 0, 0, 3.0, 0.0, 0.0, 0.0],
        [1, -1, 2, 0, 2, -3.0, 0.0, 1.0, 0.0],
        [-1, -1, 2, 2, 2, -3.0, 0.0, 1.0, 0.0],
        [-2, 0, 0, 0, 1, -2.0, 0.0, 1.0, 0.0],
        [3, 0, 2, 0, 2, -3.0, 0.0, 1.0, 0.0],
        [0, -1, 2, 2, 2, -3.0, 0.0, 1.0, 0.0],
        [1, 1, 2, 0, 2, 2.0, 0.0, -1.0, 0.0],
        [-1, 0, 2, -2, 1, -2.0, 0.0, 1.0, 0.0],
        [2, 0, 0, 0, 1, 2.0, 0.0, -1.0, 0.0],
        [1, 0, 0, 0, 2, -2.0, 0.0, 1.0, 0.0],
        [3, 0, 0, 0, 0, 2.0, 0.0, 0.0, 0.0],
        [0, 0, 2, 1, 2, 2.0, 0.0, -1.0, 0.0],
        [-1, 0, 0, 0, 2, 1.0, 0.0, -1.0, 0.0],
        [1, 0, 0, -4, 0, -1.0, 0.0, 0.0, 0.0],
        [-2, 0, 2, 2, 2, 1.0, 0.0, -1.0, 0.0],
        [-1, 0, 2, 4, 2, -2.0, 0.0, 1.0, 0.0],
        [2, 0, 0, -4, 0, -1.0, 0.0, 0.0, 0.0],
        [1, 1, 2, -2, 2, 1.0, 0.0, -1.0, 0.0],
        [1, 0, 2, 2, 1, -1.0, 0.0, 1.0, 0.0],
        [-2, 0, 2, 4, 2, -1.0, 0.0, 1.0, 0.0],
        [-1, 0, 4, 0, 2, 1.0, 0.0, 0.0, 0.0],
        [1, -1, 0, -2, 0, 1.0, 0.0, 0.0, 0.0],
        [2, 0, 2, -2, 1, 1.0, 0.0, -1.0, 0.0],
        [2, 0, 2, 2, 2, -1.0, 0.0, 0.0, 0.0],
        [1, 0, 0, 2, 1, -1.0, 0.0, 0.0, 0.0],
        [0, 0, 4, -2, 2, 1.0, 0.0, 0.0, 0.0],
        [3, 0, 2, -2, 2, 1.0, 0.0, 0.0, 0.0],
        [1, 0, 2, -2, 0, -1.0, 0.0, 0.0, 0.0],
        [0, 1, 2, 0, 1, 1.0, 0.0, 0.0, 0.0],
        [-1, -1, 0, 2, 1, 1.0, 0.0, 0.0, 0.0],
        [0, 0, -2, 0, 1, -1.0, 0.0, 0.0, 0.0],
        [0, 0, 2, -1, 2, -1.0, 0.0, 0.0, 0.0],
        [0, 1, 0, 2, 0, -1.0, 0.0, 0.0, 0.0],
        [1, 0, -2, -2, 0, -1.0, 0.0, 0.0, 0.0],
        [0, -1, 2, 0, 1, -1.0, 0.0, 0.0, 0.0],
        [1, 1, 0, -2, 1, -1.0, 0.0, 0.0, 0.0],
        [1, 0, -2, 2, 0, -1.0, 0.0, 0.0, 0.0],
        [2, 0, 0, 2, 0, 1.0, 0.0, 0.0, 0.0],
        [0, 0, 2, 4, 2, -1.0, 0.0, 0.0, 0.0],
        [0, 1, 0, 1, 0, 1.0, 0.0, 0.0, 0.0],
    ]
)
assert _NUT_SERIES.shape == (106, 9)

_NUT_MULT = _NUT_SERIES[:, :5]  # (106, 5)
_NUT_A = _NUT_SERIES[:, 5]
_NUT_AT = _NUT_SERIES[:, 6]
_NUT_B = _NUT_SERIES[:, 7]
_NUT_BT = _NUT_SERIES[:, 8]

# Fundamental argument polynomials (arcsec), Delaunay arguments l, l', F, D, Om
_FUND_POLY = np.array(
    [
        [485_866.733, 1_717_915_922.633, 31.310, 0.064],  # l  (Moon anomaly)
        [1_287_099.804, 129_596_581.224, -0.577, -0.012],  # l' (Sun anomaly)
        [335_778.877, 1_739_527_263.137, -13.257, 0.011],  # F
        [1_072_261.307, 1_602_961_601.328, -6.891, 0.019],  # D
        [450_160.280, -6_962_890.539, 7.455, 0.008],  # Om
    ]
)


def obleq(tjm):
    """Mean obliquity of the ecliptic (IAU 1976), radians.  MJD(TT) in."""
    t = (jnp.asarray(tjm) - T2000) / 36525.0
    ob0 = ((23.0 * 3600.0 + 26.0 * 60.0) + 21.448) * RADSEC
    ob1 = -46.815 * RADSEC
    ob2 = -0.0006 * RADSEC
    ob3 = 0.00181 * RADSEC
    return ((ob3 * t + ob2) * t + ob1) * t + ob0


def nutn80(tjm):
    """IAU-1980 nutation angles (dpsi, deps) in ARCSECONDS.  MJD(TT) in.

    Vectorized: input shape (...) -> outputs shape (...).
    """
    t = (jnp.asarray(tjm) - T2000) / 36525.0
    tp = jnp.stack(
        [jnp.ones_like(t), t, t * t, t * t * t], axis=-1
    )  # (..., 4)
    # broadcast-multiply + reduce: `@` with contraction dims 4/5 lowers to
    # padded dot_generals (see utils.linalg)
    fund = jnp.sum(tp[..., None, :] * _FUND_POLY, -1) * RADSEC  # (..., 5)
    arg = jnp.sum(fund[..., None, :] * _NUT_MULT, -1)  # (..., 106)
    t_ = t[..., None]
    dpsi = jnp.sum((_NUT_A + _NUT_AT * t_) * jnp.sin(arg), axis=-1)
    deps = jnp.sum((_NUT_B + _NUT_BT * t_) * jnp.cos(arg), axis=-1)
    return dpsi * 1e-4, deps * 1e-4


def rnut80(tjm):
    """Nutation rotation matrix (mean equator of date -> true equator of date).

    Returns the *passive* (coordinate-transform) matrix, directly applicable
    as ``x_true = N @ x_mean``: rotate to the ecliptic (+eps_m about X), shift
    the equinox by the nutation in longitude (-dpsi about Z), rotate back to
    the true equator (-eps_true about X).

    Behavioral parity with the reference (:459-479): nalgebra there stores the
    transpose (active form) and every call site transposes before applying
    (e.g. ``src/observer_extension.rs:205-208``); this build stores the
    directly-applicable matrix instead.  Returns shape (..., 3, 3).
    """
    from outfit_tpu.frames.ref_system import rotmt

    epsm = obleq(tjm)
    dpsi, deps = nutn80(tjm)
    dpsi = dpsi * RADSEC
    epst = epsm + deps * RADSEC
    from outfit_tpu.utils.linalg import matmul_small

    return matmul_small(
        matmul_small(rotmt(-epst, 0), rotmt(-dpsi, 2)), rotmt(epsm, 0)
    )


def equequ(tjm):
    """Equation of the equinoxes (radians): dpsi * cos(eps).  MJD(TT) in."""
    oblm = obleq(tjm)
    dpsi, _ = nutn80(tjm)
    return RADSEC * dpsi * jnp.cos(oblm)


def prec(tjm):
    """IAU-1976 precession matrix from J2000 to mean equator/equinox of date.

    Passive matrix: ``x_mean(tjm) = prec(tjm) @ x_J2000`` directly (see
    :func:`rnut80` for the convention note vs the reference :561-593).
    Returns shape (..., 3, 3).
    """
    from outfit_tpu.frames.ref_system import rotmt

    t = (jnp.asarray(tjm) - T2000) / 36525.0
    zeta = ((0.0000050 * t + 0.0000839) * t + 0.6406161) * t * RADEG
    z = ((0.0000051 * t + 0.0003041) * t + 0.6406161) * t * RADEG
    theta = ((-0.0000116 * t - 0.0001185) * t + 0.5567530) * t * RADEG
    from outfit_tpu.utils.linalg import matmul_small

    return matmul_small(
        matmul_small(rotmt(-z, 2), rotmt(theta, 1)), rotmt(-zeta, 2)
    )
