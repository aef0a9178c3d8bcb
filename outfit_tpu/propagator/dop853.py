"""Batched adaptive DOP853 integrator (Dormand-Prince 8(5,3)).

The reference delegates to the Rust ``differential-equations`` crate
(``nbody.rs:505-523``); here the integrator is owned (SURVEY 2.11): a lane-batched, masked, adaptive-step explicit RK using Hairer's
DOP853 coefficients (taken verbatim from scipy's published tables — the
standard public data), with scipy's 5th/3rd-order combined error estimate
and standard step-size controller.

Per-lane adaptivity (SURVEY hard-part #5): every lane carries its own
(t, h, y); each while-loop trip advances all unfinished lanes in lockstep,
rejecting steps per lane.  The loop exits when all lanes reach t1 or the
step budget is exhausted (status flag).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy.integrate._ivp import dop853_coefficients as _d

_N_STAGES = int(_d.N_STAGES)  # 12
# plain numpy so the tableau unrolls into the trace as Python constants
_A = np.array(_d.A[: _N_STAGES, : _N_STAGES])
_B = np.array(_d.B)
_C = np.array(_d.C[: _N_STAGES])
_E3 = np.array(_d.E3)  # (13,)
_E5 = np.array(_d.E5)

_ORDER_ERR = 7  # error estimator order+... step exponent 1/8 per Hairer
_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0


class Dop853Result(NamedTuple):
    y: jnp.ndarray  # (..., n) final state
    status: jnp.ndarray  # (...): 0 ok, 1 step budget exhausted
    n_steps: jnp.ndarray  # accepted steps


def dop853_integrate(rhs, y0, t0, t1, rtol=1e-12, atol=1e-12, max_steps=1000):
    """Integrate dy/dt = rhs(t, y) from t0 to t1, batched over leading dims.

    ``y0`` (..., n); ``t0``/``t1`` broadcastable to (...).  ``rhs`` must be
    vectorized over the same batch shape.  Supports per-lane forward or
    backward integration (h carries the sign of t1 - t0).
    """
    y0 = jnp.asarray(y0, jnp.float64)
    batch = y0.shape[:-1]
    n = y0.shape[-1]
    t0 = jnp.broadcast_to(jnp.asarray(t0, jnp.float64), batch)
    t1 = jnp.broadcast_to(jnp.asarray(t1, jnp.float64), batch)

    span = t1 - t0
    direction = jnp.where(span >= 0, 1.0, -1.0)
    # initial step: conservative fraction of the span
    h0 = direction * jnp.maximum(jnp.abs(span) * 1e-3, 1e-8)

    class St(NamedTuple):
        t: jnp.ndarray
        y: jnp.ndarray
        h: jnp.ndarray
        done: jnp.ndarray
        failed: jnp.ndarray
        steps: jnp.ndarray
        trips: jnp.ndarray

    st0 = St(
        t=t0,
        y=y0,
        h=h0,
        done=jnp.abs(span) < 1e-14,
        failed=jnp.zeros(batch, bool),
        steps=jnp.zeros(batch, jnp.int32),
        trips=jnp.array(0),
    )

    def cond(st: St):
        return jnp.any(~st.done & ~st.failed) & (st.trips < max_steps)

    def body(st: St):
        # clip h so we do not overshoot t1
        remaining = t1 - st.t
        h = jnp.where(jnp.abs(st.h) > jnp.abs(remaining), remaining, st.h)
        h = jnp.where(st.done, 0.0, h)
        hb = h[..., None]

        # stages
        k = [rhs(st.t, st.y)]
        for s in range(1, _N_STAGES):
            acc = jnp.zeros_like(st.y)
            for j in range(s):
                a = float(_A[s, j])
                if a != 0.0:
                    acc = acc + a * k[j]
            k.append(rhs(st.t + float(_C[s]) * h, st.y + hb * acc))

        incr = jnp.zeros_like(st.y)
        for s in range(_N_STAGES):
            b = float(_B[s])
            if b != 0.0:
                incr = incr + b * k[s]
        y_new = st.y + hb * incr
        f_new = rhs(st.t + h, y_new)  # K[12] (FSAL-style extra evaluation)
        ks = k + [f_new]

        # scipy's combined 5th/3rd order error estimate
        scale = atol + rtol * jnp.maximum(jnp.abs(st.y), jnp.abs(y_new))
        err5 = jnp.zeros_like(st.y)
        err3 = jnp.zeros_like(st.y)
        for s in range(_N_STAGES + 1):
            e5 = float(_E5[s])
            e3 = float(_E3[s])
            if e5 != 0.0:
                err5 = err5 + e5 * ks[s]
            if e3 != 0.0:
                err3 = err3 + e3 * ks[s]
        err5 = err5 / scale
        err3 = err3 / scale
        e5n2 = jnp.sum(err5 * err5, axis=-1) / n
        e3n2 = jnp.sum(err3 * err3, axis=-1) / n
        denom = e5n2 + 0.01 * e3n2
        err_norm = jnp.abs(h) * e5n2 / jnp.sqrt(jnp.where(denom > 0, denom, 1.0))
        err_norm = jnp.where(denom > 0, err_norm, 0.0)

        accept = (err_norm <= 1.0) & ~st.done & ~st.failed

        factor = _SAFETY * jnp.where(
            err_norm > 0, err_norm ** (-1.0 / (_ORDER_ERR + 1)), _MAX_FACTOR
        )
        factor = jnp.clip(factor, _MIN_FACTOR, _MAX_FACTOR)
        h_next = h * factor
        # keep the sign, bound below to avoid stalling
        h_min = 1e-12 * jnp.maximum(jnp.abs(t0), jnp.abs(t1)) + 1e-13
        stalled = (~st.done) & (jnp.abs(h_next) < h_min)
        h_next = jnp.where(
            jnp.abs(h_next) < h_min, direction * h_min, h_next
        )

        t_new = jnp.where(accept, st.t + h, st.t)
        y_out = jnp.where(accept[..., None], y_new, st.y)
        done = st.done | (accept & (jnp.abs(t1 - t_new) < 1e-12))
        return St(
            t=t_new,
            y=y_out,
            h=jnp.where(st.done, st.h, h_next),
            done=done,
            failed=st.failed | stalled,
            steps=st.steps + accept.astype(jnp.int32),
            trips=st.trips + 1,
        )

    out = jax.lax.while_loop(cond, body, st0)
    status = jnp.where(out.done, 0, 1).astype(jnp.int32)
    return Dop853Result(out.y, status, out.steps)
