"""Reference-system transformations (equatorial/ecliptic, mean/true, epochs).

Rebuilds ``src/ref_system.rs``: ``rotmt`` elementary rotations (:453-462) and
``rotpn`` (:379-411), which composes precession / nutation / obliquity
rotations between any two (system, epoch) pairs.

Batch-first design: frame *tags* (Equm/Equt/Eclm, J2000-or-of-date) are static
Python values, so the chain of elementary steps is resolved at trace time into
a fixed sequence of matrix products; epochs themselves may be traced arrays,
so one ``rotpn`` call vectorizes over a whole batch of observation epochs
(shape (...,3,3) out).  The reference instead loops at runtime per scalar.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import jax.numpy as jnp

from outfit_tpu.constants import EPS, T2000
from outfit_tpu.frames.earth_orientation import obleq, prec, rnut80


def rotmt(alpha, k: int):
    """Elementary frame rotation about axis k (0=X, 1=Y, 2=Z).

    Follows the reference/OrbFit convention (``src/ref_system.rs:453``):
    rotmt(eps, 0) maps equatorial to ecliptic coordinates, i.e.

        rotmt(a, 0) = [[1, 0, 0], [0, cos a, sin a], [0, -sin a, cos a]]

    (a *frame* rotation: coordinates of a fixed vector in a frame rotated by
    +a).  Vectorized: ``alpha`` of shape (...) gives (..., 3, 3).
    """
    a = jnp.asarray(alpha)
    c, s = jnp.cos(a), jnp.sin(a)
    one = jnp.ones_like(c)
    zero = jnp.zeros_like(c)
    if k == 0:
        rows = [[one, zero, zero], [zero, c, s], [zero, -s, c]]
    elif k == 1:
        rows = [[c, zero, -s], [zero, one, zero], [s, zero, c]]
    elif k == 2:
        rows = [[c, s, zero], [-s, c, zero], [zero, zero, one]]
    else:
        from outfit_tpu.errors import InvalidRefSystem

        raise InvalidRefSystem(f"rotmt: invalid axis index {k} (must be 0,1,2)")
    return jnp.stack(
        [jnp.stack(r, axis=-1) for r in rows], axis=-2
    )


@dataclass(frozen=True)
class RefEpoch:
    """Epoch tag: J2000 or of-date.  ``date`` may be a traced array for
    of-date epochs; J2000 is the static constant T2000."""

    date: object  # float or jnp array; T2000 for J2000
    is_j2000: bool = False

    @classmethod
    def j2000(cls) -> "RefEpoch":
        return cls(date=T2000, is_j2000=True)

    @classmethod
    def of_date(cls, mjd_tt) -> "RefEpoch":
        return cls(date=mjd_tt, is_j2000=False)


@dataclass(frozen=True)
class RefSystem:
    """Frame tag: kind in {"Equm", "Equt", "Eclm"} plus an epoch."""

    kind: str
    epoch: RefEpoch

    @classmethod
    def equm(cls, epoch: Union[RefEpoch, None] = None) -> "RefSystem":
        return cls("Equm", epoch or RefEpoch.j2000())

    @classmethod
    def equt(cls, epoch: Union[RefEpoch, None] = None) -> "RefSystem":
        return cls("Equt", epoch or RefEpoch.j2000())

    @classmethod
    def eclm(cls, epoch: Union[RefEpoch, None] = None) -> "RefSystem":
        return cls("Eclm", epoch or RefEpoch.j2000())


def _epochs_statically_equal(e1: RefEpoch, e2: RefEpoch) -> bool:
    """Static (trace-time) epoch equality, mirroring the reference's
    EPS-tolerance check (``src/ref_system.rs:384-387``).

    Epoch *values* may be traced; equality must be decidable at trace time
    because it selects which rotations to compose.  Two of-date epochs are
    considered equal only if they are the same Python object or both concrete
    floats within EPS — otherwise a precession chain through J2000 is built
    (which is exact and costs two extra matmuls if they turn out equal).
    """
    if e1.is_j2000 and e2.is_j2000:
        return True
    if e1.date is e2.date:
        return True
    try:
        return abs(float(e1.date) - float(e2.date)) <= EPS
    except TypeError:
        return False


def rotpn(src: RefSystem, dst: RefSystem):
    """Rotation matrix taking vectors from frame ``src`` to frame ``dst``.

    x_dst = R @ x_src, with R the passive (coordinate-transform) matrix that
    applies directly — no transposes at call sites.  Behavioral parity:
    ``src/ref_system.rs:379-411`` builds the same chain in nalgebra's active
    convention and the reference's consumers transpose before use
    (``src/observer_extension.rs:205-208``); here each step is the passive
    elementary matrix and later steps accumulate on the LEFT
    (R := step @ R), which is the transpose-free equivalent.

    Frame tags are static; epoch dates may be traced arrays, in which case the
    result broadcasts over their shape: (..., 3, 3).
    """
    current = src
    rotation = None  # lazily-broadcast identity

    from outfit_tpu.utils.linalg import matmul_small

    def _mul(acc, step):
        return step if acc is None else matmul_small(step, acc)

    for _ in range(20):
        if not _epochs_statically_equal(current.epoch, dst.epoch):
            # Step 1: move epoch toward destination (via Equm / J2000).
            if current.epoch.is_j2000:
                if current.kind == "Eclm":
                    # Reference parity (:252): obliquity removal uses axis 1
                    # in this branch (dead in practice; kept for parity).
                    step = rotmt(-obleq(T2000), 1)
                    current = RefSystem("Equm", current.epoch)
                elif current.kind == "Equt":
                    step = jnp.swapaxes(rnut80(T2000), -1, -2)
                    current = RefSystem("Equm", current.epoch)
                else:  # Equm @ J2000 -> precess to destination date
                    step = prec(dst.epoch.date)
                    current = RefSystem("Equm", dst.epoch)
            else:
                if current.kind == "Eclm":
                    # Reference parity (:265): same axis-1 quirk as the J2000
                    # twin above — the reference's own epoch-change arm
                    # removes obliquity about Y, not X.  Physically dubious
                    # but bit-matched; the fit/ephemeris pipelines never
                    # route an ecliptic frame across epochs (they convert
                    # system first), so the branch is dead in practice.
                    step = rotmt(-obleq(current.epoch.date), 1)
                    current = RefSystem("Equm", current.epoch)
                elif current.kind == "Equt":
                    step = jnp.swapaxes(
                        rnut80(current.epoch.date), -1, -2
                    )
                    current = RefSystem("Equm", current.epoch)
                else:  # Equm of-date -> back to J2000
                    step = jnp.swapaxes(prec(current.epoch.date), -1, -2)
                    current = RefSystem("Equm", RefEpoch.j2000())
            rotation = _mul(rotation, step)
            continue

        if current.kind == dst.kind:
            if rotation is None:
                rotation = jnp.broadcast_to(
                    jnp.eye(3), jnp.shape(jnp.asarray(current.epoch.date)) + (3, 3)
                )
            return rotation

        # Step 2: switch system kind at fixed epoch.
        d = current.epoch.date
        if current.kind == "Equt":
            step = jnp.swapaxes(rnut80(d), -1, -2)
            current = RefSystem("Equm", current.epoch)
        elif current.kind == "Eclm":
            step = rotmt(-obleq(d), 0)
            current = RefSystem("Equm", current.epoch)
        else:  # Equm -> target kind
            if dst.kind == "Equt":
                step = rnut80(d)
                current = RefSystem("Equt", current.epoch)
            else:  # Eclm
                step = rotmt(obleq(d), 0)
                current = RefSystem("Eclm", current.epoch)
        rotation = _mul(rotation, step)

    from outfit_tpu.errors import InvalidRefSystem

    raise InvalidRefSystem("rotpn: transformation did not converge in 20 iterations")
