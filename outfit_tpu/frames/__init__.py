"""Reference frames and Earth orientation (IAU 1976/1980 models).

Rebuilds ``src/earth_orientation.rs`` and ``src/ref_system.rs`` as pure
jittable, batch-friendly JAX functions.  The nutation series is table-driven
(106x5 integer multiplier matrix contracted against the fundamental arguments
— a batched multiply-reduce + trig dot) rather than the reference's hand-rolled
scalar compound-angle recurrences.
"""

from outfit_tpu.frames.earth_orientation import (  # noqa: F401
    obleq,
    nutn80,
    rnut80,
    equequ,
    prec,
)
from outfit_tpu.frames.ref_system import (  # noqa: F401
    RefEpoch,
    RefSystem,
    rotmt,
    rotpn,
)
