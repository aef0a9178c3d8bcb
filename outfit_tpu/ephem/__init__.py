"""JPL planetary ephemerides as device-resident Chebyshev tables.

Rebuilds the reference's ``src/jpl_ephem/`` (6.9k LoC): the Horizon legacy DE
binary parser, the NAIF DAF/SPK parser, and the query facade — redesigned
batch-first: file parsing is host-side numpy producing flattened, granule-
uniform coefficient arrays; interpolation is a batched gather + Chebyshev
dot that jits/vmaps over epochs.  A third, file-free source (``analytic:``)
builds the same tables from Standish mean elements + a truncated lunar
theory, so the full pipeline runs with zero network access.
"""

from outfit_tpu.ephem.bodies import Body, GM_AU3_DAY2, gm_au3_day2  # noqa: F401
from outfit_tpu.ephem.chebyshev import BodyTable, interpolate_body  # noqa: F401
from outfit_tpu.ephem.api import JPLEphem  # noqa: F401
