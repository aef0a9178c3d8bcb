"""Observation ingestion and error models (photom-crate equivalent).

The reference consumes an external crate ``photom`` for MPC 80-column / ADES
parsing, the observer catalog, astrometric error models, and batch RMS
correction (SURVEY 2.12).  This package re-provides that surface:

* :mod:`mpc80` — MPC 80-column parser,
* :mod:`ades` — ADES XML parser,
* :mod:`observatories` — MPC observatory catalog (embedded subset +
  ObsCodes.html parser),
* :mod:`error_model` — FCCT14-style per-station astrometric errors + batch
  RMS correction,
* :mod:`debias` — star-catalog astrometric debiasing from the published
  Eggl et al. (2020) HEALPix tables (``$OUTFIT_DEBIAS``),
* :mod:`dataset` — the ObsDataset container (struct-of-arrays, device-ready).
"""

from outfit_tpu.observations.dataset import ObsDataset, Observation  # noqa: F401
from outfit_tpu.observations.observatories import Observer, get_observatory  # noqa: F401
from outfit_tpu.observations.error_model import ErrorModel  # noqa: F401
from outfit_tpu.observations.debias import DebiasTable  # noqa: F401
