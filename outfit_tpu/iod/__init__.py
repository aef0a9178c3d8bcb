"""Gauss initial orbit determination — batched, masked, batch-first.

Rebuilds ``src/initial_orbit_determination/`` (4.7k LoC) + ``trajectory.rs``:
triplet generation and scoring, the Gauss degree-8 polynomial pipeline with
batched Aberth-Ehrlich roots, Gibbs velocity, iterative Lagrange f-g
correction, Monte-Carlo noise realizations, RMS-scored candidate selection,
and the ``fit_iod`` / ``fit_full_iod`` user API.

Where the reference loops per (trajectory, triplet, realization, root) with
early exits, this build flattens (triplet x realization) into a lane axis and
roots into a candidate axis, runs every stage as fixed-trip masked kernels,
and reduces with argmin — the shape that vmaps, jits, and shards.
"""

from outfit_tpu.iod.params import IODParams  # noqa: F401
from outfit_tpu.iod.api import (  # noqa: F401
    FitResult,
    fit_full_iod,
    fit_full_iod_parallel,
    fit_full_iod_stream,
    fit_iod,
)
