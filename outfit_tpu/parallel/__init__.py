"""Multi-device scaling: data-parallel sharding over the lane/trajectory axes.

The reference's only parallelism is a rayon thread pool over trajectories
(``obs_dataset_api.rs:174-207``; SURVEY 2.17/5.7-5.8) — embarrassingly
parallel batch work.  The batch-first equivalent is sharding the flattened
lane batch (IOD) and the trajectory batch (LSQ) over a 1-D device mesh with
``jax.sharding``; GSPMD inserts the few gathers the kernels need, and
result reduction is a host-side argmin per trajectory (the reference's
HashMap fold/reduce analogue).
"""

from outfit_tpu.parallel.sharding import (  # noqa: F401
    auto_mesh,
    data_mesh,
    pad_to_multiple,
    replicate,
    resolve_mesh,
    shard_batch,
)
