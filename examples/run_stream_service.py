"""Pipelined fitting service: a stream of survey batches through
``fit_lsq_stream`` (host prep of batch N+1 overlaps device execution of
batch N).

Parity: the production operating mode behind
``examples/run_full_iod_parallel.rs:71-210`` — a long-running process
consuming dataset chunks and emitting per-trajectory orbits with
success/error accounting — expressed as a two-stage pipeline over the
device queue instead of a rayon worker pool.

Usage:
    python examples/run_stream_service.py [--batches N] [--traj-per-batch N]
"""

import argparse
import sys
import time
from collections import Counter

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=4)
    # 8192 is the production batch shape: every new batch shape costs a
    # one-time compilation (cached persistently afterwards), so keep
    # batch shapes uniform
    ap.add_argument("--traj-per-batch", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=42)
    # tiered service mode: a lean IOD profile streams every batch and the
    # rare failures are re-fit with a rich profile in batched passes
    # (fit_lsq_stream_escalating)
    ap.add_argument("--escalate", action="store_true")
    args = ap.parse_args()

    import bench  # synthetic survey workload builders
    from outfit_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from outfit_tpu.ephem import JPLEphem
    from outfit_tpu.iod.params import IODParams
    from outfit_tpu.lsq import (
        DifferentialCorrectionConfig,
        fit_lsq_stream,
        fit_lsq_stream_escalating,
    )

    eph = JPLEphem.analytic(53500.0, 61500.0)
    iod_params = IODParams(
        n_noise_realizations=3, precision="mixed", max_triplets=2
    )
    cfg = DifferentialCorrectionConfig(
        precision="mixed", divergence_grace_iterations=2,
        max_newton_iterations=4, prewarm_max_iterations=16,
    )

    def batches():
        for i in range(args.batches):
            yield bench.synthetic_dataset(
                args.traj_per_batch, 12, eph, seed=1000 + i
            )

    outcomes = Counter()
    quality = []
    n_done = 0
    t0 = time.time()
    if args.escalate:
        rich = IODParams(
            n_noise_realizations=7, precision="mixed", max_triplets=8
        )
        stream = fit_lsq_stream_escalating(
            batches(), eph, [(iod_params, cfg), (rich, cfg)],
            seed=args.seed, as_table=False,
        )
    else:
        stream = fit_lsq_stream(
            batches(), eph, iod_params, cfg, seed=args.seed
        )
    for i, (ds, results) in enumerate(stream):
        for r in results.values():
            if not r.ok:
                outcomes[f"error:{(r.error or '?').split('(')[0]}"] += 1
            elif r.fell_back_to_iod:
                outcomes["IOD-fallback"] += 1
                quality.append(r.orbit_quality)
            else:
                outcomes["LSQ"] += 1
                quality.append(r.orbit_quality)
        n_done += len(results)
        dt = time.time() - t0
        print(
            f"batch {i}: {len(results)} trajectories "
            f"(cumulative {n_done} in {dt:.1f}s = {n_done/dt:.0f} fits/s)",
            flush=True,
        )

    print("\noutcomes:")
    for k, v in outcomes.most_common():
        print(f"  {v:7d}  {k}")
    if quality:
        import numpy as np

        q = np.asarray(quality)
        print(
            f"quality: min={q.min():.4f} median={np.median(q):.4f} "
            f"max={q.max():.4f}"
        )


if __name__ == "__main__":
    main()
