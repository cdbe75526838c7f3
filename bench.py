"""Headline benchmark: SPEC config 2 — E. coli-scale assembly on one GPU.

Assembles a 4.6 Mbp genome from 50x 100 bp error-free reads at k=31 and
prints ONE JSON line:

    {"metric": ..., "value": N, "unit": "s", "detail": {...}}

It refuses to run unless JAX's default backend is a GPU, and names the card
(nvidia-smi name and power limit) and the JAX devices in ``detail``.

Correctness gate: the random 4.6 Mbp genome has (whp) unique 31-mers, so the
assembly must produce exactly ONE circular contig of length G + k - 1; the bench
fails loudly otherwise. Compile time is excluded via a warm-up run at identical
shapes.
"""

from __future__ import annotations

import json
import sys
import time

GENOME_BP = 4_600_000
COVERAGE = 50
READ_LEN = 100
K = 31
SEED = 2024


def main() -> int:
    from tpu_euler.utils.runtime import card_info, require_gpu, setup_compilation_cache

    require_gpu()
    cache_dir = setup_compilation_cache()

    import numpy as np

    from tpu_euler.config import AssemblyConfig
    from tpu_euler.pipeline.assemble import assemble_codes
    from tpu_euler.reference_impl.simulate import random_genome, simulate_read_codes

    genome = random_genome(GENOME_BP, seed=SEED)
    codes = simulate_read_codes(
        genome, read_len=READ_LEN, coverage=COVERAGE, seed=SEED + 1, circular=True
    )
    cfg = AssemblyConfig(
        k=K,
        read_batch=1 << 18,
        read_len=READ_LEN,
        spectrum_capacity=1 << 23,
    )

    # Per-repetition wall timestamps + compilation-cache file deltas: a timed
    # repetition that adds cache files compiled inside the window.
    import glob
    import os

    import jax

    def cache_files() -> int:
        try:
            return len(glob.glob(os.path.join(cache_dir, "*")))
        except OSError:
            return -1

    # Warm-up on the FULL dataset: the graph stage right-sizes its arrays from
    # the live key count, so only a full-size run compiles the exact shapes the
    # timed run uses (a slice would right-size differently). The timed runs then
    # measure execution, not compilation.
    warm = assemble_codes(codes, cfg)
    del warm

    # Best-of-N with per-run stage splits: the run list lets any two captures
    # be reconciled against their stated variance.
    import gc

    runs = []
    diags = []
    reps = int(os.environ.get("TPU_EULER_BENCH_REPS", "3"))
    for _ in range(reps):
        # drop run-to-run garbage before timing: dead device buffers from the
        # previous rep otherwise free lazily DURING the next rep's drain
        gc.collect()
        c0 = cache_files()
        stamp = time.time()
        t0 = time.perf_counter()
        result = assemble_codes(codes, cfg)
        wall = time.perf_counter() - t0
        diags.append(
            {
                "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(stamp)),
                "new_cache_files": cache_files() - c0,
            }
        )
        runs.append((wall, result))

    contigs = list(runs[-1][1].contigs)
    ok = len(contigs) == 1 and len(contigs[0]) == GENOME_BP + K - 1
    if not ok:
        print(
            json.dumps(
                {
                    "metric": "wall_clock_4.6Mbp_50x_k31_1chip",
                    "value": None,
                    "unit": "s",
                    "error": f"correctness gate failed: {len(contigs)} contigs, "
                    f"lens {[len(c) for c in contigs[:3]]}",
                }
            )
        )
        return 1

    walls = [w for w, _ in runs]
    wall, result = min(runs, key=lambda r: r[0])
    mean = sum(walls) / len(walls)
    sd = (sum((w - mean) ** 2 for w in walls) / len(walls)) ** 0.5
    kmers_per_s = result.n_kmers_counted / wall
    print(
        json.dumps(
            {
                "metric": "wall_clock_4.6Mbp_50x_k31_1chip",
                "value": round(wall, 3),
                "unit": "s",
                "detail": {
                    "card": card_info(),
                    "device": {
                        "platform": jax.devices()[0].platform,
                        "kind": jax.devices()[0].device_kind,
                        "count": len(jax.devices()),
                    },
                    "best_of": len(runs),
                    "wall_mean_s": round(mean, 3),
                    "wall_sd_s": round(sd, 3),
                    "runs": [
                        {
                            "wall_s": round(w, 3),
                            "stages_s": {
                                k: round(v, 3)
                                for k, v in r.stage_seconds.items()
                            },
                            **d,
                        }
                        for (w, r), d in zip(runs, diags)
                    ],
                    "reads": result.n_reads,
                    "kmers_counted": result.n_kmers_counted,
                    "distinct_kmers": result.n_distinct_kmers,
                    "kmers_per_s_per_chip": round(kmers_per_s),
                    "reads_per_s": round(result.n_reads / wall),
                    "stages_s": {k: round(v, 3) for k, v in result.stage_seconds.items()},
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
