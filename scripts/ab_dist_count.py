"""A/B: distributed counting — legacy per-batch merge vs grouped one-shot.

A CPU-mesh A/B showing the per-batch capacity sort is gone from the
distributed hot loop. Both paths run
the same reads through assemble_reads_distributed on an 8-virtual-device CPU
mesh; the legacy path is forced with oneshot_rows=0 (the same switch the
single-chip pipeline uses). Correctness gate: identical contig sets.

Usage: python scripts/ab_dist_count.py [--reads N] [--out F.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"  # a CPU-mesh A/B even where a GPU is present
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_euler.utils.runtime import setup_compilation_cache

setup_compilation_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-bp", type=int, default=400_000)
    ap.add_argument("--coverage", type=int, default=40)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import dataclasses

    from tpu_euler.config import AssemblyConfig
    from tpu_euler.dist.pipeline import assemble_reads_distributed
    from tpu_euler.io.encode import encode_reads
    from tpu_euler.reference_impl.simulate import random_genome, simulate_reads

    genome = random_genome(args.genome_bp, seed=11)
    reads = simulate_reads(
        genome, read_len=100, coverage=args.coverage, seed=12, circular=True
    )
    codes = encode_reads(reads, 100)
    base = AssemblyConfig(
        k=31,
        read_batch=1 << 12,
        read_len=100,
        spectrum_capacity=1 << 20,
    )
    variants = {
        "grouped_oneshot": base,  # new default: buffered fills + group drains
        "legacy_per_batch": dataclasses.replace(base, oneshot_rows=0),
    }
    rec = {"genome_bp": args.genome_bp, "reads": len(reads), "variants": {}}
    contig_sets = {}
    for name, cfg in variants.items():
        res = assemble_reads_distributed(None, cfg, codes=codes)  # warm-up
        runs = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            res = assemble_reads_distributed(None, cfg, codes=codes)
            runs.append(
                {
                    "wall_s": round(time.perf_counter() - t0, 3),
                    "count_s": round(
                        res.stage_seconds["count"]
                        + res.stage_seconds.get("count_drain", 0.0),
                        3,
                    ),
                    "encode_s": round(res.stage_seconds["encode"], 3),
                }
            )
        contig_sets[name] = res.contigs
        best = min(r["count_s"] for r in runs)
        rec["variants"][name] = {
            "runs": runs,
            "best_count_s": best,
            "ns_per_window": round(best * 1e9 / res.n_kmers_counted, 1),
            "n_windows": res.n_kmers_counted,
            "n_distinct": res.n_distinct_kmers,
            "contigs": len(res.contigs),
        }
    rec["contigs_equal"] = (
        contig_sets["grouped_oneshot"] == contig_sets["legacy_per_batch"]
    )
    a = rec["variants"]["legacy_per_batch"]["best_count_s"]
    b = rec["variants"]["grouped_oneshot"]["best_count_s"]
    rec["speedup_count_stage"] = round(a / b, 2) if b else None
    print(json.dumps(rec, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0 if rec["contigs_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
