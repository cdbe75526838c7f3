"""Run all five SPEC benchmark configurations (BASELINE.md) at feasible scale.

Genome sizes are scaled down where the full organism doesn't fit this
environment (no network: real phiX/E.coli/yeast/worm sequences are
unavailable, and multi-host hardware is emulated with a virtual CPU mesh), but
every configuration keeps its DISTINGUISHING shape: k, error model, cutoff,
mesh/sharding mode, and key width. Each run asserts contig-set equality
against the CPU oracle.

Usage: python scripts/run_configs.py [--scale 1.0] [--out results.json]

Runs on CPU JAX with 8 virtual devices by default (the meshed configs need
2/8 devices; the conftest-style override below keeps the script on the CPU
even where a GPU is present). Pass --platform default to keep whatever
backend JAX picks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.01,
                    help="genome-size scale factor vs the SPEC organisms")
    ap.add_argument("--out", default="",
                    help="write per-config result JSON lines to this file")
    ap.add_argument("--platform", choices=["cpu", "default"], default="cpu",
                    help="cpu (default): force CPU JAX + 8 virtual devices")
    args = ap.parse_args()

    if args.platform == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")

    from tpu_euler.config import AssemblyConfig
    from tpu_euler.dist.pipeline import assemble_reads_distributed
    from tpu_euler.pipeline.assemble import assemble_reads
    from tpu_euler.reference_impl.oracle import assemble_oracle
    from tpu_euler.reference_impl.simulate import random_genome, simulate_reads
    from tpu_euler.utils.runtime import setup_compilation_cache
    from tpu_euler.verify.compare import canonical_contig_set

    setup_compilation_cache()
    s = args.scale

    def genome_of(bp):
        return random_genome(max(2000, int(bp * s)), seed=hash(bp) % 10000)

    configs = [
        dict(name="1 phiX174-scale error-free k=21 single-host",
             genome=random_genome(5386, seed=174), k=21, cov=30, err=0.0,
             min_count=1, tips=0, mesh=0, paired=False),
        dict(name="2 E.coli-scale 50x k=31 single chip",
             genome=genome_of(4_600_000), k=31, cov=50, err=0.0,
             min_count=1, tips=0, mesh=0, paired=False),
        dict(name="3 E.coli-scale errored reads + cutoff k=31",
             genome=genome_of(4_600_000), k=31, cov=40, err=0.004,
             min_count=4, tips=3, bubbles=2, mesh=0, paired=False),
        dict(name="4 yeast-scale 60x paired-end k=31 sharded 2 ways",
             genome=genome_of(12_000_000), k=31, cov=60, err=0.0,
             min_count=1, tips=0, mesh=2, paired=True),
        dict(name="5 C.elegans-scale 40x k=41 sharded 8 ways (prefix partition)",
             genome=genome_of(100_000_000), k=41, cov=40, err=0.0,
             min_count=1, tips=0, mesh=8, paired=False),
    ]

    all_ok = True
    results = []
    for c in configs:
        reads = simulate_reads(
            c["genome"], read_len=100, coverage=c["cov"], seed=42,
            error_rate=c["err"], circular=True, paired=c["paired"],
        )
        cap = 1 << max(14, (3 * len(c["genome"])).bit_length())
        cfg = AssemblyConfig(
            k=c["k"], min_count=c["min_count"], tip_rounds=c["tips"],
            bubble_rounds=c.get("bubbles", 0),
            read_batch=4096, read_len=100, spectrum_capacity=cap,
        )
        t0 = time.perf_counter()
        if c["mesh"]:
            res = assemble_reads_distributed(
                reads, cfg, n_devices=c["mesh"], shard_traversal=True
            )
        else:
            res = assemble_reads(reads, cfg)
        wall = time.perf_counter() - t0
        oracle = assemble_oracle(
            reads, c["k"], c["min_count"], tip_rounds=c["tips"],
            bubble_rounds=c.get("bubbles", 0),
        )
        ok = canonical_contig_set(res.contig_strings) == oracle
        all_ok &= ok
        rec = {
            "config": c["name"],
            "genome_bp": len(c["genome"]),
            "reads": res.n_reads,
            "contigs": len(res.contigs),
            "oracle_equal": ok,
            "wall_s": round(wall, 2),
        }
        results.append(rec)
        print(json.dumps(rec), flush=True)
    print("ALL CONFIGS:", "PASS" if all_ok else "FAIL")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"scale": s, "all_pass": all_ok, "configs": results}, f,
                      indent=2)
    return 0 if all_ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
