"""SPEC configs 4 and 5 at REAL scale on the real chip.

Config 4: 12 Mbp genome (S. cerevisiae scale), 60x paired-end 100 bp, k=31.
Config 5: 100 Mbp genome (C. elegans scale), 40x 100 bp, k=41 (3-limb keys).

Both exceed oneshot_rows (504M / 2.4G windows), so they exercise the grouped
streaming count path at scale.

The CPU oracle cannot replay hundreds of Mbp (pure-Python k-mer loop), so the
full-scale correctness gate is the same as bench.py's: a uniform-random genome
has unique k-mers whp (collision expectation: C(G,2)/4^k ~ 1.6e-5 at config 4,
1e-9 at config 5), so the assembly must emit EXACTLY ONE circular contig of
length G + k - 1 that spells a rotation of the genome or its revcomp (checked
base-exactly). Oracle equality for these configs' *shapes* is established at
reduced scale by scripts/run_configs.py and the integration suite.

Usage: python scripts/run_full_configs.py [--config 4|5] [--out FULLSCALE.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_euler.utils.runtime import setup_compilation_cache

setup_compilation_cache()


def spells_rotation(contig: str, genome: str) -> bool:
    """contig (len G+k-1) spells a rotation of genome or its revcomp."""
    from tpu_euler.reference_impl.simulate import rc

    G = len(genome)
    body = contig[:G]
    if len(contig) < G:
        return False
    for ref in (genome, rc(genome)):
        i = (ref + ref).find(body)
        if i >= 0:
            # wrap tail must continue the rotation
            full = (ref + ref)[i : i + len(contig)]
            if full == contig:
                return True
    return False


def run_config4():
    import numpy as np

    from tpu_euler.config import AssemblyConfig
    from tpu_euler.pipeline.assemble import assemble_codes
    from tpu_euler.reference_impl.simulate import (
        random_genome,
        simulate_paired_read_codes,
    )

    G, k, cov = 12_000_000, 31, 60
    t0 = time.perf_counter()
    genome = random_genome(G, seed=404)
    codes = simulate_paired_read_codes(
        genome, read_len=100, coverage=cov, seed=405, insert_size=300
    )
    t_sim = time.perf_counter() - t0
    cfg = AssemblyConfig(
        k=k, read_batch=1 << 18, read_len=100, spectrum_capacity=1 << 25
    )
    # warm-up pass absorbs one-time XLA compiles/loads (bench.py uses the
    # same protocol)
    warm = assemble_codes(codes, cfg)
    del warm
    t0 = time.perf_counter()
    res = assemble_codes(codes, cfg)
    wall = time.perf_counter() - t0
    contigs = list(res.contig_strings)
    ok = len(contigs) == 1 and spells_rotation(contigs[0], genome)
    return {
        "config": "4 yeast-scale FULL 12 Mbp 60x paired k=31 single chip",
        "genome_bp": G,
        "reads": res.n_reads,
        "kmers_counted": res.n_kmers_counted,
        "distinct_kmers": res.n_distinct_kmers,
        "contigs": len(contigs),
        "genome_spelled_exactly": ok,
        "wall_s": round(wall, 2),
        "sim_s": round(t_sim, 2),
        "stages_s": {k2: round(v, 3) for k2, v in res.stage_seconds.items()},
        "count_path": "grouped streaming (504M windows > oneshot_rows)",
    }


def run_config5(genome_bp: int = 100_000_000):
    import numpy as np

    from tpu_euler.config import AssemblyConfig
    from tpu_euler.pipeline.assemble import assemble_codes
    from tpu_euler.reference_impl.simulate import random_genome, simulate_read_codes

    G, k, cov = genome_bp, 41, 40
    t0 = time.perf_counter()
    genome = random_genome(G, seed=505)
    codes = simulate_read_codes(
        genome, read_len=100, coverage=cov, seed=506, circular=True
    )
    t_sim = time.perf_counter() - t0
    cfg = AssemblyConfig(
        k=k,
        read_batch=1 << 18,
        read_len=100,
        # ~G distinct k-mers (error-free sim); 1.2x margin. Not a pow2 —
        # every 120M-row capacity array at k=41 costs 3 limbs + count, and the
        # merge transient is the chip's peak allocation (round-3 OOM).
        spectrum_capacity=max(1 << 24, int(1.2 * G)),
        # n_nodes ~~ E for a connected graph; trimming the node arrays from
        # 2E to 1.15E saves ~3.3 GB at 220M doubled edges (the pipeline
        # raises if n_nodes overflows this)
        node_cap_factor=1.15,
    )
    t0 = time.perf_counter()
    try:
        warm = assemble_codes(codes, cfg)
        del warm
        t0 = time.perf_counter()
        res = assemble_codes(codes, cfg)
    except Exception as e:
        import traceback

        traceback.print_exc()
        return {
            "config": f"5 C.elegans-scale FULL {G/1e6:.0f} Mbp 40x k=41 single chip",
            "genome_bp": G,
            "error": f"{type(e).__name__}: {str(e)[:500]}",
            "wall_s": round(time.perf_counter() - t0, 2),
            "sim_s": round(t_sim, 2),
        }
    wall = time.perf_counter() - t0
    contigs = list(res.contig_strings)
    ok = len(contigs) == 1 and spells_rotation(contigs[0], genome)
    try:
        import jax

        mem = jax.local_devices()[0].memory_stats() or {}
        peak_gb = round(mem.get("peak_bytes_in_use", 0) / 2**30, 2) or None
    except Exception:
        peak_gb = None  # backend exposes no memory stats
    return {
        "config": f"5 C.elegans-scale FULL {G/1e6:.0f} Mbp 40x k=41 single chip",
        "genome_bp": G,
        "peak_hbm_gib": peak_gb,
        "reads": res.n_reads,
        "kmers_counted": res.n_kmers_counted,
        "distinct_kmers": res.n_distinct_kmers,
        "contigs": len(contigs),
        "genome_spelled_exactly": ok,
        "wall_s": round(wall, 2),
        "sim_s": round(t_sim, 2),
        "stages_s": {k2: round(v, 3) for k2, v in res.stage_seconds.items()},
        "count_path": "grouped streaming (2.4G windows > oneshot_rows)",
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="4,5")
    ap.add_argument("--bp5", type=int, default=100_000_000,
                    help="config-5 genome size (bp)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    results = []
    for c in args.config.split(","):
        if c.strip() == "4":
            rec = run_config4()
        elif c.strip() == "5":
            rec = run_config5(args.bp5)
        else:
            continue
        results.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        payload = {"results": results}
        if os.path.exists(args.out):
            try:
                payload = json.load(open(args.out))
                payload.setdefault("results", []).extend(results)
            except Exception:
                payload = {"results": results}
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
    bad = [r for r in results if not r.get("genome_spelled_exactly")]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
