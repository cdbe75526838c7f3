"""Eulerian tour (R9 circuit merge) at bench scale on the chip.

Runs the full `eulerian_tour` — successor pairing, packed-state circuit
labeling, O(log C) rotation swipe merge, Wyllie rank — on the config-2 bench
dataset (4.6 Mbp, 50x, k=31, ~9.2M doubled edges), which it had only ever seen
at <=20 kbp test scale. Records wall, merge_rounds, every_edge_once, chains.

Correctness gate: every valid edge appears exactly once across tour chains
(the Euler invariant), checked on host over the full edge set.

Usage: python scripts/bench_tour.py [--bp N] [--out tour_results.json]
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

import jax
import numpy as np

from tpu_euler.config import AssemblyConfig
from tpu_euler.euler.tour import eulerian_tour
from tpu_euler.pipeline.assemble import (
    count_spectrum,
    make_graph_step,
    right_size_spectrum,
)
from tpu_euler.reference_impl.simulate import random_genome, simulate_read_codes


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bp", type=int, default=4_600_000)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    genome = random_genome(args.bp, seed=2024)
    codes = simulate_read_codes(
        genome, read_len=100, coverage=50, seed=2025, circular=True
    )
    cfg = AssemblyConfig(
        k=31, read_batch=1 << 18, read_len=100, spectrum_capacity=1 << 23
    )
    graph_step = make_graph_step(cfg.k, cfg.min_count)

    rec = {}
    for run in ("warm", "timed"):
        acc, _ = count_spectrum(codes, cfg, {})
        acc = right_size_spectrum(acc)
        g, _ = graph_step(acc)
        np.asarray(jax.device_get(g.head[0]))  # sync: time the tour alone

        t0 = time.perf_counter()
        tour = eulerian_tour(g)
        n_chains = int(tour.n_chains)  # D2H sync
        wall = time.perf_counter() - t0

        valid = np.asarray(g.edge_valid)
        in_tour = np.asarray(tour.in_tour)
        chain = np.asarray(tour.chain)
        pos = np.asarray(tour.pos)
        every_edge_once = bool((valid == in_tour).all())
        if every_edge_once:
            # positions within each chain must be a 0..len-1 permutation
            order = np.lexsort((pos[valid], chain[valid]))
            pc = pos[valid][order]
            cc = chain[valid][order]
            starts = np.r_[True, cc[1:] != cc[:-1]]
            expect = np.arange(pc.size) - np.maximum.accumulate(
                np.where(starts, np.arange(pc.size), 0)
            )
            every_edge_once = bool((pc == expect).all())
        rec = {
            "bench": "eulerian_tour R9 at bench scale (1 chip)",
            "genome_bp": args.bp,
            "edges": int(valid.sum()),
            "edge_capacity": int(valid.size),
            "tour_wall_s": round(wall, 3),
            "merge_rounds": int(tour.merge_rounds),
            "chains": n_chains,
            "every_edge_once": every_edge_once,
            "run": run,
        }
        print(json.dumps(rec), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
    return 0 if rec.get("every_edge_once") else 1


if __name__ == "__main__":
    sys.exit(main())
