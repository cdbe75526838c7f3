"""Fine-grained graph-stage profiler at bench scale (one device).

Replays bench.py's config-2 pipeline but times each sub-step of the graph
stage separately (forced D2H sync after each). Run twice internally: warm-up
then timed.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_euler.utils.runtime import setup_compilation_cache

setup_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpu_euler.config import AssemblyConfig  # noqa: E402
from tpu_euler.euler import ranking  # noqa: E402
from tpu_euler.euler.extract import chains_to_contigs_device  # noqa: E402
from tpu_euler.euler.unitigs import (  # noqa: E402
    _apply_cut,
    _chains_from_rank,
    successor,
    transition_keys,
)
from tpu_euler.pipeline.assemble import (  # noqa: E402
    count_spectrum,
    make_graph_step,
    right_size_spectrum,
)
from tpu_euler.reference_impl.simulate import (  # noqa: E402
    random_genome,
    simulate_read_codes,
)

GENOME_BP = 4_600_000
K = 31


def sync(x):
    """Force completion: D2H one element."""
    leaf = jax.tree_util.tree_leaves(x)[0]
    np.asarray(jax.device_get(leaf.ravel()[0] if leaf.ndim else leaf))


def main():
    genome = random_genome(GENOME_BP, seed=2024)
    codes = simulate_read_codes(
        genome, read_len=100, coverage=50, seed=2025, circular=True
    )
    cfg = AssemblyConfig(
        k=K, read_batch=1 << 18, read_len=100, spectrum_capacity=1 << 23
    )
    graph_step = make_graph_step(cfg.k, cfg.min_count)

    for run in ("warm", "timed"):
        t: dict = {}
        acc, _ = count_spectrum(codes, cfg, {})
        acc = right_size_spectrum(acc)
        sync(acc.limbs)

        t0 = time.perf_counter()
        g, cut = graph_step(acc)
        sync(g.head)
        t["build_graph"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        succ0 = successor(g, cfg.k)
        sync(succ0)
        t["successor"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        tk = transition_keys(g, succ0, cfg.k)
        sync(tk)
        t["transition_keys"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        res = ranking.cycle_min_ruling_tables(succ0, g.edge_valid, tk)
        if res is None:
            print("cycle_min_ruling fell back (gid overflow); doubling path "
                  "would run instead — nothing ruling-set to profile", flush=True)
            return
        on_cycle, cyc_min, owner_off, tabs, succ_c = res
        sync(on_cycle)
        t["cycle_min_ruling"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        succ, is_cut = _apply_cut(succ0, tk, on_cycle, cyc_min)
        sync(succ)
        t["apply_cut"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        rr = ranking.rank_chains_with_cut(
            succ, g.edge_valid, is_cut, owner_off, tabs, succ_c
        )
        if rr is None:
            print("fused rank fell back; profiling rank_chains_ruling instead",
                  flush=True)
            rr = ranking.rank_chains_ruling(succ, g.edge_valid)
        d, end_edge = rr
        sync(d)
        t["rank_with_cut"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        chains = _chains_from_rank(g.edge_valid, succ, d, end_edge, on_cycle)
        sync(chains.chain)
        t["chains_from_rank"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        contigs = chains_to_contigs_device(g, chains, cfg.k)
        t["emit"] = time.perf_counter() - t0

        print(run, {k2: round(v, 3) for k2, v in t.items()}, flush=True)
        print("  n_contigs:", len(contigs), "E:", g.head.shape[0], flush=True)


if __name__ == "__main__":
    main()
