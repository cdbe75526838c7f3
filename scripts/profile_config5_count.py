"""Decompose the config-5 count_drain, the largest stage of the full-scale wall.

Runs the counting stage ONLY (no graph/extract) at full
config-5 scale with TPU_EULER_FINE_TIMERS per-group splits — alloc wait,
fill-completion sync (H2D + extract), group sort+reduce, lean merge —
and commit the per-group breakdown so the dominant term is measured, not
guessed.

Simulated read codes are cached to scratch/ (4 GB npy, memmap-loaded) so
repeat profiling runs skip the ~200 s simulation.

Usage: python scripts/profile_config5_count.py [--bp 100000000] [--out F.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ["TPU_EULER_FINE_TIMERS"] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_euler.utils.runtime import setup_compilation_cache

setup_compilation_cache()

import numpy as np


def get_codes(bp: int, cache_dir: str):
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"c5_codes_{bp}.npy")
    gpath = os.path.join(cache_dir, f"c5_genome_{bp}.txt")
    if os.path.exists(path) and os.path.exists(gpath):
        return np.load(path, mmap_mode="r"), open(gpath).read()
    from tpu_euler.reference_impl.simulate import (
        random_genome,
        simulate_read_codes,
    )

    t0 = time.perf_counter()
    genome = random_genome(bp, seed=505)
    codes = simulate_read_codes(
        genome, read_len=100, coverage=40, seed=506, circular=True
    )
    print(f"sim {time.perf_counter() - t0:.1f}s", flush=True)
    np.save(path, codes)
    with open(gpath, "w") as f:
        f.write(genome)
    return np.load(path, mmap_mode="r"), genome


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bp", type=int, default=100_000_000)
    ap.add_argument("--out", default="")
    ap.add_argument("--cache-dir", default="scratch")
    args = ap.parse_args()

    from tpu_euler.config import AssemblyConfig
    from tpu_euler.pipeline.assemble import count_spectrum

    codes, _ = get_codes(args.bp, args.cache_dir)
    cfg = AssemblyConfig(
        k=41,
        read_batch=1 << 18,
        read_len=100,
        spectrum_capacity=max(1 << 24, int(1.2 * args.bp)),
        node_cap_factor=1.15,
    )
    t: dict = {}
    t0 = time.perf_counter()
    acc, n_windows = count_spectrum(codes, cfg, t)
    import jax

    jax.block_until_ready(acc.limbs)
    wall = time.perf_counter() - t0
    n_distinct = int(acc.n)

    groups = {}
    for key, v in sorted(t.items()):
        for pref in ("alloc_g", "fill_sync_g", "h2d_mb_g", "drain_sort_g",
                     "drain_merge_g", "drain_g"):
            if key.startswith(pref):
                gi = int(key[len(pref):])
                groups.setdefault(gi, {})[pref.rstrip("g").rstrip("_")] = (
                    round(v, 3) if pref != "h2d_mb_g" else v
                )
    rec = {
        "bp": args.bp,
        "wall_s": round(wall, 2),
        "n_windows": n_windows,
        "n_distinct": n_distinct,
        "totals": {
            k2: round(v, 3)
            for k2, v in t.items()
            if not any(c.isdigit() for c in k2)
        },
        "per_group": [
            {"g": gi, **groups[gi]} for gi in sorted(groups)
        ],
        "sums": {
            "alloc": round(sum(v for k2, v in t.items() if k2.startswith("alloc_g")), 2),
            "fill_sync": round(sum(v for k2, v in t.items() if k2.startswith("fill_sync_g")), 2),
            "sort": round(sum(v for k2, v in t.items() if k2.startswith("drain_sort_g")), 2),
            "merge": round(sum(v for k2, v in t.items() if k2.startswith("drain_merge_g")), 2),
            "arena_drain": round(sum(v for k2, v in t.items() if k2.startswith("drain_g")), 2),
        },
    }
    print(json.dumps(rec, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
