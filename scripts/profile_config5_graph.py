"""Decompose the config-5 graph stage with the
existing TPU_EULER_FINE_TIMERS hooks + per-substep D2H fences.

Counting runs first (arena path, ~2 min warm) from the cached sim codes
(scratch/, written by profile_config5_count.py), then the graph phase runs
with a hard sync between substeps so each timer is honest.

Usage: python scripts/profile_config5_graph.py [--bp 100000000] [--out F]
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bp", type=int, default=100_000_000)
    ap.add_argument("--out", default="")
    ap.add_argument("--cache-dir", default="scratch")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from profile_config5_count import get_codes

    import jax

    from tpu_euler.config import AssemblyConfig
    from tpu_euler.pipeline.assemble import count_spectrum, spectrum_to_contigs

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
    acc, _ = count_spectrum(codes, cfg, t)
    t_count = time.perf_counter() - t0

    # sub-split the walk by monkey-timing the unitigs entry points
    import tpu_euler.euler.unitigs as un

    walk_t: dict = {}
    for name in ("transition_keys_spec", "chains_from_t"):
        orig = getattr(un, name)

        def wrap(*a, _orig=orig, _name=name, **kw):
            s = time.perf_counter()
            r = _orig(*a, **kw)
            l = jax.tree_util.tree_leaves(r)[0]
            # index, don't ravel: an eager ravel of a [E, 3] array copies
            # into the padded T(8,128) layout (108 GB at config-5 shapes)
            np.asarray(jax.device_get(l[(0,) * l.ndim]))
            walk_t[_name] = walk_t.get(_name, 0.0) + time.perf_counter() - s
            return r

        setattr(un, name, wrap)

    t0 = time.perf_counter()
    holder = [acc]
    del acc
    contigs, n_cut = spectrum_to_contigs(holder, cfg, t)
    t_graph_extract = time.perf_counter() - t0

    rec = {
        "bp": args.bp,
        "count_s": round(t_count, 2),
        "graph_extract_s": round(t_graph_extract, 2),
        "contigs": len(contigs),
        "n_cut": n_cut,
        "stage_timers": {k2: round(v, 3) for k2, v in t.items()
                         if not any(c.isdigit() for c in k2)},
        "graph_build_s": round(t.get("graph_build", -1), 3),
        "walk_split": {k2: round(v, 3) for k2, v in walk_t.items()},
    }
    print(json.dumps(rec, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
