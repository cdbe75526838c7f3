"""Can lax.top_k beat the 1-operand composite sort for segment-start compaction?

The oneshot drain compacts the ~C segment-start row indices out of T rows with
a composite-key sort (comp = is_new ? row : row+T) at T=165M.
top_k(T -> C_cap) could be cheaper if the backend's top_k does a partial
sort. This measures both at bench scale plus the 2-group split costs.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_euler.utils.runtime import setup_compilation_cache

setup_compilation_cache()

import jax
import jax.numpy as jnp
import numpy as np

T = 165_150_720
C_CAP = 1 << 23


def timeit(fn, *args, reps=3):
    out = fn(*args)
    np.asarray(jax.device_get(jax.tree_util.tree_leaves(out)[0].ravel()[0]))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        np.asarray(jax.device_get(jax.tree_util.tree_leaves(out)[0].ravel()[0]))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def main():
    key = jax.random.PRNGKey(0)
    # ~2.8% of rows are segment starts at bench scale
    is_new = jax.random.uniform(key, (T,)) < 0.028
    iota = jnp.arange(T, dtype=jnp.uint32)

    @jax.jit
    def composite(is_new):
        comp = jnp.where(is_new, iota, iota + jnp.uint32(T))
        (cs,) = jax.lax.sort([comp], num_keys=1)
        return cs[:C_CAP]

    @jax.jit
    def topk(is_new):
        # want the C_CAP smallest comp values -> negate for top_k (max-k)
        comp = jnp.where(is_new, iota, iota + jnp.uint32(T))
        neg = (jnp.uint32(0xFFFFFFFF) - comp).astype(jnp.int32)
        v, idx = jax.lax.top_k(neg, C_CAP)
        return idx

    r = {"composite_sort_s": round(timeit(composite, is_new), 4)}
    print(json.dumps(r), flush=True)
    try:
        r["topk_s"] = round(timeit(topk, is_new), 4)
    except Exception as e:
        r["topk_error"] = f"{type(e).__name__}: {str(e)[:200]}"
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
