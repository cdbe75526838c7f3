"""Microbench: decompose the oneshot count_drain at bench scale into
its constituent ops on the real chip, and A/B candidate replacements:

  a) the 2-limb 165M-row key sort
  b) the 1-operand composite sort
  c) is_new reduction + capacity gathers
  d) hierarchical alternative: per-13M-slab sort+dedup, then a final sort of
     the concatenated (key,count) uniques (sorts ~52M instead of 165M)
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_euler.utils.runtime import setup_compilation_cache

setup_compilation_cache()

import jax
import jax.numpy as jnp
import numpy as np

T = 165_000_000  # bench drain size
C = 1 << 23
SENT = jnp.uint32(0xFFFFFFFF)


def sync(x):
    np.asarray(jax.device_get(jax.tree_util.tree_leaves(x)[0].ravel()[0]))


def timeit(name, fn, *args, reps=2):
    fn_j = jax.jit(fn)
    sync(fn_j(*args))  # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        sync(fn_j(*args))
    print(
        f"{name:52s} {(time.perf_counter() - t0) / reps * 1e3:8.1f} ms",
        flush=True,
    )


def main():
    key = jax.random.PRNGKey(0)
    # ~4.6M distinct 62-bit keys, 165M instances (bench-like distribution)
    distinct = 4_600_000
    hi = jax.random.randint(key, (distinct,), 0, 1 << 30, jnp.int32).astype(
        jnp.uint32
    )
    lo = jax.random.bits(jax.random.PRNGKey(1), (distinct,), jnp.uint32)
    idx = jax.random.randint(jax.random.PRNGKey(2), (T,), 0, distinct, jnp.int32)
    l0 = hi[idx]
    l1 = lo[idx]
    sync((l0, l1))

    def sort2(a, b):
        return jax.lax.sort([a, b], num_keys=2)

    timeit("a) 165M 2-limb sort", sort2, l0, l1)

    s0, s1 = jax.jit(sort2)(l0, l1)
    sync((s0, s1))

    def comp_sort(s0, s1):
        is_new = (s0 != jnp.roll(s0, 1)) | (s1 != jnp.roll(s1, 1))
        is_new = is_new.at[0].set(True) & (s0 != SENT)
        iota = jnp.arange(T, dtype=jnp.uint32)
        comp = jnp.where(is_new, iota, iota + jnp.uint32(T))
        (cs,) = jax.lax.sort([comp], num_keys=1)
        return cs

    timeit("b) is_new + 1-op composite sort", comp_sort, s0, s1)

    cs = jax.jit(comp_sort)(s0, s1)
    sync(cs)

    def tail(cs, s0, s1):
        b = cs[:C]
        bounds = jnp.concatenate([b.astype(jnp.int32), jnp.full((1,), T, jnp.int32)])
        counts = bounds[1:] - bounds[:-1]
        src = jnp.clip(bounds[:C], 0, T - 1)
        return s0[src], s1[src], counts

    timeit("c) capacity gathers + counts", tail, cs, s0, s1)

    # d) hierarchical: slab sorts + dedupe, final merge sort
    S = 12
    slab = T // S  # ~13.75M

    def slab_dedup(a, b):
        sa, sb = jax.lax.sort([a, b], num_keys=2)
        is_new = (sa != jnp.roll(sa, 1)) | (sb != jnp.roll(sb, 1))
        is_new = is_new.at[0].set(True)
        iota = jnp.arange(slab, dtype=jnp.uint32)
        comp = jnp.where(is_new, iota, iota + jnp.uint32(slab))
        (cs,) = jax.lax.sort([comp], num_keys=1)
        m = 6_000_000  # per-slab unique bound
        bsrc = cs[:m]
        live = bsrc < jnp.uint32(slab)
        bounds = jnp.concatenate(
            [jnp.where(live, bsrc, jnp.uint32(slab)).astype(jnp.int32),
             jnp.full((1,), slab, jnp.int32)]
        )
        counts = jnp.where(live, bounds[1:] - bounds[:-1], 0)
        src = jnp.clip(bounds[:m], 0, slab - 1)
        ua = jnp.where(live, sa[src], SENT)
        ub = jnp.where(live, sb[src], SENT)
        return ua, ub, counts

    def hier(l0, l1):
        parts = []
        for s in range(S):
            a = jax.lax.dynamic_slice(l0, (s * slab,), (slab,))
            b = jax.lax.dynamic_slice(l1, (s * slab,), (slab,))
            parts.append(slab_dedup(a, b))
        ua = jnp.concatenate([p[0] for p in parts])
        ub = jnp.concatenate([p[1] for p in parts])
        uc = jnp.concatenate([p[2] for p in parts])
        fa, fb, fc = jax.lax.sort([ua, ub, uc], num_keys=2)
        return fa[0], fb[0], fc[0]

    timeit("d) hierarchical slab-dedup + 72M final sort", hier, l0, l1, reps=1)


if __name__ == "__main__":
    main()
