"""Microbench: do indices_are_sorted/unique_indices hints speed up
scatter/gather at counting scale? Decides whether the oneshot-count
postprocess keeps XLA scatters or needs a hand-written kernel.
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

T = 1 << 27  # ~134M rows (close to the 165M bench drain)
C = 1 << 23


def sync(x):
    np.asarray(jax.device_get(jax.tree_util.tree_leaves(x)[0].ravel()[0]))


def timeit(name, fn, *args):
    fn_j = jax.jit(fn)
    sync(fn_j(*args))  # compile
    t0 = time.perf_counter()
    for _ in range(3):
        sync(fn_j(*args))
    print(f"{name:48s} {(time.perf_counter() - t0) / 3 * 1e3:8.1f} ms", flush=True)


def main():
    key = jax.random.PRNGKey(0)
    # monotone destinations emulating segment ids (~C segments over T rows)
    seg = jnp.sort(jax.random.randint(key, (T,), 0, C, jnp.int32))
    iota = jnp.arange(T, dtype=jnp.int32)
    is_new = jnp.concatenate([jnp.ones((1,), jnp.bool_), seg[1:] != seg[:-1]])
    dest = jnp.where(is_new, seg, C + 1)
    sync(dest)

    def scat_plain(dest, iota):
        return jnp.full((C + 2,), 0, jnp.int32).at[dest].set(iota, mode="drop")

    def scat_sorted(dest, iota):
        return (
            jnp.full((C + 2,), 0, jnp.int32)
            .at[dest]
            .set(iota, mode="drop", indices_are_sorted=True, unique_indices=True)
        )

    timeit("scatter 134M->8M plain", scat_plain, dest, iota)
    timeit("scatter 134M->8M sorted+unique hints", scat_sorted, dest, iota)

    src = jnp.clip(jnp.cumsum(jnp.ones((C,), jnp.int32)) * (T // C), 0, T - 1)
    vals = jnp.arange(T, dtype=jnp.uint32)

    def gath_plain(vals, src):
        return vals[src]

    def gath_sorted(vals, src):
        return vals.at[src].get(indices_are_sorted=True, mode="promise_in_bounds")

    timeit("gather 8M from 134M plain", gath_plain, vals, src)
    timeit("gather 8M from 134M sorted hint", gath_sorted, vals, src)

    # the real drain composite: is_new + cumsum + bounds-scatter (oneshot)
    s0 = jnp.sort(jax.random.randint(key, (T,), 0, 1 << 30, jnp.int32).astype(jnp.uint32))

    def drain_post(s0):
        is_new = jnp.concatenate([jnp.ones((1,), jnp.bool_), s0[1:] != s0[:-1]])
        segx = jnp.cumsum(is_new.astype(jnp.int32)) - 1
        destx = jnp.where(is_new & (segx < C), segx, C + 1)
        bounds = jnp.full((C + 2,), T, jnp.int32).at[destx].set(
            jnp.arange(T, dtype=jnp.int32), mode="drop",
            indices_are_sorted=True, unique_indices=True,
        )
        return bounds

    timeit("drain postprocess (is_new+cumsum+scatter)", drain_post, s0)

    def sort2(a, b):
        return jax.lax.sort([a, b], num_keys=2)

    b0 = jax.random.randint(key, (T,), 0, 1 << 30, jnp.int32).astype(jnp.uint32)
    b1 = jax.random.bits(jax.random.PRNGKey(1), (T,), jnp.uint32)
    timeit("2-operand sort 134M", sort2, b0, b1)

    # CORRECTNESS: the hinted scatter above has interleaved drop-sentinels, so
    # its indices are NOT truly sorted — check results vs plain before trusting
    a = np.asarray(jax.jit(scat_plain)(dest, iota))
    b = np.asarray(jax.jit(scat_sorted)(dest, iota))
    print("hinted set-scatter equals plain:", bool((a[:C] == b[:C]).all()), flush=True)

    # truly-sorted alternative: scatter-MIN of iota over the monotone seg ids
    segc = jnp.minimum(seg, C)

    def scat_min_sorted(segc, iota):
        return (
            jnp.full((C + 2,), T, jnp.int32)
            .at[segc]
            .min(iota, indices_are_sorted=True)
        )

    def scat_min_plain(segc, iota):
        return jnp.full((C + 2,), T, jnp.int32).at[segc].min(iota)

    timeit("scatter-min 134M sorted-hint (true sorted)", scat_min_sorted, segc, iota)
    timeit("scatter-min 134M plain", scat_min_plain, segc, iota)
    c = np.asarray(jax.jit(scat_min_sorted)(segc, iota))
    print("scatter-min bounds equal set-scatter bounds:",
          bool((c[:C] == np.minimum(a[:C], c[:C])).all() and (c[:C] == a[:C]).all()),
          flush=True)

    # permutation scatter (node-id writeback pattern): unique but unsorted
    perm = jax.random.permutation(jax.random.PRNGKey(2), T)

    def scat_perm_plain(perm, iota):
        return jnp.zeros((T,), jnp.int32).at[perm].set(iota)

    def scat_perm_unique(perm, iota):
        return jnp.zeros((T,), jnp.int32).at[perm].set(iota, unique_indices=True)

    timeit("permutation scatter 134M plain", scat_perm_plain, perm, iota)
    timeit("permutation scatter 134M unique hint", scat_perm_unique, perm, iota)


if __name__ == "__main__":
    main()
