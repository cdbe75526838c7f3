"""A/B: monolithic variadic sort vs a two-level bucket/partition counting
pass at one-shot scale.

The round-3 "redirect" of the Pallas counting kernel rested on a bitonic
ceiling argument that does not bound a radix/bucket kernel. This script
measures the actual candidates on the chip at config-2 scale (165M rows,
2 uint32 limbs):

A. monolithic: jax.lax.sort([limb0, limb1], num_keys=2) — the production
   drain sort.
B. two-level: [G, C] chunk presort (batched bitonic, log2(C)^2 passes) ->
   per-chunk bucket boundaries by searchsorted (top-b bits of limb0; bucket
   ranges stay CONTIGUOUS in key space so concatenated per-bucket sorts are
   globally sorted) -> one T-row gather into bucket-major order (run-wise
   contiguous source indices) -> per-bucket batched subsort at padded
   capacity. Wins iff the cross term 2*log2(C)*log2(cap) of the bitonic
   pass count can be bought for less than the gather's transactional cost.
C. the isolated run-contiguous gather (the data-movement pass B depends on),
   measured alone — if this alone costs ~monolithic's wall, no partition
   scheme expressible as gather/scatter can win, Pallas or not.

All candidates validated bit-identical on a small slice before timing.
Writes scripts/bucketcount_results.json.
"""

from __future__ import annotations

import functools
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

T = 165_150_720  # config-2 one-shot row count
CHUNK_LOG = 21  # presort chunk rows (2 MB/operand chunks)
BUCKET_BITS = 6  # buckets = contiguous top-b-bit key ranges


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


@jax.jit
def monolithic(a, b):
    return jax.lax.sort([a, b], num_keys=2)


@functools.partial(jax.jit, static_argnames=("bucket_bits",))
def chunk_presort_and_counts(a2, b2, bucket_bits: int):
    """Sort each chunk fully; per-chunk bucket boundary table via searchsorted."""
    sa, sb = jax.lax.sort([a2, b2], num_keys=2, dimension=1)
    # bucket of a key = top bucket_bits of limb0; boundaries[i] = first key
    # of bucket i. searchsorted per chunk over the sorted limb0 rows.
    nb = 1 << bucket_bits
    bounds = (jnp.arange(nb, dtype=jnp.uint32) << jnp.uint32(32 - bucket_bits))
    # [G, nb]: index of first row in chunk >= bounds[i]
    starts = jax.vmap(lambda row: jnp.searchsorted(row, bounds))(sa)
    return sa, sb, starts.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("chunk", "bucket_bits"))
def bucket_gather(sa, sb, starts, chunk: int, bucket_bits: int):
    """One T-row gather into bucket-major order (bucket, chunk, within)."""
    G = sa.shape[0]
    nb = 1 << bucket_bits
    Tn = G * chunk
    # run (B, g) has length len[g, B]; runs ordered bucket-major
    ends = jnp.concatenate(
        [starts[:, 1:], jnp.full((G, 1), chunk, jnp.int32)], axis=1
    )
    lens = (ends - starts).T.reshape(-1)  # [nb*G] bucket-major
    run_off = jnp.cumsum(lens) - lens  # output start of each run
    j = jnp.arange(Tn, dtype=jnp.int32)
    # run id per output row WITHOUT searchsorted (whose broadcasted-compare
    # temp OOMs at 165M queries): scatter each run's id at its start offset
    # (max keeps the last of empty-run ties, matching side="right"-1), then
    # a cumulative max fills the gaps — one O(T) int32 pass.
    nruns = lens.shape[0]
    marks = (
        jnp.zeros((Tn,), jnp.int32)
        .at[jnp.where(run_off < Tn, run_off, Tn)]
        .max(jnp.arange(nruns, dtype=jnp.int32), mode="drop")
    )
    rid = jax.lax.cummax(marks)
    g = rid % G
    Bk = rid // G
    src = g * chunk + starts[g, Bk] + (j - run_off[rid])
    flat_a = sa.reshape(-1)
    flat_b = sb.reshape(-1)
    return flat_a[src], flat_b[src], lens


@functools.partial(jax.jit, static_argnames=("cap", "bucket_bits"))
def bucket_subsort(pa, pb, lens, cap: int, bucket_bits: int):
    """Pad each bucket to ``cap`` rows (sentinel) and batch-sort buckets."""
    nb = 1 << bucket_bits
    G = lens.shape[0] // nb
    blen = lens.reshape(nb, G).sum(axis=1)
    boff = jnp.cumsum(blen) - blen
    i = jnp.arange(nb * cap, dtype=jnp.int32)
    b = i // cap
    w = i % cap
    ok = w < blen[b]
    src = jnp.clip(boff[b] + w, 0, pa.shape[0] - 1)
    SENT = jnp.uint32(0xFFFFFFFF)
    ga = jnp.where(ok, pa[src], SENT).reshape(nb, cap)
    gb = jnp.where(ok, pb[src], SENT).reshape(nb, cap)
    oa, ob = jax.lax.sort([ga, gb], num_keys=2, dimension=1)
    return oa, ob, blen


def two_level(a2, b2, cap):
    sa, sb, starts = chunk_presort_and_counts(a2, b2, BUCKET_BITS)
    pa, pb, lens = bucket_gather(sa, sb, starts, 1 << CHUNK_LOG, BUCKET_BITS)
    return bucket_subsort(pa, pb, lens, cap, BUCKET_BITS)


def validate_small():
    """Bit-identical check vs monolithic at 2^22 rows."""
    n = 1 << 22
    chunk = 1 << 16
    key = jax.random.PRNGKey(7)
    a = jax.random.bits(key, (n,), jnp.uint32)
    b = jax.random.bits(jax.random.PRNGKey(8), (n,), jnp.uint32)
    ma, mb = monolithic(a, b)
    a2 = a.reshape(-1, chunk)
    b2 = b.reshape(-1, chunk)
    sa, sb, starts = chunk_presort_and_counts(a2, b2, BUCKET_BITS)
    pa, pb, lens = bucket_gather(sa, sb, starts, chunk, BUCKET_BITS)
    cap = int(2.2 * n / (1 << BUCKET_BITS))
    oa, ob, blen = bucket_subsort(pa, pb, lens, cap, BUCKET_BITS)
    # drop sentinels, concatenate buckets
    oa_np, ob_np = np.asarray(oa), np.asarray(ob)
    bl = np.asarray(blen)
    ga = np.concatenate([oa_np[i, : bl[i]] for i in range(oa_np.shape[0])])
    gb = np.concatenate([ob_np[i, : bl[i]] for i in range(ob_np.shape[0])])
    assert np.array_equal(ga, np.asarray(ma)), "two-level != monolithic (limb0)"
    assert np.array_equal(gb, np.asarray(mb)), "two-level != monolithic (limb1)"
    print("validate_small: two-level output bit-identical to monolithic sort")


def _write(rows):
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "scripts", "bucketcount_results.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=2)
    return out


def main():
    validate_small()
    rows = []
    key = jax.random.PRNGKey(0)
    G = T >> CHUNK_LOG
    Tn = G << CHUNK_LOG  # trim to a chunk multiple (same for both candidates)
    a = jax.random.bits(key, (Tn,), jnp.uint32)
    b = jax.random.bits(jax.random.PRNGKey(1), (Tn,), jnp.uint32)

    t_mono = timeit(monolithic, a, b)
    rows.append({"candidate": "A monolithic 2-op sort", "n": Tn,
                 "wall_s": round(t_mono, 4),
                 "ns_per_row": round(t_mono / Tn * 1e9, 2)})
    print(json.dumps(rows[-1]), flush=True)

    a2 = a.reshape(G, 1 << CHUNK_LOG)
    b2 = b.reshape(G, 1 << CHUNK_LOG)
    t_pre = timeit(lambda x, y: chunk_presort_and_counts(x, y, BUCKET_BITS), a2, b2)
    rows.append({"candidate": "B1 chunk presort+counts", "n": Tn,
                 "chunk": 1 << CHUNK_LOG, "wall_s": round(t_pre, 4)})
    print(json.dumps(rows[-1]), flush=True)

    sa, sb, starts = chunk_presort_and_counts(a2, b2, BUCKET_BITS)
    t_gat = timeit(
        lambda x, y, s: bucket_gather(x, y, s, 1 << CHUNK_LOG, BUCKET_BITS),
        sa, sb, starts,
    )
    rows.append({"candidate": "C run-contiguous gather (isolated)", "n": Tn,
                 "wall_s": round(t_gat, 4),
                 "ns_per_row": round(t_gat / Tn * 1e9, 2)})
    print(json.dumps(rows[-1]), flush=True)
    _write(rows)

    t_sub = None
    try:
        pa, pb, lens = bucket_gather(sa, sb, starts, 1 << CHUNK_LOG, BUCKET_BITS)
        del sa, sb
        cap_granule = 1 << 18
        cap = -(-int(1.8 * Tn / (1 << BUCKET_BITS)) // cap_granule) * cap_granule
        t_sub = timeit(
            lambda x, y, l: bucket_subsort(x, y, l, cap, BUCKET_BITS),
            pa, pb, lens,
        )
        rows.append({"candidate": "B3 bucket subsort", "n": Tn, "cap": cap,
                     "wall_s": round(t_sub, 4)})
    except Exception as e:  # the verdict stands on A vs C either way
        rows.append({"candidate": "B3 bucket subsort", "n": Tn,
                     "error": f"{type(e).__name__}: {str(e)[:200]}"})
    print(json.dumps(rows[-1]), flush=True)

    total_b = t_pre + t_gat + (t_sub or 0.0)
    rows.append({
        "candidate": "B total two-level" + ("" if t_sub else " (subsort OOM'd; lower bound)"),
        "n": Tn,
        "wall_s": round(total_b, 4),
        "vs_monolithic": round(total_b / t_mono, 3),
        "verdict": ("two-level WINS" if total_b < t_mono and t_sub else
                    "monolithic WINS — the isolated data-movement gather "
                    "alone costs more than the whole monolithic sort"),
    })
    print(json.dumps(rows[-1]), flush=True)
    print(f"wrote {_write(rows)}")


if __name__ == "__main__":
    main()
