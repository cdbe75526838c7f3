"""Sort-based k-mer counting and spectrum accumulation.

The reference counted l-tuples with an atomics-contended GPU hash table
(SURVEY.md R4/R5). The TPU-native design is sort-based, per BASELINE.json's
north star ("hash/radix-sort kernel"): XLA variadic sort on uint32 limb keys,
segment boundaries, and segment-sums — static shapes throughout, no atomics,
deterministic results.

A ``Spectrum`` is a capacity-padded, key-sorted array of distinct canonical
k-mers with counts. Batches of reads stream through ``count_batch`` and fold
into the running spectrum with ``merge_spectra`` (concat + sort + segment-sum),
so total memory stays bounded by ``spectrum_capacity`` regardless of read count
(SURVEY.md section 7 step 3; KMC/Gerbil-style out-of-core merging recast for HBM).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpu_euler.kmer import keys


class Spectrum(NamedTuple):
    """Sorted distinct canonical k-mers with counts, padded to capacity."""

    limbs: jax.Array  # [C, L] uint32, key-sorted among valid slots
    counts: jax.Array  # [C] int32
    n: jax.Array  # [] int32 number of valid slots


def empty_spectrum(capacity: int, nlimbs: int) -> Spectrum:
    return Spectrum(
        limbs=jnp.zeros((capacity, nlimbs), jnp.uint32),
        counts=jnp.zeros((capacity,), jnp.int32),
        n=jnp.zeros((), jnp.int32),
    )


def segment_sums_sorted(is_new, seg, weights, num_segments):
    """Per-segment weight sums for already-sorted data, WITHOUT a segment_sum.

    Exclusive-cumsum + one scatter + a shifted difference: sum of segment j is
    ecs[start(j+1)] - ecs[start(j)]. ~2x cheaper than XLA's scatter-add based
    segment_sum at spectrum scale. Unused trailing slots read 0.
    """
    w = weights
    ecs = jnp.cumsum(w) - w
    total = ecs[-1] + w[-1]
    dest = jnp.where(is_new, seg, num_segments + 1)
    bounds = (
        jnp.full((num_segments + 1,), total, w.dtype).at[dest].set(ecs, mode="drop")
    )
    return (bounds[1:] - bounds[:-1]).astype(jnp.int32)


def _unique_counts(limbs, valid, weights):
    """Shared core: sorted+deduped keys with summed weights.

    Returns (unique_limbs, unique_counts, n_unique) with arrays sized like the
    input; slots >= n_unique are garbage (mask with iota < n_unique).
    """
    M, L = limbs.shape
    sl, sv, sw = keys.sort_by_key(limbs, valid, weights)
    prev = jnp.roll(sl, 1, axis=0)
    is_new = ~keys.key_eq(sl, prev)
    is_new = is_new.at[0].set(True)
    is_new = is_new & sv
    seg = jnp.cumsum(is_new.astype(jnp.int32)) - 1  # unique index per row
    n_unique = jnp.sum(is_new.astype(jnp.int32))
    counts = segment_sums_sorted(is_new, seg, jnp.where(sv, sw, 0), M)
    # Scatter first-of-segment keys into compacted positions.
    dest = jnp.where(is_new, seg, M)  # M = out-of-bounds -> dropped
    uniq = jnp.zeros_like(sl).at[dest].set(sl, mode="drop")
    return uniq, counts, n_unique


@jax.jit
def count_batch(limbs: jax.Array, valid: jax.Array) -> Spectrum:
    """Count one batch of (canonical) k-mer keys. Output capacity = batch size."""
    M = limbs.shape[0]
    uniq, counts, n = _unique_counts(limbs, valid, jnp.ones((M,), jnp.int32))
    return Spectrum(uniq, counts, n)


@functools.partial(jax.jit, donate_argnums=(0,))
def merge_spectra(acc: Spectrum, batch: Spectrum) -> Spectrum:
    """Fold a batch spectrum into the accumulator (same-key counts add).

    Output capacity = accumulator capacity. Overflow (more distinct keys than
    capacity) must be checked by the caller via ``.n``.
    """
    C = acc.limbs.shape[0]
    limbs = jnp.concatenate([acc.limbs, batch.limbs], axis=0)
    counts = jnp.concatenate([acc.counts, batch.counts], axis=0)
    valid = jnp.concatenate(
        [
            jnp.arange(C, dtype=jnp.int32) < acc.n,
            jnp.arange(batch.limbs.shape[0], dtype=jnp.int32) < batch.n,
        ]
    )
    uniq, ucounts, n = _unique_counts(limbs, valid, counts)
    return Spectrum(uniq[:C], ucounts[:C], jnp.minimum(n, C))


@functools.partial(jax.jit, static_argnames=("min_count",))
def apply_cutoff(spec: Spectrum, min_count: int) -> Spectrum:
    """Drop k-mers with count < min_count and recompact (SURVEY.md R5).

    Keeps key-sorted order. Capacity unchanged.
    """
    C = spec.limbs.shape[0]
    iota = jnp.arange(C, dtype=jnp.int32)
    valid = iota < spec.n
    keep = valid & (spec.counts >= min_count)
    dest = jnp.cumsum(keep.astype(jnp.int32)) - 1
    dest = jnp.where(keep, dest, C)  # drop non-kept
    limbs = jnp.zeros_like(spec.limbs).at[dest].set(spec.limbs, mode="drop")
    counts = jnp.zeros_like(spec.counts).at[dest].set(spec.counts, mode="drop")
    return Spectrum(limbs, counts, jnp.sum(keep.astype(jnp.int32)))


def spectrum_overflowed(spec: Spectrum) -> bool:
    """Host-side overflow check: distinct keys hit capacity (results untrustworthy)."""
    return int(spec.n) >= spec.limbs.shape[0]


def oneshot_reduce(s: tuple, capacity: int) -> tuple[Spectrum, jax.Array]:
    """Dedup + count a SORTED tuple of per-limb key arrays (sentinel = invalid).

    Shared reduce body of the one-shot counting path (single-chip
    ``make_oneshot_count`` and the distributed grouped drain): segment starts
    found by adjacent-difference, compacted via a 1-operand composite-key sort
    (cheaper than scatter at scale — see make_oneshot_count's docstring),
    counts as adjacent differences of segment-start rows. Returns
    (capacity-sized Spectrum, overflowed flag).
    """
    L = len(s)
    T = s[0].shape[0]
    # the composite compaction key is iota + T for non-starts (uint32):
    # T >= 2^31 would wrap it into the segment-start range and silently
    # corrupt the dedup (SURVEY section 7 capacity bounds)
    assert T < 1 << 31, f"oneshot_reduce buffer {T} rows >= 2^31: split groups"
    sv = s[0] != jnp.uint32(0xFFFFFFFF)
    is_new = jnp.zeros((T,), jnp.bool_)
    for j in range(L):
        is_new = is_new | (s[j] != jnp.roll(s[j], 1))
    is_new = is_new.at[0].set(True) & sv
    n = jnp.sum(is_new.astype(jnp.int32))
    n_valid = jnp.sum(sv.astype(jnp.int32))
    iota = jnp.arange(T, dtype=jnp.uint32)
    comp = jnp.where(is_new, iota, iota + jnp.uint32(T))
    (comp_sorted,) = jax.lax.sort([comp], num_keys=1)
    m = min(capacity, T)
    b = comp_sorted[:m]  # first n entries = segment-start rows
    live_m = b < jnp.uint32(T)
    bfull = jnp.full((capacity,), n_valid, jnp.int32)
    bfull = jax.lax.dynamic_update_slice(
        bfull, jnp.where(live_m, b.astype(jnp.int32), n_valid), (0,)
    )
    live = jnp.arange(capacity, dtype=jnp.int32) < n
    bounds = jnp.concatenate([bfull, n_valid[None]])
    counts = bounds[1:] - bounds[:-1]
    src = jnp.clip(bounds[:capacity], 0, T - 1)
    uniq = jnp.stack(
        [jnp.where(live, s[j][src], 0) for j in range(L)], axis=-1
    )
    counts = jnp.where(live, counts, 0)
    return Spectrum(uniq, counts, jnp.minimum(n, capacity)), n > capacity


@functools.partial(jax.jit, static_argnames=("k",), donate_argnums=(0,))
def merge_spectra_lean(acc: Spectrum, batch: Spectrum, *, k: int) -> Spectrum:
    """Memory-lean sorted-spectrum merge for k % 16 != 0 (sentinel-safe keys).

    ``merge_spectra`` sorts L+2 operands (validity + limbs + counts) of 2C
    rows; at SPEC config-5 scale (C=134M, L=3) that is a ~10.7 GB transient
    that once ran out of device memory. For odd k
    with k %% 16 != 0 limb 0 of a valid key never uses all 32 bits, so
    invalid rows can carry the all-ones sentinel IN limb 0 and the explicit
    validity operand disappears: L+1 operands, and the merged output needs no
    separate mask pass (sentinels sort last). acc is donated — its buffers
    are dead after the merge.

    ``k`` is static and asserted here (not just at the pipeline call site) so
    a future caller — e.g. the dist merge path — cannot feed k %% 16 == 0
    keys, whose valid poly-T limb 0 EQUALS the sentinel and would be dropped.
    """
    assert k % 16 != 0, (
        f"merge_spectra_lean requires k % 16 != 0 (sentinel-safe limb 0); "
        f"got k={k} — use merge_spectra instead"
    )
    assert math.ceil(k / 16) == acc.limbs.shape[1], (k, acc.limbs.shape)
    return merge_lean_body(acc, batch, k)


def merge_lean_body(acc: Spectrum, batch: Spectrum, k: int) -> Spectrum:
    """Traceable body of ``merge_spectra_lean`` — also called per-device
    inside the distributed grouped drain's shard_map (count_dist.py), where
    an outer jit owns donation. Callers must enforce k % 16 != 0.

    Count bound: per-segment sums come from uint32 prefix-sum differences
    cast to int32 — exact while every merged k-mer count stays < 2^31
    (a 2-billion-deep single k-mer; ~26 Tbp of reads of one motif). Beyond
    that the count wraps negative; cutoff would then drop the k-mer, which
    fails loudly downstream (missing edge) rather than corrupting silently."""
    C = acc.limbs.shape[0]
    assert C + batch.limbs.shape[0] < 1 << 31, (
        "merge compaction key wraps uint32 past 2^31 rows"
    )
    L = acc.limbs.shape[1]
    M = C + batch.limbs.shape[0]
    iota_a = jnp.arange(C, dtype=jnp.int32)
    iota_b = jnp.arange(batch.limbs.shape[0], dtype=jnp.int32)
    SENT = jnp.uint32(0xFFFFFFFF)
    la = jnp.where((iota_a < acc.n)[:, None], acc.limbs, SENT)
    lb = jnp.where((iota_b < batch.n)[:, None], batch.limbs, SENT)
    limbs = jnp.concatenate([la, lb], axis=0)
    counts = jnp.concatenate([acc.counts, batch.counts])
    ops = [limbs[:, j] for j in range(L)] + [counts.astype(jnp.uint32)]
    out = jax.lax.sort(ops, num_keys=L, is_stable=False)
    sv = out[0] != SENT
    is_new = jnp.zeros((M,), jnp.bool_)
    for j in range(L):
        is_new = is_new | (out[j] != jnp.roll(out[j], 1))
    is_new = is_new.at[0].set(True) & sv
    n = jnp.sum(is_new.astype(jnp.int32))
    n_valid = jnp.sum(sv.astype(jnp.int32))
    # Compaction by a SECOND 1-operand sort instead of segment scatters: the
    # scatter version paid two random-access 2C-row scatters (the [C, L]
    # row-set worst); the composite-key sort + capacity-sized gathers are
    # mostly sequential traffic (same trick as the one-shot reduce).
    iota = jnp.arange(M, dtype=jnp.uint32)
    comp = jnp.where(is_new, iota, iota + jnp.uint32(M))
    (comp_sorted,) = jax.lax.sort([comp], num_keys=1)
    m2 = min(C + 1, M)
    b2 = comp_sorted[:m2]  # first n entries = segment-start rows, in order
    live_b = (jnp.arange(m2, dtype=jnp.int32) < n) & (b2 < jnp.uint32(M))
    sb = jnp.where(live_b, b2.astype(jnp.int32), n_valid)
    if m2 < C + 1:  # tiny-capacity edge: pad the bounds row
        sb = jnp.concatenate([sb, jnp.full((C + 1 - m2,), n_valid, jnp.int32)])
    start_i = sb[:C]
    ends = sb[1:]
    # segment count sums as prefix-sum differences; uint32 wrap-around is
    # exact mod 2^32 and every true segment sum fits int32
    P = jnp.concatenate(
        [jnp.zeros((1,), jnp.uint32), jnp.cumsum(jnp.where(sv, out[L], 0))]
    )
    live = jnp.arange(C, dtype=jnp.int32) < n
    ucounts = jnp.where(live, (P[ends] - P[start_i]).astype(jnp.int32), 0)
    src = jnp.clip(start_i, 0, M - 1)
    uniq = jnp.stack(
        [jnp.where(live, out[j][src], 0) for j in range(L)], axis=-1
    )
    return Spectrum(uniq, ucounts, jnp.minimum(n, C))
