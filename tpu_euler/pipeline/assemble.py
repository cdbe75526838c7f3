"""End-to-end single-device assembly pipeline.

Reference counterpart: SURVEY.md section 3a — the driver `main` call stack
(read -> encode -> extract -> hash/count -> graph -> tour -> contigs). Device
shape: reads stream through a fixed-shape jit'd count step into a bounded
spectrum; graph build + traversal are one fused jit; only the final per-edge
chain assignment crosses back to host for string emission.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Iterable

import jax
import jax.numpy as jnp
import numpy as np

from tpu_euler.config import AssemblyConfig
from tpu_euler.euler.extract import chains_to_contigs_device_spec
from tpu_euler.graph.build import DeBruijnGraph, build_graph, build_graph_staged
from tpu_euler.io.encode import encode_reads
from tpu_euler.kmer.count import (
    Spectrum,
    apply_cutoff,
    empty_spectrum,
    spectrum_overflowed,
)
from tpu_euler.kmer.extract import extract_canonical_kmers, unpack_codes

log = logging.getLogger("tpu_euler")

# TPU_EULER_FINE_TIMERS=1 adds D2H syncs between graph substeps so stage
# timers attribute work precisely (debug only — the syncs serialize dispatch).
import os as _os

_FINE_TIMERS = bool(int(_os.environ.get("TPU_EULER_FINE_TIMERS", "0")))


@dataclasses.dataclass
class AssemblyResult:
    contigs: set[bytes]
    n_distinct_kmers: int
    n_kmers_counted: int
    n_reads: int
    stage_seconds: dict[str, float]

    @property
    def contig_strings(self) -> set[str]:
        return {c.decode() for c in self.contigs}


# The make_* step factories are memoized: a FRESH jax.jit wrapper per call
# bypasses the in-process executable cache, so EVERY assembly run would
# re-trace its steps and reload their executables. lru_cache keys on the
# static args, so each distinct (k, capacity, ...) combination traces once per
# process and reuses the live executable after.


@functools.lru_cache(maxsize=None)
def make_count_step(k: int, read_len: int):
    """Fused per-batch device step: unpack + extract + canonicalize + count.

    Raw (unsorted) batch keys are merged straight into the accumulator with
    unit weights: ONE variadic sort over capacity+windows rows per batch.
    (Pre-deduping the batch first always sorts strictly more total rows —
    windows + capacity + min(windows, capacity) — so raw merge wins.)
    Spectrum overflow is detected by the caller via ``spectrum_overflowed``.
    """

    @functools.partial(jax.jit, donate_argnums=(2,))
    def step(packed: jax.Array, nmask: jax.Array, acc: Spectrum):
        from tpu_euler.kmer.count import _unique_counts

        codes = unpack_codes(packed, nmask, read_len)
        limbs, valid = extract_canonical_kmers(codes, k)
        C = acc.limbs.shape[0]
        all_limbs = jnp.concatenate([acc.limbs, limbs], axis=0)
        weights = jnp.concatenate(
            [acc.counts, jnp.ones((limbs.shape[0],), jnp.int32)]
        )
        valids = jnp.concatenate(
            [jnp.arange(C, dtype=jnp.int32) < acc.n, valid]
        )
        uniq, counts, n = _unique_counts(all_limbs, valids, weights)
        n_windows = jnp.sum(valid.astype(jnp.int32))
        over = n > C
        return Spectrum(uniq[:C], counts[:C], jnp.minimum(n, C)), n_windows, over

    def dispatch(packed, nmask, acc):
        if nmask is None:  # clean batch: rebuild the zero bitmap on device
            nmask = jnp.zeros(
                (packed.shape[0], -(-read_len // 8)), jnp.uint8
            )
        return step(packed, nmask, acc)

    return dispatch


@functools.lru_cache(maxsize=None)
def make_graph_step(k: int, min_count: int):
    """Device step: cutoff -> graph (chains computed by the caller).

    Chains use the host-orchestrated sparse-ruling-set path
    (``unitig_chains_fast``) for large graphs — O(E) random-access work vs
    doubling's O(E log E) — so they cannot live inside this jit.

    Kept for profiling scripts; the pipeline itself uses the split
    ``make_cutoff_step`` + ``build_graph`` so the pre-cutoff spectrum's
    buffers are donated away and the graph's node arrays can be trimmed
    (memory headroom for SPEC config 5 — 100 Mbp on one device).
    """

    @jax.jit
    def step(spec: Spectrum) -> tuple[DeBruijnGraph, Spectrum]:
        cut = apply_cutoff(spec, min_count)
        g = build_graph(cut, k)
        return g, cut

    return step


@functools.lru_cache(maxsize=None)
def make_cutoff_step(min_count: int):
    """jit'd cutoff with the input spectrum DONATED: apply_cutoff writes
    same-shaped arrays, so the output aliases the donated input and the
    pre-cutoff spectrum costs no extra residency — even though the caller
    (assemble_codes' frame) still holds a now-invalidated reference."""

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(spec: Spectrum) -> Spectrum:
        return apply_cutoff(spec, min_count)

    return step


def assemble_reads(
    reads: Iterable[str] | list[str], cfg: AssemblyConfig
) -> AssemblyResult:
    """Assemble an iterable of read strings into canonical contigs."""
    reads = list(reads) if not isinstance(reads, list) else reads
    codes = encode_reads(reads, cfg.read_len)
    return assemble_codes(codes, cfg)


@functools.lru_cache(maxsize=None)
def make_extract_fill_step(k: int, read_len: int):
    """Per-batch: unpack + extract+canonicalize into the one-shot key buffers.

    Invalid windows become all-ones sentinel keys — for odd k no valid
    canonical key uses all 32 bits of limb 0, so the sentinel needs no separate
    validity operand and sorts to the end for free. The buffer is a tuple of
    per-limb 1-D arrays: the variadic sorts downstream take one operand per
    limb, so a [T, L] layout would only be split again.

    Extraction is the plain XLA window-pack (``kmer/extract.py``).
    """
    assert k % 16 != 0  # sentinel encoding requires spare bits in limb 0
    from tpu_euler.kmer.extract import unpack_codes_clean

    def _core(codes, buf, start):
        limbs, valid = extract_canonical_kmers(codes, k)
        limbs = jnp.where(valid[:, None], limbs, jnp.uint32(0xFFFFFFFF))
        buf = tuple(
            jax.lax.dynamic_update_slice(buf[j], limbs[:, j], (start,))
            for j in range(limbs.shape[1])
        )
        return buf, jnp.sum(valid.astype(jnp.int32))

    @functools.partial(jax.jit, donate_argnums=(2,))
    def step(packed: jax.Array, nmask: jax.Array, buf: tuple, start: jax.Array):
        return _core(unpack_codes(packed, nmask, read_len), buf, start)

    @functools.partial(jax.jit, donate_argnums=(1,))
    def step_clean(packed: jax.Array, buf: tuple, start: jax.Array):
        return _core(unpack_codes_clean(packed, read_len), buf, start)

    def dispatch(packed, nmask, buf, start):
        # nmask None = clean batch (no N, no padding): the zero bitmap is
        # neither copied to the device nor unpacked there
        if nmask is None:
            return step_clean(packed, buf, start)
        return step(packed, nmask, buf, start)

    return dispatch


@functools.lru_cache(maxsize=None)
def make_oneshot_count(k: int, capacity: int):
    """Sort the full key buffer once; dedup + count into a capacity spectrum.

    Post-sort reduction is a SECOND, single-operand sort: the composite key
    ``row + T*(not segment start)`` moves every segment start's row index to
    the front IN ORDER (no stability needed — the composite is injective and
    monotone within each class). It replaces a row-index scatter: a sort of
    one operand is mostly sequential traffic where a scatter is random
    writes. Counts then fall out as adjacent differences of the segment-start
    rows, keys as capacity-sized gathers.

    TWO jits, not one: a single jit donating ``buf``
    has only capacity-shaped outputs, so none can alias the T-row inputs —
    the donation was a silent no-op ("donated buffers were not usable",
    1.32 GB dead weight at 165M rows, 2.3 GB/group at config-5 scale) and
    the raw key buffer stayed allocated through the whole reduction. Split,
    the sort's T-row outputs alias the donated T-row inputs exactly, and the
    sorted buffer's refs drop at return so it is freed before any
    downstream merge runs.
    """

    @functools.partial(jax.jit, donate_argnums=(0,))
    def sort_step(buf: tuple):
        return tuple(jax.lax.sort(list(buf), num_keys=len(buf)))

    @jax.jit
    def reduce_step(s: tuple):
        from tpu_euler.kmer.count import oneshot_reduce

        return oneshot_reduce(s, capacity)

    def count(buf: tuple):
        return reduce_step(sort_step(buf))

    return count


@functools.lru_cache(maxsize=None)
def make_arena_drain(k: int, capacity: int, t_rows: int):
    """Grouped-counting ARENA drain: merge T raw keys into the C-row head.

    Replaces a sort + reduce + lean-merge chain whose reduce and merge were
    CAPACITY-SIZED GATHERS (random access over the whole spectrum per group),
    not sorts. This drain eliminates every capacity-sized gather:

    * The accumulator spectrum lives in rows [0, C) of a persistent
      [C + T]-row arena (per-limb uint32 arrays + one uint32 count array);
      group fills write raw keys into rows [C, C + T) with sentinel padding.
    * Drain sort 1: ONE (L+1)-operand key sort of the whole arena (acc rows
      carry their counts; raw rows weight 1). Dup keys are now adjacent.
    * Drain sort 2: composite-key compaction sort carrying limbs AND the
      exclusive count prefix-sum as payload — segment starts land in rows
      [0, n) IN ORDER, so uniques come out as SLICES and per-key counts as
      adjacent differences of the carried prefix sums. No gather anywhere.
    * The arena is donated: in/out shapes match exactly, so XLA aliases the
      buffers and the merge runs with no extra residency.

    uint32 prefix sums wrap mod 2^32; adjacent differences stay exact while
    every single k-mer's total count < 2^31 (see merge_spectra_lean's note).

    Returns jit: (limb_arena tuple, count_arena) -> (limb_arena', count_arena',
    n_distinct, overflowed).
    """
    assert k % 16 != 0, "arena drain needs the sentinel-safe limb-0 guarantee"
    C, T = capacity, t_rows
    M = C + T
    assert M < 1 << 31, f"arena {M} rows >= 2^31: composite key would wrap"
    SENT = jnp.uint32(0xFFFFFFFF)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def drain(bufs: tuple, counts_a: jax.Array):
        L = len(bufs)
        iota_m = jnp.arange(M, dtype=jnp.uint32)
        w_in = jnp.where(iota_m < C, counts_a, jnp.uint32(1))
        out = jax.lax.sort(
            list(bufs) + [w_in], num_keys=L, is_stable=False
        )
        sv = out[0] != SENT
        is_new = jnp.zeros((M,), jnp.bool_)
        for j in range(L):
            is_new = is_new | (out[j] != jnp.roll(out[j], 1))
        is_new = is_new.at[0].set(True) & sv
        n = jnp.sum(is_new.astype(jnp.int32))
        w = jnp.where(sv, out[L], jnp.uint32(0))
        pcs = jnp.cumsum(w)  # inclusive; wraps mod 2^32, diffs exact
        ecs = pcs - w  # exclusive prefix at each row
        total = pcs[M - 1]
        comp = jnp.where(is_new, iota_m, iota_m + jnp.uint32(M))
        out2 = jax.lax.sort(
            [comp] + [out[j] for j in range(L)] + [ecs], num_keys=1
        )
        iota_c = jnp.arange(C, dtype=jnp.int32)
        live = iota_c < n
        es = out2[L + 1][: C + 1]
        # segment i's count = ecs(start i+1) - ecs(start i); the LAST live
        # segment ends at the all-valid total, not at the next sorted row
        # (which is the first non-start)
        e1 = jnp.where(iota_c == n - 1, total, es[1:])
        counts_u = jnp.where(live, (e1 - es[:C]).astype(jnp.int32), 0)
        # rebuild the arena: compacted uniques in rows [0, n), everything
        # else (incl. the whole fill region) reset to sentinel / zero
        new_bufs = tuple(
            jnp.where(iota_m < n.astype(jnp.uint32), out2[1 + j], SENT)
            for j in range(L)
        )
        new_counts = jnp.concatenate(
            [counts_u.astype(jnp.uint32), jnp.zeros((T,), jnp.uint32)]
        )
        return new_bufs, new_counts, n, n > C

    return drain


@functools.lru_cache(maxsize=None)
def make_arena_finalize(capacity: int):
    """Slice the arena head into a standard [C, L] Spectrum (one jit)."""

    @jax.jit  # no donation: [C]-shaped outputs cannot alias the [C+T] arena
    def finalize(bufs: tuple, counts_a: jax.Array) -> Spectrum:
        C = capacity
        SENT = jnp.uint32(0xFFFFFFFF)
        valid = bufs[0][:C] != SENT
        limbs = jnp.stack(
            [jnp.where(valid, b[:C], 0) for b in bufs], axis=-1
        )
        counts = jnp.where(valid, counts_a[:C].astype(jnp.int32), 0)
        return Spectrum(limbs, counts, jnp.sum(valid.astype(jnp.int32)))

    return finalize


def _pack_batch(batch, cfg: AssemblyConfig):
    """Pad a host batch to the static batch shape and 2-bit-pack it for H2D.

    2.25 bits/base (packed codes + N bitmap, io/encode.py:pack_codes) instead
    of 8 cuts the host-to-device bytes ~3.5x. Packing runs in the native
    threaded codec when available (numpy fallback). Device-side unpack fuses
    into extraction.
    """
    from tpu_euler.io.encode import pack_codes

    batch = np.asarray(batch)
    padded = batch.shape[0] < cfg.read_batch
    if padded:  # pad final batch to static shape
        pad = np.full(
            (cfg.read_batch - batch.shape[0], cfg.read_len), 4, np.int8
        )
        batch = np.concatenate([batch, pad], axis=0)
    packed, nmask = pack_codes(batch)
    if not padded and not nmask.any():
        return jnp.asarray(packed), None  # clean batch: skip the bitmap H2D
    return jnp.asarray(packed), jnp.asarray(nmask)


def _n_batches(codes_all, cfg: AssemblyConfig) -> int:
    """THE batch-count formula — shared by the feed and both counting paths
    so they can never desync (a mismatch would drop or duplicate batches)."""
    return max(1, -(-codes_all.shape[0] // cfg.read_batch))


# Window counting uses a split hi/lo int32 pair on device: SPEC config 5
# counts 2.4e9 windows, which overflows a single int32 (x64 is disabled and
# float32 loses exactness past 2^24). lo stays < 2^30 + batch windows, the
# carry moves to hi — exact to 2^61 with two cheap device ops per batch.
_ACC2_MASK = (1 << 30) - 1


def _acc2_zero():
    return (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))


@jax.jit
def _acc2_add(acc, nw):
    lo = acc[0] + nw
    return (lo & _ACC2_MASK, acc[1] + (lo >> 30))


def _acc2_final(acc) -> int:
    return (int(acc[1]) << 30) + int(acc[0])


def _batch_feed(codes_all, cfg: AssemblyConfig, depth: int = 2):
    """Yield per-batch (packed, nmask) device arrays, prepared ahead of time.

    A single worker thread packs batch b+depth (native codec) and stages its
    H2D transfer while the main thread dispatches batch b's device step — the
    host-side encode cost overlaps device compute instead of serializing the
    pipeline. One worker keeps batches ordered and bounds host memory to
    ``depth`` staged batches. Callers that don't exhaust the generator must
    ``close()`` it so the executor's with-block exits promptly.
    """
    from concurrent.futures import ThreadPoolExecutor

    n_batches = _n_batches(codes_all, cfg)

    def prep(b: int):
        return _pack_batch(
            codes_all[b * cfg.read_batch : (b + 1) * cfg.read_batch], cfg
        )

    with ThreadPoolExecutor(max_workers=1) as ex:
        futs = {b: ex.submit(prep, b) for b in range(min(depth, n_batches))}
        for b in range(n_batches):
            if b + depth < n_batches:
                futs[b + depth] = ex.submit(prep, b + depth)
            yield futs.pop(b).result()


def count_spectrum_oneshot(codes_all, cfg: AssemblyConfig, t: dict):
    """One-shot counting: buffer every batch's canonical keys, sort once."""
    Wb = cfg.read_batch * cfg.windows_per_read
    n_batches = _n_batches(codes_all, cfg)
    T = n_batches * Wb
    fill = make_extract_fill_step(cfg.k, cfg.read_len)
    oneshot = make_oneshot_count(cfg.k, cfg.spectrum_capacity)
    buf = tuple(
        jnp.full((T,), jnp.uint32(0xFFFFFFFF)) for _ in range(cfg.nlimbs)
    )
    n_windows = _acc2_zero()
    feed = _batch_feed(codes_all, cfg)
    try:
        for b in range(n_batches):
            t0 = time.perf_counter()
            packed, nmask = next(feed)  # wait for the prefetcher ("encode" time)
            t1 = time.perf_counter()
            buf, nw = fill(packed, nmask, buf, jnp.asarray(b * Wb, jnp.int32))
            n_windows = _acc2_add(n_windows, nw)
            t["encode"] += t1 - t0
            t["count"] += time.perf_counter() - t1
    finally:
        feed.close()
    t1 = time.perf_counter()
    acc, over = oneshot(buf)
    n_windows = _acc2_final(n_windows)  # D2H: waits for every fill step
    over = bool(over)  # D2H: drains the global sort so count_drain is honest
    t["count_drain"] += time.perf_counter() - t1
    if over:
        raise RuntimeError(
            f"spectrum capacity {cfg.spectrum_capacity} overflowed: "
            f"raise AssemblyConfig.spectrum_capacity"
        )
    return acc, n_windows


def count_spectrum_grouped(codes_all, cfg: AssemblyConfig, t: dict):
    """Hierarchical streaming: fill GROUPS of raw keys into a persistent
    arena whose head holds the accumulated spectrum; one two-sort drain per
    group merges raw keys AND dedups in place (``make_arena_drain``).

    For runs whose total windows exceed ``oneshot_rows`` (SPEC config 5:
    100 Mbp x 40x = 2.4G windows), this costs one (L+1)-operand key sort +
    one compaction sort over C+T rows per group — with NO capacity-sized
    gathers or scatters anywhere: only sequential-traffic sorts.
    """
    Wb = cfg.read_batch * cfg.windows_per_read
    n_batches = _n_batches(codes_all, cfg)
    bpg = max(1, cfg.oneshot_rows // Wb)  # batches per group
    T = bpg * Wb
    C = cfg.spectrum_capacity
    M = C + T
    n_groups = -(-n_batches // bpg)
    fill = make_extract_fill_step(cfg.k, cfg.read_len)
    drain = make_arena_drain(cfg.k, C, T)
    n_windows = _acc2_zero()
    # Per-group sync policy: deferring group g's drain D2H lets g+1's H2D
    # overlap it, but every deferred group keeps its sort workspace queued,
    # which at config-5 scale exhausted the memory of the device this limit
    # was sized for. Defer only for small group counts; whole-group lag-1
    # overlap was tried and reverted because the drain got slower.
    defer_sync = n_groups <= 4
    overs = []
    bufs = tuple(jnp.full((M,), jnp.uint32(0xFFFFFFFF)) for _ in range(cfg.nlimbs))
    counts_a = jnp.zeros((M,), jnp.uint32)
    feed = _batch_feed(codes_all, cfg)
    try:
        for g0 in range(0, n_batches, bpg):
            gi = g0 // bpg
            nb = min(bpg, n_batches - g0)
            h2d_bytes = 0
            t1 = time.perf_counter()
            for b in range(nb):
                t0 = time.perf_counter()
                packed, nmask = next(feed)
                t1 = time.perf_counter()
                bufs, nw = fill(
                    packed, nmask, bufs, jnp.asarray(C + b * Wb, jnp.int32)
                )
                n_windows = _acc2_add(n_windows, nw)
                h2d_bytes += packed.nbytes + (0 if nmask is None else nmask.nbytes)
                t["encode"] += t1 - t0
                t["count"] += time.perf_counter() - t1
            t1 = time.perf_counter()
            if _FINE_TIMERS:  # true completion of this group's H2D + extracts
                np.asarray(jax.device_get(bufs[0][M - 1]))
                t[f"fill_sync_g{gi}"] = time.perf_counter() - t1
                t[f"h2d_mb_g{gi}"] = round(h2d_bytes / 2**20, 1)
                t1 = time.perf_counter()
            bufs, counts_a, n_dev_, over = drain(bufs, counts_a)
            if _FINE_TIMERS:
                np.asarray(jax.device_get(counts_a[0]))
                t[f"drain_g{gi}"] = time.perf_counter() - t1
                t1 = time.perf_counter()
            if defer_sync:
                overs.append(over)
            elif bool(over):  # D2H sync: drains this group's workspace
                overs.append(jnp.ones((), jnp.bool_))
            t["count_drain"] += time.perf_counter() - t1
    finally:
        feed.close()
    t1 = time.perf_counter()
    acc = make_arena_finalize(C)(bufs, counts_a)
    del bufs
    n_windows = _acc2_final(n_windows)
    over_any = any(bool(o) for o in overs)  # D2H: drains all group sorts
    t["count_drain"] += time.perf_counter() - t1
    if over_any or spectrum_overflowed(acc):
        raise RuntimeError(
            f"spectrum capacity {cfg.spectrum_capacity} overflowed: "
            f"raise AssemblyConfig.spectrum_capacity"
        )
    return acc, n_windows


def count_spectrum(codes_all, cfg: AssemblyConfig, t: dict | None = None):
    """Count a pre-encoded [R, read_len] int8 code matrix into a Spectrum.

    Chooses one-shot counting (single global sort) when the run's total
    windows fit ``cfg.oneshot_rows``; grouped one-shot merging beyond that
    (memory-bounded for arbitrarily large read sets). The legacy per-batch
    raw merge remains for k % 16 == 0 (no spare sentinel bit) or
    oneshot_rows == 0. Returns (spectrum, n_windows_counted).
    """
    import numpy as np

    t = t if t is not None else {}
    t.setdefault("encode", 0.0)
    t.setdefault("count", 0.0)
    t.setdefault("count_drain", 0.0)
    total_windows = _n_batches(codes_all, cfg) * (
        cfg.read_batch * cfg.windows_per_read
    )
    if cfg.oneshot_rows and cfg.k % 16 != 0:
        if total_windows <= cfg.oneshot_rows:
            return count_spectrum_oneshot(codes_all, cfg, t)
        return count_spectrum_grouped(codes_all, cfg, t)
    count_step = make_count_step(cfg.k, cfg.read_len)
    acc = empty_spectrum(cfg.spectrum_capacity, cfg.nlimbs)
    n_windows = _acc2_zero()
    over = jnp.zeros((), jnp.bool_)

    feed = _batch_feed(codes_all, cfg)
    try:
        for _ in range(_n_batches(codes_all, cfg)):
            t0 = time.perf_counter()
            packed, nmask = next(feed)  # prefetcher wait = host encode time
            t1 = time.perf_counter()
            acc, nw, ov = count_step(packed, nmask, acc)
            n_windows = _acc2_add(n_windows, nw)
            over = over | ov
            t["encode"] += t1 - t0
            t["count"] += time.perf_counter() - t1
    finally:
        feed.close()

    t1 = time.perf_counter()
    n_windows = _acc2_final(n_windows)  # D2H: waits for every count step
    t["count_drain"] = time.perf_counter() - t1  # async dispatch catching up
    if bool(over) or spectrum_overflowed(acc):
        raise RuntimeError(
            f"spectrum capacity {cfg.spectrum_capacity} overflowed: "
            f"raise AssemblyConfig.spectrum_capacity"
        )
    return acc, n_windows


def right_size_spectrum(acc: Spectrum, granule: int = 1 << 18) -> Spectrum:
    """Slice the capacity-padded spectrum down to ~1.06x its live size.

    Every downstream array (edges, nodes, doubling-loop state) scales with the
    spectrum's CAPACITY, not its live count — right-sizing before the graph
    stage shrinks the whole traversal proportionally. Sizes are granule-rounded
    so only a few distinct shapes ever compile.
    """
    C = acc.limbs.shape[0]
    n = int(acc.n)
    cap2 = min(C, max(granule, -(-int(n * 1.06) // granule) * granule))
    if cap2 >= C:
        return acc
    return Spectrum(acc.limbs[:cap2], acc.counts[:cap2], acc.n)


def spectrum_to_contigs(
    acc: Spectrum,
    cfg: AssemblyConfig,
    t: dict | None = None,
    save_graph_path: str = "",
) -> tuple[set, int]:
    """Cutoff (+ tip clipping) + graph + traversal + emission. Returns (contigs, n_cut).

    NOTE: the input spectrum's buffers are DONATED into the cutoff jit in
    BOTH calling forms — a bare ``Spectrum`` argument is invalidated just
    like the ``[spectrum]`` ownership-handoff form. Callers must not reuse
    the spectrum (or its arrays) after this returns; re-count or checkpoint
    first if it is needed again.

    Buffer lifetimes are managed aggressively for memory headroom at
    SPEC config-5 scale (100 Mbp -> ~220M doubled edges): the pre-cutoff
    spectrum is donated into the cutoff jit, the cut spectrum is dropped as
    soon as the graph is built, and the graph's node arrays (~half its
    bytes) are dropped once the successor array exists — the ruling-set
    walk and emission need only (edge_limbs, edge_valid, succ0).
    """
    from tpu_euler.euler.unitigs import (
        chains_from_successors_spec,
        successor,
    )

    t = t if t is not None else {}
    if isinstance(acc, list):  # ownership handoff: [spectrum], popped here so
        acc = acc.pop()  # the caller's frame holds no reference and the
        # pre-right-size buffers (1.9 GB at config-5 scale) free immediately
    acc = right_size_spectrum(acc)
    if cfg.tip_rounds or cfg.bubble_rounds:
        from tpu_euler.euler.clean import clip_tips, pop_bubbles

        t1 = time.perf_counter()
        acc = apply_cutoff(acc, cfg.min_count)
        # right-size AGAIN after the cutoff: errored full-scale runs carry
        # several times more pre-cutoff distinct k-mers than survivors
        # (12 Mbp at 0.3%/base: ~50M raw vs 12M kept), and clip_tips /
        # pop_bubbles build a MONOLITHIC graph at the spectrum's CAPACITY —
        # at the raw capacity that program ran out of device memory
        acc = right_size_spectrum(acc)
        if cfg.tip_rounds:
            acc, n_clipped = clip_tips(acc, cfg.k, cfg.tip_rounds, cfg.tip_len)
            log.info("tip clipping removed %d k-mers", n_clipped)
        if cfg.bubble_rounds:
            acc, n_popped = pop_bubbles(
                acc, cfg.k, cfg.bubble_rounds, cfg.bubble_len
            )
            log.info("bubble popping removed %d k-mers", n_popped)
        t["tips"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    cut = make_cutoff_step(cfg.min_count)(acc)
    del acc  # donated into the cutoff step — dead either way
    E = 2 * cut.limbs.shape[0]
    node_cap = 0  # 0 -> exact worst case 2E
    if cfg.node_cap_factor < 2.0:
        granule = 1 << 18
        node_cap = min(
            2 * E, -(-int(cfg.node_cap_factor * E) // granule) * granule
        )
    # Staged build over the VIRTUAL doubled edge array: the [E, L] edge-key
    # array never materializes (rows >= C are revcomp(spectrum row) on the
    # fly), and each build stage's transient peak is bounded — the
    # difference between fitting and RESOURCE_EXHAUSTED at SPEC config-5
    # scale (220M doubled edges). ``big`` additionally
    # syncs at stage boundaries so enqueue-time output allocation cannot
    # stack multiple stages' buffers (see build_graph_staged docstring).
    big = E > (1 << 26)
    g = build_graph_staged(cut, cfg.k, node_cap, sync=big)
    spec_limbs = cut.limbs
    n_cut_dev = cut.n  # scalar; fetched at return (no mid-pipeline sync)
    del cut
    if node_cap and node_cap < 2 * E:
        n_nodes = int(g.n_nodes)  # D2H sync — only on the trimmed path
        if n_nodes > node_cap:
            raise RuntimeError(
                f"node capacity {node_cap} < n_nodes {n_nodes}: raise "
                f"AssemblyConfig.node_cap_factor (currently "
                f"{cfg.node_cap_factor})"
            )
    if _FINE_TIMERS:  # debug attribution; forces a D2H sync per substep
        import numpy as _np

        _np.asarray(jax.device_get(g.head[0]))
        t["graph_build"] = time.perf_counter() - t2
    succ0 = successor(g, cfg.k)
    edge_valid = g.edge_valid
    saved_th = (g.tail, g.head) if save_graph_path else None
    del g  # frees tail/head/degree/succ_cand arrays before the walk
    if big:
        from tpu_euler.euler.unitigs import chains_from_t, transition_keys_spec

        jax.block_until_ready(succ0)  # drain before the t-key transient
        t_keys = transition_keys_spec(spec_limbs, succ0, cfg.k)
        jax.block_until_ready(t_keys)
        t_holder, succ0_ref = [t_keys], succ0
        del t_keys
        chains = chains_from_t(
            t_holder, edge_valid, succ0_ref, cfg.k,
            t_factory=lambda: transition_keys_spec(
                spec_limbs, succ0_ref, cfg.k
            ),
        )
        del succ0_ref
    else:
        chains = chains_from_successors_spec(
            spec_limbs, edge_valid, succ0, cfg.k
        )
    del succ0
    jax.block_until_ready(chains)
    if _FINE_TIMERS:
        import numpy as _np

        _np.asarray(jax.device_get(chains.chain[0]))
    t["graph"] = time.perf_counter() - t2
    if save_graph_path:
        import types

        from tpu_euler.graph.build import gather_edge_rows
        from tpu_euler.pipeline.checkpoint import save_graph

        # save_graph needs edge keys + tail/head; materialize keys from the
        # spectrum (checkpointing is a small-scale convenience path)
        gq = types.SimpleNamespace(
            edge_limbs=gather_edge_rows(
                spec_limbs, jnp.arange(E, dtype=jnp.int32), cfg.k
            ),
            tail=saved_th[0],
            head=saved_th[1],
        )
        save_graph(save_graph_path, gq, chains, cfg.k)

    t3 = time.perf_counter()
    contigs = chains_to_contigs_device_spec(spec_limbs, chains, cfg.k)
    t["extract"] = time.perf_counter() - t3
    return contigs, int(n_cut_dev)


def assemble_codes(codes_all, cfg: AssemblyConfig) -> AssemblyResult:
    """Assemble from a pre-encoded [R, read_len] int8 code matrix."""
    t: dict = {}
    acc, n_windows = count_spectrum(codes_all, cfg, t)
    holder = [acc]  # hand ownership to spectrum_to_contigs (see its docstring)
    del acc
    contigs, n_cut = spectrum_to_contigs(holder, cfg, t)
    n_reads = codes_all.shape[0]
    log.info(
        "assembled %d reads -> %d distinct kmers -> %d contigs (%s)",
        n_reads,
        n_cut,
        len(contigs),
        {s: f"{v:.3f}s" for s, v in t.items()},
    )
    return AssemblyResult(
        contigs=contigs,
        n_distinct_kmers=n_cut,
        n_kmers_counted=n_windows,
        n_reads=n_reads,
        stage_seconds=t,
    )
