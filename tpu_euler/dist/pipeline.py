"""Distributed assembly pipeline (SPEC D1-D6; SURVEY.md section 7 step 8).

The k-mer spectrum is always sharded via hash-bucket all_to_all. Traversal has
two modes: replicated (gather the post-cutoff spectrum — cheapest at bacterial
scale) and fully sharded (dist/traverse_dist.py — O(E/n_dev) per device for
multi-device scale, SPEC configs 4-5). Works single-process (virtual CPU mesh or
the GPUs of one host) and true multi-process (jax.distributed; see
scripts/multiprocess_test.py) — host reads go through fetch_global.
"""

from __future__ import annotations

import logging
import time

import jax
import numpy as np

from tpu_euler.config import AssemblyConfig
from tpu_euler.dist.count_dist import (
    DistSpectrum,
    empty_dist_spectrum,
    make_dist_count_step,
    make_gather_spectrum,
)
from tpu_euler.dist.mesh import batch_sharding, fetch_global, make_mesh
from tpu_euler.io.encode import encode_reads
from tpu_euler.pipeline.assemble import AssemblyResult, spectrum_to_contigs


class _SlabOverflow(RuntimeError):
    """An all_to_all slab dropped records (owner imbalance) — retryable."""

log = logging.getLogger("tpu_euler")


def assemble_reads_distributed(
    reads: list[str] | None,
    cfg: AssemblyConfig,
    n_devices: int | None = None,
    dest_capacity_factor: float = 2.0,
    shard_traversal: bool = False,
    codes=None,
    slab_factors: tuple = (2.0, 4.0, 8.0),
    local_input: bool = False,
) -> AssemblyResult:
    """Data-parallel assembly over a 1-D device mesh.

    shard_traversal=True keeps the graph and every traversal array sharded at
    O(E/n_dev) per device (SPEC configs 4-5: prefix-partitioned graph with
    collective pointer jumping — see dist/traverse_dist.py); False gathers the
    post-cutoff spectrum and traverses replicated (cheapest at bacterial
    scale). Contig sets are identical either way.

    local_input=True: ``reads``/``codes`` hold only THIS PROCESS's records
    (e.g. its byte-range file shard, io.fastx.read_shard — SPEC D2). Each
    process feeds its local rows into the global batch via
    jax.make_array_from_process_local_data; processes agree on the step count
    through an allgather of local totals. With a single process this is
    equivalent to the default global-input mode.
    """
    mesh = make_mesh(n_devices)
    n_dev = mesh.devices.size
    t = {"encode": 0.0, "count": 0.0, "gather": 0.0, "graph": 0.0, "extract": 0.0}

    # per-device read rows and per-destination slab capacity
    rows = cfg.read_batch  # reads per device per step
    windows = rows * cfg.windows_per_read
    c_dest = int(dest_capacity_factor * windows / n_dev + 256)
    c_local = cfg.spectrum_capacity // n_dev

    # Grouped one-shot counting: buffer received keys per
    # device across `bpg` batches, sort ONCE per group, lean-merge locally —
    # the per-batch (capacity + slab)-row merge sort the single-chip path
    # measured-and-retired in round 1 leaves the hot loop. Requires the
    # k % 16 != 0 sentinel guarantee (same gate as single-chip one-shot).
    use_grouped = bool(cfg.oneshot_rows) and cfg.k % 16 != 0
    if not use_grouped:
        count_step = make_dist_count_step(cfg.k, n_dev, c_dest, mesh)
    gather_step = make_gather_spectrum(min(cfg.spectrum_capacity, n_dev * c_local), mesh)
    sharding = batch_sharding(mesh)

    acc = empty_dist_spectrum(n_dev, c_local, cfg.nlimbs)
    acc = jax.device_put(
        acc,
        DistSpectrum(limbs=sharding, counts=sharding, n=sharding, dropped=sharding),
    )
    n_reads = 0
    n_windows_parts = []  # device scalars; fetched ONCE after the loop so no
    # per-batch D2H sync serializes the dispatch pipeline
    step_rows = rows * n_dev
    total = len(reads) if reads is not None else codes.shape[0]
    if local_input:
        # this process owns `total` records and feeds rows for its local
        # devices only; all processes must run the SAME number of steps
        n_local_dev = sum(
            1 for d in mesh.devices.flat if d.process_index == jax.process_index()
        )
        my_rows = rows * n_local_dev
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            # Allgather (total, my_rows) PAIRS: with uneven device placement
            # my_rows differs per process, and every process must agree on
            # max_p ceil(total_p / my_rows_p) or the collective step counts
            # desync (a silent multi-host hang, not an error).
            tm = multihost_utils.process_allgather(np.array([total, my_rows]))
            tm = tm.reshape(-1, 2)
            n_steps = max(
                1, int(max(-(-int(tp) // int(mp)) for tp, mp in tm))
            )
            n_reads_global = int(tm[:, 0].sum())
        else:
            n_steps = max(1, -(-total // my_rows))
            n_reads_global = total
    else:
        my_rows = step_rows
        n_steps = max(1, -(-total // step_rows))
        n_reads_global = total
    if use_grouped:
        from tpu_euler.dist.count_dist import (
            make_buf_alloc,
            make_dist_drain_step,
            make_dist_fill_step,
        )

        slab_rows = n_dev * c_dest  # rows received per device per step
        # steps per group: bounded by oneshot_rows per device AND by the
        # actual step count (a small run buffers everything in one group)
        bpg = max(1, min(n_steps, cfg.oneshot_rows // slab_rows))
        t_loc = bpg * slab_rows
        fill_step = make_dist_fill_step(cfg.k, n_dev, c_dest, mesh)
        drain_step = make_dist_drain_step(cfg.k, c_local, mesh)
        alloc_buf = make_buf_alloc(n_dev * t_loc, cfg.nlimbs, mesh)
        al, ac, an, dropped_arr = acc.limbs, acc.counts, acc.n, acc.dropped
        buf = alloc_buf()
        b_in_group = 0
        overs = []
    for s in range(n_steps):
        i = s * my_rows
        t0 = time.perf_counter()
        if reads is not None:
            batch = reads[i : i + my_rows]
            n_reads += len(batch)
            cbatch = encode_reads(batch, cfg.read_len) if batch else np.empty(
                (0, cfg.read_len), np.int8
            )
        else:
            cbatch = codes[i : i + my_rows]
            n_reads += cbatch.shape[0]
        if cbatch.shape[0] < my_rows:
            pad = np.full((my_rows - cbatch.shape[0], cfg.read_len), 4, np.int8)
            cbatch = np.concatenate([cbatch, pad], axis=0) if cbatch.size else pad
        if local_input:
            cbatch = jax.make_array_from_process_local_data(
                sharding, np.ascontiguousarray(cbatch), (step_rows, cfg.read_len)
            )
        else:
            cbatch = jax.device_put(cbatch, sharding)
        t1 = time.perf_counter()
        if use_grouped:
            start = np.int32(b_in_group * slab_rows)
            buf, dropped_arr, nw = fill_step(cbatch, buf, start, dropped_arr)
            b_in_group += 1
            if b_in_group == bpg or s == n_steps - 1:
                al, ac, an, over = drain_step(buf, al, ac, an)
                overs.append(over)
                b_in_group = 0
                buf = alloc_buf() if s != n_steps - 1 else None
        else:
            acc, nw = count_step(cbatch, acc)
        n_windows_parts.append(nw)
        t["encode"] += t1 - t0
        t["count"] += time.perf_counter() - t1

    t1 = time.perf_counter()
    if use_grouped:
        acc = DistSpectrum(limbs=al, counts=ac, n=an, dropped=dropped_arr)
        if sum(int(fetch_global(o).sum()) for o in overs):
            raise RuntimeError(
                f"a spectrum shard overflowed its group-drain capacity "
                f"{c_local}: raise AssemblyConfig.spectrum_capacity"
            )
    jax.block_until_ready(acc)
    if local_input:
        n_reads = n_reads_global
    n_windows = sum(int(fetch_global(nw)[0]) for nw in n_windows_parts)
    dropped = int(fetch_global(acc.dropped).sum())
    # async dispatch catching up: the real counting cost surfaces at these
    # D2H fetches, not in the per-step dispatch timers (same split as the
    # single-chip pipeline's count vs count_drain)
    t["count_drain"] = time.perf_counter() - t1
    if dropped:
        raise RuntimeError(
            f"{dropped} k-mers dropped in all_to_all exchange: raise "
            f"dest_capacity_factor (hash imbalance) or lower read_batch"
        )
    per_shard = fetch_global(acc.n)
    if int(per_shard.max()) >= c_local:
        raise RuntimeError(
            f"a spectrum shard overflowed its capacity {c_local}: raise "
            f"AssemblyConfig.spectrum_capacity"
        )

    if shard_traversal:
        from tpu_euler.dist.traverse_dist import (
            make_dist_chains_step,
            make_dist_cutoff_step,
            shard_chains_to_contigs,
        )

        t2 = time.perf_counter()
        cut_step = make_dist_cutoff_step(cfg.min_count, mesh)
        cl0, cc0, cn0 = cut_step(acc.limbs, acc.counts, acc.n)

        def run_traversal(slab_factor: float):
            """One traversal attempt at the given slab factor.

            Raises _SlabOverflow when any all_to_all slab dropped records so
            the caller can retry with bigger slabs (steps are not donated, so
            the cutoff spectrum stays reusable across attempts).
            """
            cl, cc, cn = cl0, cc0, cn0
            chains_step = make_dist_chains_step(
                cfg.k, n_dev, c_local, mesh, slab_factor=slab_factor
            )
            sc = chains_step(cl, cc, cn)
            if cfg.tip_rounds or cfg.bubble_rounds:
                from tpu_euler.dist.traverse_dist import (
                    make_dist_bubble_step,
                    make_dist_compact_step,
                    make_dist_tip_step,
                )

                compact_step = make_dist_compact_step(mesh)
            if cfg.tip_rounds:
                tip_len = cfg.tip_len or 2 * cfg.k
                tip_step = make_dist_tip_step(
                    tip_len, n_dev, c_local, mesh, slab_factor=slab_factor
                )
                for _ in range(cfg.tip_rounds):
                    keep, n_tips_a, tip_drops = tip_step(
                        sc.valid, sc.chain, sc.pos, sc.tail_dead, sc.head_dead
                    )
                    if int(fetch_global(tip_drops)[0]):
                        raise _SlabOverflow("tip-step slab overflow")
                    if int(fetch_global(n_tips_a)[0]) == 0:
                        break
                    cl, cc, cn = compact_step(cl, cc, cn, keep)
                    sc = chains_step(cl, cc, cn)
            if cfg.bubble_rounds:
                # sharded simple-bubble popping (same ordering as the
                # replicated pipeline: tips to fixed point, then bubbles)
                bubble_len = cfg.bubble_len or 2 * cfg.k
                bubble_step = make_dist_bubble_step(
                    cfg.k, bubble_len, n_dev, c_local, mesh,
                    slab_factor=slab_factor,
                )
                for _ in range(cfg.bubble_rounds):
                    keep, n_pop_a, bub_drops = bubble_step(
                        sc.edge_limbs, sc.valid, sc.chain, sc.pos,
                        sc.is_start, sc.on_cycle, cc,
                    )
                    if int(fetch_global(bub_drops)[0]):
                        raise _SlabOverflow("bubble-step slab overflow")
                    if int(fetch_global(n_pop_a)[0]) == 0:
                        break
                    cl, cc, cn = compact_step(cl, cc, cn, keep)
                    sc = chains_step(cl, cc, cn)
            jax.block_until_ready(sc)
            sdrop = int(fetch_global(sc.dropped).sum())
            if sdrop:
                raise _SlabOverflow(
                    f"{sdrop} records dropped in sharded-traversal slabs"
                )
            return sc, cn

        sc = cn = None
        last_err: Exception | None = None
        for slab_factor in slab_factors:
            try:
                sc, cn = run_traversal(slab_factor)
                break
            except _SlabOverflow as e:
                last_err = e
                log.warning(
                    "%s at slab_factor=%.2f; retrying with a bigger slab "
                    "(owner imbalance; retry recompiles the traversal)",
                    e,
                    slab_factor,
                )
        if sc is None:
            raise RuntimeError(
                f"sharded-traversal slabs overflowed even at slab_factor="
                f"{slab_factors[-1]}: pathological owner imbalance — raise "
                f"spectrum_capacity or device count"
            ) from last_err
        t["graph"] = time.perf_counter() - t2
        t3 = time.perf_counter()
        contigs = shard_chains_to_contigs(sc, cfg.k)
        t["extract"] = time.perf_counter() - t3
        n_cut = int(fetch_global(cn).sum())
    else:
        t2 = time.perf_counter()
        spec = gather_step(acc)
        # Off-mesh copy: the replicated traversal is single-device semantics
        # (every process computes the same contigs). Leaving the spectrum
        # committed to the mesh lets GSPMD re-shard ranking internals, which
        # breaks the host-orchestrated ruling-set ladder (mixed-sharding
        # dynamic_update_slice) at E > 2^17. A host round-trip fully strips
        # the mesh/Explicit sharding; the replicated spectrum is small.
        spec = jax.tree.map(
            lambda x: jax.device_put(np.asarray(x), jax.local_devices()[0]),
            spec,
        )
        jax.block_until_ready(spec)
        t["gather"] = time.perf_counter() - t2

        holder = [spec]
        del spec
        contigs, n_cut = spectrum_to_contigs(holder, cfg, t)

    log.info(
        "dist-assembled %d reads on %d devices -> %d distinct kmers -> %d contigs",
        n_reads,
        n_dev,
        n_cut,
        len(contigs),
    )
    return AssemblyResult(
        contigs=contigs,
        n_distinct_kmers=n_cut,
        n_kmers_counted=n_windows,
        n_reads=n_reads,
        stage_seconds=t,
    )
