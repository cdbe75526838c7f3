"""Distributed k-mer spectrum counting: bucket all-to-all exchange (SPEC D2-D4).

BASELINE.json north star: "read batches streamed data-parallel from FASTQ shards,
per-host partial k-mer spectra merged via all-to-all on k-mer hash buckets, graph
partitioned by k-mer prefix". Design:

* Each device extracts canonical k-mers from its shard of the read batch.
* Ownership: ``owner(key) = bucket_hash(key) % n_devices`` — balanced (hash) and
  contiguous in scrambled-key space (prefix partitioning of the hashed keyspace).
* Keys are grouped by owner with ONE variadic sort (owner as leading sort key),
  packed into fixed [n_dev, C_dest] send slabs (rank-in-group via scatter-min of
  segment starts), and exchanged with ``lax.all_to_all`` over the mesh axis —
  the XLA-collective answer to "what replaces NCCL" (SPEC D6).
* Each device then counts only keys it owns (sort + segment-sum) and folds them
  into its local spectrum shard. Counts are exact: every k-mer instance is
  counted on exactly one owner device, so cross-device duplicates cannot occur.
* Dropped-key overflow (a destination slab filling up) is detected and psum'd so
  the host can fail loudly rather than under-count.

All shapes are static; the same code runs on an 8-virtual-device CPU mesh and on
several GPUs (SURVEY.md section 4 multi-host strategy).
"""

from __future__ import annotations

from typing import NamedTuple

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from tpu_euler.dist.mesh import AXIS
from tpu_euler.kmer import keys
from tpu_euler.kmer.count import (
    Spectrum,
    count_batch,
    merge_lean_body,
    merge_spectra,
    oneshot_reduce,
)
from tpu_euler.kmer.extract import extract_canonical_kmers


class DistSpectrum(NamedTuple):
    """Spectrum sharded over the mesh axis by k-mer ownership.

    Global (unsharded) shapes; under shard_map each device sees its block.
    """

    limbs: jax.Array  # [n_dev * C_local, L]
    counts: jax.Array  # [n_dev * C_local]
    n: jax.Array  # [n_dev] valid entries per shard
    dropped: jax.Array  # [n_dev] k-mers dropped in exchange (must be 0)


def empty_dist_spectrum(n_dev: int, c_local: int, nlimbs: int) -> DistSpectrum:
    return DistSpectrum(
        limbs=jnp.zeros((n_dev * c_local, nlimbs), jnp.uint32),
        counts=jnp.zeros((n_dev * c_local,), jnp.int32),
        n=jnp.zeros((n_dev,), jnp.int32),
        dropped=jnp.zeros((n_dev,), jnp.int32),
    )


def _group_by_owner(limbs, valid, owner, n_dev: int, c_dest: int):
    """Pack keys into [n_dev * c_dest, L] send slabs grouped by owner.

    Returns (send_limbs, send_valid, n_dropped).
    """
    M, L = limbs.shape
    inv = (~valid).astype(jnp.uint32)
    operands = [inv, owner.astype(jnp.uint32)] + [limbs[..., j] for j in range(L)]
    out = jax.lax.sort(operands, num_keys=2, is_stable=True)
    s_valid = out[0] == 0
    s_owner = out[1].astype(jnp.int32)
    s_limbs = jnp.stack(out[2:], axis=-1)
    idx = jnp.arange(M, dtype=jnp.int32)
    # first index of each owner group (invalid rows sort last; clamp their owner)
    owner_c = jnp.where(s_valid, s_owner, n_dev)
    seg_start = (
        jnp.full((n_dev + 1,), M, jnp.int32).at[owner_c].min(idx)
    )
    pos = idx - seg_start[owner_c]
    ok = s_valid & (pos < c_dest)
    dest = jnp.where(ok, owner_c * c_dest + pos, n_dev * c_dest)
    send_limbs = jnp.zeros((n_dev * c_dest, L), jnp.uint32).at[dest].set(
        s_limbs, mode="drop"
    )
    send_valid = jnp.zeros((n_dev * c_dest,), jnp.bool_).at[dest].set(
        True, mode="drop"
    )
    n_dropped = jnp.sum((s_valid & ~ok).astype(jnp.int32))
    return send_limbs, send_valid, n_dropped


@functools.lru_cache(maxsize=None)
def make_dist_count_step(k: int, n_dev: int, c_dest: int, mesh: Mesh):
    """Build the jit'd sharded per-batch counting step.

    Signature: (codes [n_dev*R, Lmax] sharded by rows, acc: DistSpectrum)
             -> (acc', n_windows_global).
    """

    def local_step(codes, acc: DistSpectrum):
        limbs, valid = extract_canonical_kmers(codes, k)
        owner = keys.bucket_hash(limbs) % jnp.uint32(n_dev)
        send_limbs, send_valid, dropped = _group_by_owner(
            limbs, valid, owner, n_dev, c_dest
        )
        recv_limbs = jax.lax.all_to_all(
            send_limbs, AXIS, split_axis=0, concat_axis=0, tiled=True
        )
        recv_valid = jax.lax.all_to_all(
            send_valid, AXIS, split_axis=0, concat_axis=0, tiled=True
        )
        batch = count_batch(recv_limbs, recv_valid)
        local = Spectrum(acc.limbs, acc.counts, acc.n[0])
        merged = merge_spectra(local, batch)
        n_windows = jax.lax.psum(jnp.sum(valid.astype(jnp.int32)), AXIS)
        acc_out = DistSpectrum(
            limbs=merged.limbs,
            counts=merged.counts,
            n=merged.n[None],
            dropped=acc.dropped + dropped[None],
        )
        return acc_out, n_windows[None]

    specs_acc = DistSpectrum(limbs=P(AXIS), counts=P(AXIS), n=P(AXIS), dropped=P(AXIS))
    return jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(AXIS), specs_acc),
            out_specs=(specs_acc, P(AXIS)),
        )
    )


@functools.lru_cache(maxsize=None)
def make_dist_fill_step(k: int, n_dev: int, c_dest: int, mesh: Mesh):
    """Grouped-counting fill: extract -> owner all_to_all -> buffer received keys.

    The single-chip path retired per-batch capacity sorts in round 1
    (one-shot/grouped counting, pipeline/assemble.py); this brings the same
    strategy to the distributed exchange: each batch's
    RECEIVED (owned) keys are appended to a per-device T-row sentinel buffer
    instead of being sorted+merged immediately. Invalid slab padding becomes
    the all-ones sentinel (k %% 16 != 0 — enforced by the pipeline), which
    sorts to the end of the group drain for free.

    Signature: (codes [n_dev*R, Lmax] row-sharded, buf tuple of [n_dev*T_loc]
    uint32 sharded, start [] int32 replicated, dropped_acc [n_dev])
             -> (buf', dropped_acc', n_windows [n_dev]).
    """
    L = keys.nlimbs(k)
    SENT = jnp.uint32(0xFFFFFFFF)

    def local_step(codes, buf, start, dropped_acc):
        limbs, valid = extract_canonical_kmers(codes, k)
        owner = keys.bucket_hash(limbs) % jnp.uint32(n_dev)
        send_limbs, send_valid, dropped = _group_by_owner(
            limbs, valid, owner, n_dev, c_dest
        )
        recv_limbs = jax.lax.all_to_all(
            send_limbs, AXIS, split_axis=0, concat_axis=0, tiled=True
        )
        recv_valid = jax.lax.all_to_all(
            send_valid, AXIS, split_axis=0, concat_axis=0, tiled=True
        )
        rows = jnp.where(recv_valid[:, None], recv_limbs, SENT)
        buf = tuple(
            jax.lax.dynamic_update_slice(buf[j], rows[:, j], (start,))
            for j in range(L)
        )
        n_windows = jax.lax.psum(jnp.sum(valid.astype(jnp.int32)), AXIS)
        return buf, dropped_acc + dropped[None], n_windows[None]

    bufspec = tuple(P(AXIS) for _ in range(L))
    return jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(AXIS), bufspec, P(), P(AXIS)),
            out_specs=(bufspec, P(AXIS), P(AXIS)),
        ),
        donate_argnums=(1,),
    )


@functools.lru_cache(maxsize=None)
def make_dist_drain_step(k: int, c_local: int, mesh: Mesh):
    """Grouped-counting drain: per-device group sort + dedup + lean merge.

    Keys arrived owner-partitioned, so each device's group sort/dedup IS the
    global dedup for its key range, and the merge into its spectrum shard is
    purely local — no collective. ONE L-operand sort of T_loc rows per group
    per device replaces bpg per-batch (capacity + slab) sorts.

    Signature: (buf tuple sharded, limbs [n_dev*c_local, L], counts, n [n_dev])
             -> (limbs', counts', n', over [n_dev] int32).
    """
    L = keys.nlimbs(k)

    def local_drain(buf, acc_limbs, acc_counts, acc_n):
        s = jax.lax.sort(list(buf), num_keys=L, is_stable=False)
        grp, over = oneshot_reduce(s, c_local)
        local = Spectrum(acc_limbs, acc_counts, acc_n[0])
        merged = merge_lean_body(local, grp, k)
        return (
            merged.limbs,
            merged.counts,
            merged.n[None],
            over.astype(jnp.int32)[None],
        )

    bufspec = tuple(P(AXIS) for _ in range(L))
    # buf is NOT donated: its T-row buffers cannot alias the capacity-sized
    # outputs (XLA donation is output-aliasing only — a donated-but-unaliased
    # buffer is a warning and a no-op). The caller drops
    # its buf reference right after the call, which frees it just as early.
    return jax.jit(
        jax.shard_map(
            local_drain,
            mesh=mesh,
            in_specs=(bufspec, P(AXIS), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        ),
        donate_argnums=(1, 2),
    )


@functools.lru_cache(maxsize=None)
def make_buf_alloc(t_total: int, nlimbs: int, mesh: Mesh):
    """Sharded sentinel group-buffer allocator (no host-side giant array)."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P_

    sh = NamedSharding(mesh, P_(AXIS))
    return jax.jit(
        lambda: tuple(
            jnp.full((t_total,), jnp.uint32(0xFFFFFFFF))
            for _ in range(nlimbs)
        ),
        out_shardings=tuple(sh for _ in range(nlimbs)),
    )


@functools.lru_cache(maxsize=None)
def make_gather_spectrum(out_capacity: int, mesh: Mesh):
    """Build the jit'd merge of a DistSpectrum into one replicated Spectrum.

    Shard keys are disjoint across devices, so a single global sort-merge with
    count weights reproduces exact global counts. The jit boundary's replicated
    in_shardings IS the all_gather of the surviving spectrum (SPEC D5).
    """
    from jax.sharding import NamedSharding

    repl = NamedSharding(mesh, P())

    @jax.jit
    def _gather(d: DistSpectrum) -> Spectrum:
        total, L = d.limbs.shape
        n_dev = d.n.shape[0]
        c_local = total // n_dev
        slot = jnp.arange(c_local, dtype=jnp.int32)
        valid = (slot[None, :] < d.n[:, None]).reshape(total)
        from tpu_euler.kmer.count import _unique_counts

        uniq, counts, n = _unique_counts(d.limbs, valid, d.counts)
        return Spectrum(uniq[:out_capacity], counts[:out_capacity], jnp.minimum(n, out_capacity))

    def gather(d: DistSpectrum) -> Spectrum:
        # Physically replicate the (small, post-exchange) shards first — this IS
        # the SPEC D5 all_gather; the merge then runs on replicated arrays.
        d = jax.device_put(
            d, DistSpectrum(limbs=repl, counts=repl, n=repl, dropped=repl)
        )
        return _gather(d)

    return gather
