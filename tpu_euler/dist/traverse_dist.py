"""Fully sharded graph construction + unitig traversal (SPEC configs 4-5).

The spectrum stays sharded by canonical-k-mer hash owner after counting and
cutoff; every traversal array lives at O(E / n_dev) per device:

1. **Successor assignment by node-record exchange** (the sharded R6/R7): each
   local edge emits two records — (tail-key, OUT, gid, lastbase) and
   (head-key, IN, gid, lastbase) — routed to the node-key's hash owner by
   all_to_all slabs. The owner sorts its records by key (out-records first in
   each group), computes in/out-degrees with cumsum-diff counting, and replies
   along the same slab positions: IN-records of simple nodes get (succ gid,
   succ lastbase); OUT-records get a tail-is-simple flag (= "you have a
   predecessor").
2. **Doubling over shards**: the fused cycle-detect + min-transition loop and
   Wyllie ranking run exactly as on one device (euler/unitigs.py), with the
   packed-state row gather replaced by ``exchange_gather`` over global edge
   ids (log2(E) rounds of request/reply all_to_alls over ICI/DCN).
3. **Cycle cutting** is local (each edge knows its transition key and the
   cycle min); the new chain-start flags are pushed to cut edges' successors
   with ``exchange_push``.
4. **Positions**: a second Wyllie pass over *predecessor* pointers (returned
   by the same node-record exchange) gives each edge its distance from the
   chain start directly — pointer fetches stay hash-balanced, unlike pulling a
   per-chain length from the single chain-owner device.

The result is per-edge (chain gid, pos, lastbase) on each shard; host
assembly concatenates per-shard contig fragments (O(E/n) per host). All slab
overflows are counted and psum'd so imbalance fails loudly.
"""

from __future__ import annotations

from typing import NamedTuple

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from tpu_euler.dist.exchange import exchange_gather, exchange_push
from tpu_euler.dist.mesh import AXIS
from tpu_euler.kmer import keys
from tpu_euler.kmer.count import segment_sums_sorted

_SENT = jnp.uint32(0xFFFFFFFF)


class ShardChains(NamedTuple):
    """Per-shard traversal output (global shapes [n_dev * el_cap, ...])."""

    edge_limbs: jax.Array  # [N, L] uint32 local edge k-mers
    valid: jax.Array  # [N] bool
    chain: jax.Array  # [N] int32 global chain id (end-edge gid)
    pos: jax.Array  # [N] int32 position from chain start
    is_start: jax.Array  # [N] bool
    tail_dead: jax.Array  # [N] bool — edge's tail node has in-degree 0
    head_dead: jax.Array  # [N] bool — edge's head node has out-degree 0
    on_cycle: jax.Array  # [N] bool — edge lay on a pure cycle before cutting
    dropped: jax.Array  # [n_dev] int32 slab drops (must be 0)


def _log2_ceil(n: int) -> int:
    return max(1, (n - 1).bit_length())


def _node_record_exchange(edge_limbs, valid, k, n_dev, el_cap, c_node):
    """Phase 1: distributed successor assignment. Returns
    (succ_gid [el_cap] i32, succ_lastb [el_cap] u32, has_pred [el_cap] bool,
    n_dropped)."""
    L = edge_limbs.shape[1]
    my = jax.lax.axis_index(AXIS).astype(jnp.int32)
    eid = jnp.arange(el_cap, dtype=jnp.int32)
    gid = my * el_cap + eid

    pre = keys.prefix(edge_limbs, k)
    suf = keys.suffix(edge_limbs, k)
    lastb = keys.last_base(edge_limbs).astype(jnp.uint32)

    # records: first el_cap = OUT (key=tail/prefix), second el_cap = IN (head/suffix)
    rkeys = jnp.concatenate([pre, suf], axis=0)  # [2C, L]
    r_isout = jnp.concatenate(
        [jnp.ones((el_cap,), jnp.uint32), jnp.zeros((el_cap,), jnp.uint32)]
    )
    r_gid = jnp.concatenate([gid, gid])
    r_lastb = jnp.concatenate([lastb, lastb])
    r_valid = jnp.concatenate([valid, valid])
    M = 2 * el_cap

    owner = (keys.bucket_hash(rkeys) % jnp.uint32(n_dev)).astype(jnp.uint32)
    owner = jnp.where(r_valid, owner, n_dev)
    slot = jnp.arange(M, dtype=jnp.int32)
    sortout = jax.lax.sort(
        [owner, slot]
        + [rkeys[:, j] for j in range(L)]
        + [r_isout, r_gid, r_lastb],
        num_keys=1,
        is_stable=True,
    )
    so, sslot = sortout[0].astype(jnp.int32), sortout[1]
    skeys = jnp.stack(sortout[2 : 2 + L], axis=-1)
    sisout, sgid, slastb = sortout[2 + L], sortout[3 + L], sortout[4 + L]
    idx = jnp.arange(M, dtype=jnp.int32)
    seg_start = jnp.full((n_dev + 1,), M, jnp.int32).at[so].min(idx)
    pos = idx - seg_start[jnp.clip(so, 0, n_dev)]
    ok = (so < n_dev) & (pos < c_node)
    n_drop1 = jnp.sum((so < n_dev) & ~ok)
    slab_pos = jnp.where(ok, so * c_node + pos, n_dev * c_node)

    def to_slab(x, fill=0):
        base = jnp.full((n_dev * c_node,) + x.shape[1:], fill, x.dtype)
        return base.at[slab_pos].set(x, mode="drop")

    slab = jnp.concatenate(
        [
            to_slab(skeys),
            to_slab(sisout)[:, None],
            to_slab(sgid.astype(jnp.int32).astype(jnp.uint32), fill=_SENT)[:, None],
            to_slab(slastb)[:, None],
        ],
        axis=1,
    )  # [n*c_node, L+3]
    recv = jax.lax.all_to_all(slab, AXIS, split_axis=0, concat_axis=0, tiled=True)

    # --- serve: group by node key, compute degrees, pair in->out ---
    Mr = recv.shape[0]
    g_keys = recv[:, :L]
    g_isout = recv[:, L]
    g_gid = recv[:, L + 1]
    g_lastb = recv[:, L + 2]
    g_valid = g_gid != _SENT
    inv = (~g_valid).astype(jnp.uint32)
    rid = jnp.arange(Mr, dtype=jnp.int32)
    out2 = jax.lax.sort(
        [inv]
        + [g_keys[:, j] for j in range(L)]
        + [jnp.uint32(1) - g_isout, rid, g_gid, g_lastb],
        num_keys=L + 2,
        is_stable=True,
    )
    t_inv = out2[0]
    t_keys = jnp.stack(out2[1 : 1 + L], axis=-1)
    t_in_last = out2[1 + L]  # 0 for out-records, 1 for in-records
    t_rid, t_gid, t_lastb = out2[2 + L], out2[3 + L], out2[4 + L]
    t_valid = t_inv == 0
    prev = jnp.roll(t_keys, 1, axis=0)
    is_new = (~keys.key_eq(t_keys, prev)).at[0].set(True) & t_valid
    seg = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    w_out = jnp.where(t_valid & (t_in_last == 0), 1, 0).astype(jnp.int32)
    w_in = jnp.where(t_valid & (t_in_last == 1), 1, 0).astype(jnp.int32)
    outdeg = segment_sums_sorted(is_new, seg, w_out, Mr)
    indeg = segment_sums_sorted(is_new, seg, w_in, Mr)
    gstart = jnp.full((Mr + 1,), Mr, jnp.int32).at[
        jnp.where(is_new, seg, Mr)
    ].set(jnp.arange(Mr, dtype=jnp.int32), mode="drop")
    segc = jnp.clip(seg, 0, Mr - 1)
    simple = (outdeg[segc] == 1) & (indeg[segc] == 1) & t_valid
    first = jnp.clip(gstart[segc], 0, Mr - 1)
    # in-record of a simple node: partner out-record is the group's first row.
    # Reply columns are interpreted per record type (the requester knows which
    # half each record came from): IN: [succ_gid, succ_lastb, head_outdeg0, -];
    # OUT: [tail_indeg0, -, haspred, pred_gid].
    is_inrec = t_valid & (t_in_last == 1)
    is_outrec = t_valid & (t_in_last == 0)
    succ_gid_v = jnp.where(is_inrec & simple, t_gid[first], _SENT)
    succ_gid_v = jnp.where(
        is_outrec, jnp.where(indeg[segc] == 0, jnp.uint32(1), 0), succ_gid_v
    )
    succ_lb_v = jnp.where(is_inrec & simple, t_lastb[first], 0)
    second = jnp.clip(first + 1, 0, Mr - 1)
    haspred_v = jnp.where(is_outrec & simple, jnp.uint32(1), 0)
    haspred_v = jnp.where(
        is_inrec, jnp.where(outdeg[segc] == 0, jnp.uint32(1), 0), haspred_v
    )
    pred_gid_v = jnp.where(is_outrec & simple, t_gid[second], _SENT)
    # route reply values back to slab order
    reply = jnp.zeros((Mr, 4), jnp.uint32)
    reply = reply.at[t_rid].set(
        jnp.stack([succ_gid_v, succ_lb_v, haspred_v, pred_gid_v], axis=1)
    )
    reply_back = jax.lax.all_to_all(
        reply, AXIS, split_axis=0, concat_axis=0, tiled=True
    )

    # unpack: my request at slab_pos p gets reply_back[p]; scatter to sorted slot
    got = reply_back[jnp.clip(slab_pos, 0, n_dev * c_node - 1)]
    got = jnp.where(
        ok[:, None], got, jnp.asarray([_SENT, 0, 0, _SENT], jnp.uint32)[None, :]
    )
    per_record = jnp.zeros((M, 4), jnp.uint32).at[sslot].set(got)
    out_replies = per_record[:el_cap]  # OUT records -> tail flags + pred gid
    in_replies = per_record[el_cap:]  # IN records -> succ info + head flag
    succ_gid = jnp.where(
        valid & (in_replies[:, 0] != _SENT), in_replies[:, 0].astype(jnp.int32), -1
    )
    succ_lastb = in_replies[:, 1]
    has_pred = valid & (out_replies[:, 2] == 1)
    pred_gid = jnp.where(
        valid & (out_replies[:, 3] != _SENT), out_replies[:, 3].astype(jnp.int32), -1
    )
    tail_dead = valid & (out_replies[:, 0] == 1)
    head_dead = valid & (in_replies[:, 2] == 1)
    return succ_gid, succ_lastb, has_pred, pred_gid, tail_dead, head_dead, n_drop1


@functools.lru_cache(maxsize=None)
def make_dist_chains_step(
    k: int,
    n_dev: int,
    c_local: int,
    mesh: Mesh,
    slab_factor: float = 2.0,
):
    """Build the jit'd shard_map step: sharded spectrum -> ShardChains."""
    el_cap = 2 * c_local
    L = keys.nlimbs(k)
    E_global = n_dev * el_cap
    rounds = _log2_ceil(E_global) + 1
    c_node = int(slab_factor * 4 * c_local / n_dev) + 256
    c_req = int(slab_factor * el_cap / n_dev) + 256

    def local_step(spec_limbs, spec_counts, spec_n):
        n = spec_n[0]
        my = jax.lax.axis_index(AXIS).astype(jnp.int32)
        eid = jnp.arange(el_cap, dtype=jnp.int32)
        gid = my * el_cap + eid
        iota_c = jnp.arange(c_local, dtype=jnp.int32)
        row_valid = iota_c < n
        edge_limbs = jnp.concatenate(
            [spec_limbs, keys.revcomp(spec_limbs, k)], axis=0
        )
        valid = jnp.concatenate([row_valid, row_valid])

        succ, succ_lastb, has_pred, pred, tail_dead, head_dead, d1 = (
            _node_record_exchange(edge_limbs, valid, k, n_dev, el_cap, c_node)
        )

        # transition keys (for cycle cutting)
        t = keys.append_base(edge_limbs, succ_lastb, k)
        t, _ = keys.canonical(t, k + 1)
        t = jnp.where((succ >= 0)[:, None], t, _SENT)

        # fused cycle-detect + min-transition doubling over shards
        p0 = jnp.where(succ >= 0, succ.astype(jnp.uint32), _SENT)
        state = jnp.concatenate([p0[:, None], t], axis=1)
        drops = d1

        def detect_round(_, carry):
            state, drops = carry
            p = state[:, 0]
            alive = p != _SENT
            rows, dr = exchange_gather(
                state,
                jnp.where(alive, p.astype(jnp.int32), -1),
                n_dev,
                el_cap,
                c_req,
            )
            p_new = jnp.where(alive, rows[:, 0], _SENT)
            m_nxt = jnp.where(alive[:, None], rows[:, 1:], _SENT)
            take = keys.key_less(m_nxt, state[:, 1:], k + 1)
            m_new = jnp.where(take[:, None], m_nxt, state[:, 1:])
            return jnp.concatenate([p_new[:, None], m_new], axis=1), drops + dr

        state, drops = jax.lax.fori_loop(0, rounds, detect_round, (state, drops))
        on_cycle = (state[:, 0] != _SENT) & valid
        is_cut = on_cycle & keys.key_eq(t, state[:, 1:])
        succ_cut = jnp.where(is_cut, -1, succ)

        # push start flags to cut edges' successors
        started, dp = exchange_push(
            jnp.ones((el_cap, 1), jnp.uint32),
            jnp.where(is_cut, succ, -1),
            n_dev,
            el_cap,
            c_req,
        )
        drops = drops + dp
        is_start = valid & (~has_pred | (started[:, 0] == 1))
        pred_cut = jnp.where(is_start, -1, pred)

        def wyllie(ptr, drops):
            """Doubling over shards: returns (steps-to-terminal d, terminal gid).

            Dead rows fetch nothing (their q is already final) — critical for
            slab balance: self-requests would all target one device.
            """
            p0 = jnp.where(ptr >= 0, ptr.astype(jnp.uint32), _SENT)
            d0 = jnp.where(ptr >= 0, 1, 0).astype(jnp.uint32)
            q0 = jnp.where(ptr >= 0, ptr.astype(jnp.uint32), gid.astype(jnp.uint32))
            S = jnp.stack([p0, d0, q0], axis=1)

            def rank_round(_, carry):
                S, drops = carry
                p = S[:, 0]
                alive = p != _SENT
                fetch = jnp.where(alive, p.astype(jnp.int32), -1)
                rows, dr = exchange_gather(S, fetch, n_dev, el_cap, c_req)
                p_new = jnp.where(alive, rows[:, 0], _SENT)
                d_new = S[:, 1] + jnp.where(alive, rows[:, 1], 0)
                q_new = jnp.where(alive, rows[:, 2], S[:, 2])
                return jnp.stack([p_new, d_new, q_new], axis=1), drops + dr

            S, drops = jax.lax.fori_loop(0, rounds, rank_round, (S, drops))
            return S[:, 1].astype(jnp.int32), S[:, 2].astype(jnp.int32), drops

        # forward pass -> chain id (end-edge gid); backward pass -> position
        _, end_gid, drops = wyllie(succ_cut, drops)
        pos, _, drops = wyllie(pred_cut, drops)

        return ShardChains(
            edge_limbs=edge_limbs,
            valid=valid,
            chain=jnp.where(valid, end_gid, -1),
            pos=jnp.where(valid, pos, 0),
            is_start=is_start,
            tail_dead=tail_dead,
            head_dead=head_dead,
            on_cycle=on_cycle,
            dropped=drops[None],
        )

    out_specs = ShardChains(
        edge_limbs=P(AXIS),
        valid=P(AXIS),
        chain=P(AXIS),
        pos=P(AXIS),
        is_start=P(AXIS),
        tail_dead=P(AXIS),
        head_dead=P(AXIS),
        on_cycle=P(AXIS),
        dropped=P(AXIS),
    )
    return jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS)),
            out_specs=out_specs,
        )
    )


@functools.lru_cache(maxsize=None)
def make_dist_cutoff_step(min_count: int, mesh: Mesh):
    """Per-shard frequency cutoff (counts are already exact global counts)."""
    from tpu_euler.kmer.count import Spectrum, apply_cutoff

    def local(limbs, counts, n):
        spec = apply_cutoff(Spectrum(limbs, counts, n[0]), min_count)
        return spec.limbs, spec.counts, spec.n[None]

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS), P(AXIS), P(AXIS)),
        )
    )


def local_chain_fragments(sc: ShardChains, k: int) -> dict:
    """Per-PROCESS contig fragments from ONLY this process's shards.

    D2H is restricted to addressable shards — O(E/n_proc) per host, never the
    global edge arrays. The output is compact per-edge material (9 B/edge:
    chain id, position, one base byte) plus the (k-1)-base prefixes of locally
    held chain-START edges — everything any assembler of the full contigs
    needs from this process. ``d2h_bytes`` records exactly how many device
    bytes this process pulled (asserted O(E/n) in multiprocess_test.py).

    Returns dict(chain, pos, base, start_chain, start_prefix, d2h_bytes).
    """
    import numpy as np

    d2h = 0

    def local_np(a):
        nonlocal d2h
        shards = sorted(
            a.addressable_shards, key=lambda s: (s.index[0].start or 0)
        )
        parts = [np.asarray(s.data) for s in shards]
        d2h += sum(p.nbytes for p in parts)
        return np.concatenate(parts, axis=0)

    valid = local_np(sc.valid)
    idx = np.flatnonzero(valid)
    chain = local_np(sc.chain)[idx]
    pos = local_np(sc.pos)[idx]
    is_start = local_np(sc.is_start)[idx]
    limbs = local_np(sc.edge_limbs)[idx]
    base = (limbs[:, -1] & 3).astype(np.uint8)
    starts = np.flatnonzero(is_start)
    from tpu_euler.euler.extract import decode_bases_np

    start_prefix = (
        decode_bases_np(limbs[starts], k - 1, k)
        if starts.size
        else np.zeros((0, k - 1), np.uint8)
    )
    return dict(
        chain=chain.astype(np.int64),
        pos=pos.astype(np.int64),
        base=base,
        start_chain=chain[starts].astype(np.int64),
        start_prefix=start_prefix,
        d2h_bytes=d2h,
    )


def assemble_contig_fragments(frags: list[dict], k: int) -> set[bytes]:
    """Merge per-process fragment dicts into the canonical contig set.

    Pure host numpy; input volume is ~9 B/edge + prefixes, i.e. the contig
    bytes themselves plus O(#chains * k) — not the O(24+ B/edge) device
    arrays the old allgather pulled to every host.
    """
    import numpy as np

    from tpu_euler.euler.extract import _BASES, canonicalize_contig_buffer

    chain = np.concatenate([f["chain"] for f in frags])
    if chain.size == 0:
        return set()
    pos = np.concatenate([f["pos"] for f in frags])
    base = np.concatenate([f["base"] for f in frags])
    start_chain = np.concatenate([f["start_chain"] for f in frags])
    start_prefix = np.concatenate([f["start_prefix"] for f in frags], axis=0)

    uchain, dense = np.unique(chain, return_inverse=True)
    n_chains = uchain.size
    chain_len = np.zeros(n_chains, dtype=np.int64)
    np.maximum.at(chain_len, dense, pos + 1)
    out_len = chain_len + (k - 1)
    off = np.zeros(n_chains + 1, dtype=np.int64)
    np.cumsum(out_len, out=off[1:])
    buf = np.empty(off[-1], dtype=np.uint8)
    buf[off[dense] + (k - 1) + pos] = _BASES[base]
    sdense = np.searchsorted(uchain, start_chain)
    buf[off[sdense][:, None] + np.arange(k - 1)[None, :]] = start_prefix
    return canonicalize_contig_buffer(buf, off)


def shard_chains_to_contigs(sc: ShardChains, k: int) -> set[bytes]:
    """Host assembly of sharded chains into canonical contigs, O(E/n) D2H.

    Each process downloads ONLY its addressable shards and reduces them to
    compact fragments (local_chain_fragments). Multi-process runs exchange
    just those fragments (padded process_allgather of ~9 B/edge material, an
    order of magnitude below the former full-edge-array allgather) so every
    process can return the full canonical set; single-process runs skip the
    exchange entirely. Per-host part emission (no exchange at all) is
    available via local_chain_fragments directly.
    """
    import jax

    frag = local_chain_fragments(sc, k)
    if jax.process_count() > 1:
        frags = _allgather_fragments(frag, k)
    else:
        frags = [frag]
    return assemble_contig_fragments(frags, k)


def _allgather_fragments(frag: dict, k: int) -> list[dict]:
    """Exchange compact per-process fragments (ragged -> padded allgather)."""
    import numpy as np
    from jax.experimental import multihost_utils

    sizes = multihost_utils.process_allgather(
        np.array([frag["chain"].size, frag["start_chain"].size], np.int64)
    ).reshape(-1, 2)
    me, ms = int(sizes[:, 0].max()), int(sizes[:, 1].max())

    def pad(a, m, fill):
        out = np.full((m,) + a.shape[1:], fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    packed = np.concatenate(
        [
            pad(frag["chain"], me, -1)[:, None],
            pad(frag["pos"], me, 0)[:, None],
            pad(frag["base"], me, 0).astype(np.int64)[:, None],
        ],
        axis=1,
    )
    sp = np.concatenate(
        [
            pad(frag["start_chain"], ms, -1)[:, None],
            pad(frag["start_prefix"], ms, 0).astype(np.int64),
        ],
        axis=1,
    )
    all_packed = multihost_utils.process_allgather(packed)
    all_sp = multihost_utils.process_allgather(sp)
    frags = []
    for p in range(all_packed.shape[0]):
        n = int(sizes[p, 0])
        s = int(sizes[p, 1])
        frags.append(
            dict(
                chain=all_packed[p, :n, 0],
                pos=all_packed[p, :n, 1],
                base=all_packed[p, :n, 2].astype(np.uint8),
                start_chain=all_sp[p, :s, 0],
                start_prefix=all_sp[p, :s, 1:].astype(np.uint8),
                d2h_bytes=0,
            )
        )
    return frags


@functools.lru_cache(maxsize=None)
def make_dist_tip_step(
    tip_len: int, n_dev: int, c_local: int, mesh: Mesh, slab_factor: float = 2.0
):
    """On-device sharded tip identification — O(E/n_dev) per device.

    Semantics identical to find_tip_rows / euler.clean.clip_tips_once: a chain
    is a tip iff its edge count < tip_len and EXACTLY one end is dead. The
    chain's home is its end edge (chain id == end-edge gid), so the home slot
    already holds length (own pos+1) and head_dead; the start edge pushes its
    tail_dead to the home with one exchange_push, and every member edge reads
    the verdict back with one exchange_gather — two all_to_all rounds total,
    no host fetch of the shards (that path existed precisely for graphs too
    big to replicate).

    Returns jit'd step: (valid, chain, pos, tail_dead, head_dead) ->
    (keep_rows [n_dev * c_local] bool sharded, n_tips [n_dev], dropped [n_dev]).
    """
    el_cap = 2 * c_local
    c_req = int(slab_factor * el_cap / n_dev) + 256

    def local(valid, chain, pos, tail_dead, head_dead):
        my = jax.lax.axis_index(AXIS).astype(jnp.int32)
        eid = jnp.arange(el_cap, dtype=jnp.int32)
        gid = my * el_cap + eid
        is_start = valid & (pos == 0)
        ds, d1 = exchange_push(
            tail_dead.astype(jnp.uint32)[:, None],
            jnp.where(is_start, chain, -1),
            n_dev,
            el_cap,
            c_req,
            combine="max",
        )
        is_home = valid & (chain == gid)
        tip_home = (
            is_home & (pos + 1 < tip_len) & ((ds[:, 0] == 1) ^ head_dead)
        )
        tips, d2 = exchange_gather(
            tip_home.astype(jnp.uint32)[:, None],
            jnp.where(valid, chain, -1),
            n_dev,
            el_cap,
            c_req,
            fill=jnp.zeros((1,), jnp.uint32),
        )
        tip_edge = valid & (tips[:, 0] == 1)
        keep = ~(tip_edge[:c_local] | tip_edge[c_local:])
        n_tips = jax.lax.psum(jnp.sum(tip_edge.astype(jnp.int32)), AXIS)
        drops = jax.lax.psum(d1 + d2, AXIS)
        return keep, n_tips[None], drops[None]

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS), P(AXIS), P(AXIS)),
        )
    )


def find_tip_rows(sc: ShardChains, k: int, tip_len: int, c_local: int):
    """Host-side tip identification on sharded chains (semantics identical to
    reference_impl.oracle.find_tip_kmers / euler.clean.clip_tips_once).

    Kept as the cross-check oracle for make_dist_tip_step (tests assert the
    two agree); the pipeline uses the on-device step.

    Returns (keep_rows [n_dev * c_local] bool numpy, n_tip_edges).
    """
    import numpy as np

    from tpu_euler.dist.mesh import fetch_global

    valid = fetch_global(sc.valid)
    chain = fetch_global(sc.chain)
    pos = fetch_global(sc.pos)
    tail_dead = fetch_global(sc.tail_dead)
    head_dead = fetch_global(sc.head_dead)
    N = valid.shape[0]
    el_cap = 2 * c_local
    n_dev = N // el_cap

    idx = np.flatnonzero(valid)
    ch = chain[idx]
    uchain, dense = np.unique(ch, return_inverse=True)
    n_chains = uchain.size
    length = np.zeros(n_chains, np.int64)
    np.maximum.at(length, dense, pos[idx].astype(np.int64) + 1)
    ds = np.zeros(n_chains, bool)
    de = np.zeros(n_chains, bool)
    starts = pos[idx] == 0
    ds[dense[starts]] = tail_dead[idx][starts]
    ends = pos[idx].astype(np.int64) == length[dense] - 1
    de[dense[ends]] = head_dead[idx][ends]
    tip_chain = (length < tip_len) & (ds ^ de)

    tip_edge = np.zeros(N, bool)
    tip_edge[idx] = tip_chain[dense]
    # edge row i on shard s maps to spectrum row s*c_local + (i % el_cap) % c_local
    tip_edge = tip_edge.reshape(n_dev, 2, c_local)
    tip_row = tip_edge.any(axis=1).reshape(n_dev * c_local)
    keep = ~tip_row
    return keep, int(tip_edge.sum())


@functools.lru_cache(maxsize=None)
def make_dist_compact_step(mesh: Mesh):
    """Per-shard spectrum compaction by an external keep mask (tip removal)."""
    from tpu_euler.kmer.count import Spectrum

    def local(limbs, counts, n, keep):
        C = limbs.shape[0]
        valid_row = jnp.arange(C, dtype=jnp.int32) < n[0]
        k2 = keep & valid_row
        dest = jnp.cumsum(k2.astype(jnp.int32)) - 1
        dest = jnp.where(k2, dest, C)
        nl = jnp.zeros_like(limbs).at[dest].set(limbs, mode="drop")
        nc = jnp.zeros_like(counts).at[dest].set(counts, mode="drop")
        return nl, nc, jnp.sum(k2.astype(jnp.int32))[None]

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS), P(AXIS), P(AXIS)),
        )
    )


def make_dist_bubble_step(
    k: int,
    bubble_len: int,
    n_dev: int,
    c_local: int,
    mesh: Mesh,
    slab_factor: float = 2.0,
):
    """On-device SHARDED simple-bubble identification — O(E/n_dev) per device.

    Semantics identical to euler.clean.pop_bubbles_once / the CPU oracle's
    find_bubble_kmers: non-cycle unitig chains group by
    (start node u, end node v); a group with >= 2 chains, all shorter than
    ``bubble_len`` edges, pops every chain but the (coverage DESC, min
    canonical k-mer ASC) winner; a tie at the top skips the group. The
    sharded realisation:

    1. member edges push per-chain aggregates to the chain home (= end edge):
       coverage sum (``exchange_push`` combine="add") and the start edge's
       canonical tail (k-1)-mer (single-writer "max" push);
    2. the chain's minimum canonical k-mer is found EXACTLY (lexicographic
       over limbs) with L sequential push-min/gather rounds: limb j's
       candidates are masked to edges whose limbs < j already equal the
       group minimum;
    3. chain homes route (u, v, ~cov, minkey, len, gid) records to a
       hash(u, v) owner through fixed all_to_all slabs (the
       _node_record_exchange pattern); the owner sorts records by
       (u, v, ~cov, minkey) and marks every non-first record of qualifying
       groups popped — group disqualification (a member >= bubble_len, or a
       top-2 tie) via cumsum-based segment sums, no scatters;
    4. verdicts reply along the slabs; member edges read their chain's
       verdict with one exchange_gather (the tip-step pattern).

    The chain home's own ``on_cycle`` flag excludes cut-cycle chains: every
    edge of a cut cycle is on the cycle, so the home's flag is the chain's.

    Returns jit'd step over (edge_limbs, valid, chain, pos, is_start,
    on_cycle, counts) -> (keep_rows [n_dev*c_local] bool, n_popped [n_dev],
    dropped [n_dev]).
    """
    el_cap = 2 * c_local
    L = keys.nlimbs(k)
    c_req = int(slab_factor * el_cap / n_dev) + 256
    c_grp = int(slab_factor * el_cap / n_dev) + 256
    BIGU = jnp.uint32(0xFFFFFFFF)

    def local(edge_limbs, valid, chain, pos, is_start, on_cycle, counts):
        my = jax.lax.axis_index(AXIS).astype(jnp.int32)
        eid = jnp.arange(el_cap, dtype=jnp.int32)
        gid = my * el_cap + eid
        member = valid & ~on_cycle
        home = member & (chain == gid)
        drops = jnp.zeros((), jnp.int32)

        # canonical row key of each edge (rows >= c_local mirror rows < c_local)
        rk = jnp.concatenate(
            [edge_limbs[:c_local], edge_limbs[:c_local]], axis=0
        )
        cov_e = jnp.concatenate([counts, counts]).astype(jnp.uint32)

        # --- phase 1: cov sum + start-u to home ---
        covs, d = exchange_push(
            jnp.where(member, cov_e, 0)[:, None],
            jnp.where(member, chain, -1),
            n_dev, el_cap, c_req, combine="add",
        )
        drops = drops + d
        upre = keys.prefix(edge_limbs, k)
        ucan, _ = keys.canonical(upre, k - 1)
        u_home, d = exchange_push(
            jnp.where((is_start & member)[:, None], ucan, 0),
            jnp.where(is_start & member, chain, -1),
            n_dev, el_cap, c_req, combine="max",
        )
        drops = drops + d

        # --- phase 2: exact lexicographic min canonical k-mer, limb by limb ---
        pref_ok = member
        min_cols = []
        for j in range(L):
            mj, d = exchange_push(
                jnp.where(pref_ok, rk[:, j], BIGU)[:, None],
                jnp.where(member, chain, -1),
                n_dev, el_cap, c_req, combine="min",
            )
            drops = drops + d
            back, d = exchange_gather(
                mj, jnp.where(member, chain, -1), n_dev, el_cap, c_req,
                fill=jnp.full((1,), BIGU, jnp.uint32),
            )
            drops = drops + d
            pref_ok = pref_ok & (rk[:, j] == back[:, 0])
            min_cols.append(mj[:, 0])
        minkey = jnp.stack(min_cols, axis=-1)  # [el_cap, L] at homes

        # --- phase 3: route chain records to hash(u, v) group owners ---
        vsuf = keys.suffix(edge_limbs, k)
        vcan, _ = keys.canonical(vsuf, k - 1)
        uv = jnp.concatenate([u_home, vcan], axis=1)  # [el_cap, 2L]
        owner = (keys.bucket_hash(uv) % jnp.uint32(n_dev)).astype(jnp.uint32)
        owner = jnp.where(home, owner, n_dev)
        slot = jnp.arange(el_cap, dtype=jnp.int32)
        covneg = BIGU - covs[:, 0]  # ascending sort = coverage DESC
        clen = (pos + 1).astype(jnp.uint32)
        cols = (
            [uv[:, j] for j in range(2 * L)]
            + [covneg]
            + [minkey[:, j] for j in range(L)]
            + [clen, gid.astype(jnp.uint32)]
        )
        W = len(cols)  # 3L + 3
        sortout = jax.lax.sort(
            [owner, slot] + cols, num_keys=1, is_stable=True
        )
        so, sslot = sortout[0].astype(jnp.int32), sortout[1]
        idx = jnp.arange(el_cap, dtype=jnp.int32)
        seg_start = jnp.full((n_dev + 1,), el_cap, jnp.int32).at[so].min(idx)
        spos = idx - seg_start[jnp.clip(so, 0, n_dev)]
        ok = (so < n_dev) & (spos < c_grp)
        drops = drops + jnp.sum((so < n_dev) & ~ok)
        slab_pos = jnp.where(ok, so * c_grp + spos, n_dev * c_grp)
        slab = jnp.full((n_dev * c_grp, W + 1), BIGU, jnp.uint32)
        svals = jnp.stack(
            [sortout[2 + i] for i in range(W)]
            + [jnp.where(sortout[0] < n_dev, jnp.uint32(0), BIGU)],
            axis=1,
        )
        slab = slab.at[slab_pos].set(svals, mode="drop")
        recv = jax.lax.all_to_all(
            slab, AXIS, split_axis=0, concat_axis=0, tiled=True
        )

        # --- owner: sort by (u, v, ~cov, minkey), mark non-winners ---
        Mr = recv.shape[0]
        r_inv = recv[:, W]  # 0 = real record, BIGU = padding
        rid = jnp.arange(Mr, dtype=jnp.int32)
        out2 = jax.lax.sort(
            [r_inv]
            + [recv[:, i] for i in range(3 * L + 1)]  # u, v, ~cov, minkey
            + [rid, recv[:, 3 * L + 1], recv[:, 3 * L + 2]],
            num_keys=2 + 3 * L,
            is_stable=True,
        )
        t_valid = out2[0] == 0
        t_u = jnp.stack(out2[1 : 1 + L], axis=-1)
        t_v = jnp.stack(out2[1 + L : 1 + 2 * L], axis=-1)
        t_covneg = out2[1 + 2 * L]
        t_min = jnp.stack(out2[2 + 2 * L : 2 + 3 * L], axis=-1)
        t_rid = out2[2 + 3 * L]
        t_len = out2[3 + 3 * L]
        prev_same = (
            keys.key_eq(t_u, jnp.roll(t_u, 1, axis=0))
            & keys.key_eq(t_v, jnp.roll(t_v, 1, axis=0))
            & t_valid
        ).at[0].set(False)
        is_new = (~prev_same) & t_valid
        seg = jnp.cumsum(is_new.astype(jnp.int32)) - 1
        # disqualify: any member >= bubble_len (cumsum segment sums, no scatter)
        big = jnp.where(
            t_valid & (t_len >= jnp.uint32(bubble_len)), 1, 0
        ).astype(jnp.int32)
        seg_big = segment_sums_sorted(is_new, seg, big, Mr)
        # tie at the top poisons the group
        second = prev_same & ~jnp.roll(prev_same, 1).at[0].set(False)
        tie = (
            second
            & (t_covneg == jnp.roll(t_covneg, 1))
            & keys.key_eq(t_min, jnp.roll(t_min, 1, axis=0))
        )
        seg_tie = segment_sums_sorted(is_new, seg, tie.astype(jnp.int32), Mr)
        segc = jnp.clip(seg, 0, Mr - 1)
        pop_sorted = (
            t_valid
            & prev_same
            & (seg_big[segc] == 0)
            & (seg_tie[segc] == 0)
        )
        reply = jnp.zeros((Mr, 1), jnp.uint32).at[t_rid].set(
            pop_sorted.astype(jnp.uint32)[:, None], mode="drop"
        )
        reply_back = jax.lax.all_to_all(
            reply, AXIS, split_axis=0, concat_axis=0, tiled=True
        )
        got = reply_back[jnp.clip(slab_pos, 0, n_dev * c_grp - 1)][:, 0]
        got = jnp.where(ok, got, 0)
        popped_home = jnp.zeros((el_cap,), jnp.uint32).at[sslot].set(got)

        # --- phase 4: members read their chain's verdict ---
        verdict, d = exchange_gather(
            popped_home[:, None],
            jnp.where(member, chain, -1),
            n_dev, el_cap, c_req,
            fill=jnp.zeros((1,), jnp.uint32),
        )
        drops = drops + d
        pop_edge = member & (verdict[:, 0] == 1)
        keep = ~(pop_edge[:c_local] | pop_edge[c_local:])
        n_popped = jax.lax.psum(jnp.sum(pop_edge.astype(jnp.int32)), AXIS)
        drops = jax.lax.psum(drops, AXIS)
        return keep, n_popped[None], drops[None]

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(AXIS),) * 7,
            out_specs=(P(AXIS), P(AXIS), P(AXIS)),
        )
    )
