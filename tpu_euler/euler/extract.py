"""Chain -> contig sequence emission.

Reference counterpart: SURVEY.md R10/R11 (tour walk + FASTA write, D2H copy then
host walk). Two implementations:

* ``chains_to_contigs`` (host): download per-edge arrays, one vectorized numpy
  scatter into a byte buffer. Simple; D2H volume is O(E) — fine for tests.
* ``chains_to_contigs_device`` (device): the edge->byte scatter happens on the
  device — edges are sorted by (chain, pos), per-chain output offsets come from an
  exclusive scan, and one scatter writes every edge's last base into a dense
  uint8 contig buffer. Only O(total contig bases) crosses to host (~35x less
  than the host path at benchmark scale), where (k-1)-base chain prefixes are
  stitched in and sequences canonicalized.

Canonicalization (min of sequence and reverse complement, SPEC correctness bar)
and dedup happen on host bytes in both paths; results are identical.
"""

from __future__ import annotations

import functools
import logging
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_euler.euler.unitigs import UnitigChains
from tpu_euler.graph.build import DeBruijnGraph

log = logging.getLogger("tpu_euler")

#: incremented whenever the device emission overflowed its capacity and fell
#: back to the O(E)-D2H host path (read by the CLI metrics; reset at will)
HOST_FALLBACKS = 0

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_RC_TABLE = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _RC_TABLE[_a] = _b


def rc_bytes(seq: np.ndarray) -> np.ndarray:
    return _RC_TABLE[seq][::-1]


def canonicalize_contig_buffer(buf: np.ndarray, off: np.ndarray) -> set[bytes]:
    """Canonical contig set from a flat ASCII base buffer + [n+1] offsets.

    Fully vectorized canonicalization (min of sequence and reverse complement
    per contig) — no per-contig numpy work, so emission stays fast when a
    fragmented assembly produces millions of unitigs (SURVEY.md R10/R11):
    the reverse complement of contig c at global byte j is the complement of
    the mirrored byte off[c] + off[c+1] - 1 - j, computed for ALL contigs with
    one gather; fwd-vs-rc is decided by each contig's first fwd/rc mismatch
    (flatnonzero + searchsorted, no Python loop). Only the final set of
    ``bytes`` objects is built per contig.
    """
    n = off.size - 1
    if n == 0:
        return set()
    if n <= 256:
        # few (typically huge) contigs: per-contig numpy beats building the
        # byte-granular cid/mirror index arrays below (one pass per contig vs
        # ~6 int64 passes over every byte)
        out = set()
        for c in range(n):
            seq = buf[off[c] : off[c + 1]]
            fwd = seq.tobytes()
            rev = rc_bytes(seq).tobytes()
            out.add(fwd if fwd <= rev else rev)
        return out
    total = int(off[-1])
    lens = np.diff(off)
    cid = np.repeat(np.arange(n, dtype=np.int64), lens)
    j = np.arange(total, dtype=np.int64)
    mirror = off[cid] + off[cid + 1] - 1 - j
    comp = _RC_TABLE[buf[mirror]]  # comp[j] = rc(contig)[local j]
    neq = np.flatnonzero(buf != comp)
    pos = np.searchsorted(neq, off[:-1])
    cand = neq[np.minimum(pos, max(neq.size - 1, 0))] if neq.size else np.zeros(n, np.int64)
    has = (pos < neq.size) & (cand < off[1:])
    take_rc = np.zeros(n, bool)
    take_rc[has] = comp[cand[has]] < buf[cand[has]]
    out = np.where(take_rc[cid], comp, buf)
    return {out[off[c] : off[c + 1]].tobytes() for c in range(n)}


def decode_bases_np(limbs: np.ndarray, n_bases: int, k: int) -> np.ndarray:
    """Decode the FIRST n_bases of right-aligned 2k-bit keys. [N, L] -> [N, n_bases]."""
    N, L = limbs.shape
    out = np.empty((N, n_bases), dtype=np.uint8)
    limbs64 = limbs.astype(np.uint64)
    for i in range(n_bases):
        bit = 2 * (k - 1 - i)  # bit offset of base i from LSB
        lj = L - 1 - bit // 32
        sh = np.uint64(bit % 32)
        code = (limbs64[:, lj] >> sh) & np.uint64(3)
        out[:, i] = _BASES[code.astype(np.int64)]
    return out


class DeviceEmission(NamedTuple):
    """Device-side contig buffer + per-chain tables (capacity-padded)."""

    buf: jax.Array  # [out_capacity] uint8 base codes (0..3)
    chain_off: jax.Array  # [chain_capacity] int32 byte offset of each chain
    chain_len: jax.Array  # [chain_capacity] int32 total bytes (k-1+edges)
    start_limbs: jax.Array  # [chain_capacity, L] start edge key (for the prefix)
    n_chains: jax.Array  # [] int32
    total: jax.Array  # [] int32 total bytes used


def _edge_limbs_of(g) -> jax.Array:
    """Accept either a DeBruijnGraph or the bare edge-key array.

    Emission touches nothing but the edge keys; taking them bare lets
    memory-bound callers free the rest of the graph first.
    """
    return g.edge_limbs if isinstance(g, DeBruijnGraph) else g


@functools.partial(jax.jit, static_argnames=("k", "out_capacity", "chain_capacity"))
def emit_chains_device(
    edge_limbs: jax.Array,
    chains: UnitigChains,
    k: int,
    out_capacity: int,
    chain_capacity: int,
) -> DeviceEmission:
    """Assemble all contig bytes on device; see module docstring.

    SORT-FREE: a chain's id IS its end-edge id, so per-chain output offsets
    come from one exclusive cumsum of (length + k-1) over end-edge slots, and
    every edge finds its chain's offset/rank with a single gather at
    chains.chain — no (chain, pos) edge sort. Chains are laid out in
    end-edge-id order (ascending offsets, as canonicalize_contig_buffer
    expects).
    """
    E, L = edge_limbs.shape
    eid = jnp.arange(E, dtype=jnp.int32)
    valid = chains.in_chain
    is_rep = valid & (chains.chain == eid)  # this edge ends its own chain
    is_start = valid & (chains.pos == 0)

    contrib = jnp.where(is_rep, chains.length + (k - 1), 0)
    cs = jnp.cumsum(contrib) - contrib  # exclusive: offset at end-edge slots
    total = cs[-1] + contrib[-1]
    rank = jnp.cumsum(is_rep.astype(jnp.int32)) - 1  # chain rank at end slots

    cid = jnp.clip(chains.chain, 0, E - 1)
    chain_off = cs[cid]  # per-edge: its chain's byte offset

    # scatter every edge's last base into the buffer
    out_pos = chain_off + (k - 1) + chains.pos
    lastb = (edge_limbs[:, L - 1] & jnp.uint32(3)).astype(jnp.uint8)
    dest = jnp.where(valid & (out_pos < out_capacity), out_pos, out_capacity)
    buf = jnp.zeros((out_capacity,), jnp.uint8).at[dest].set(lastb, mode="drop")

    # compact per-chain tables at the chain's rank (gathered via its end edge)
    crank_end = jnp.where(is_rep, rank, chain_capacity)
    chain_off_t = (
        jnp.zeros((chain_capacity,), jnp.int32).at[crank_end].set(cs, mode="drop")
    )
    chain_len_t = (
        jnp.zeros((chain_capacity,), jnp.int32)
        .at[crank_end]
        .set(chains.length + (k - 1), mode="drop")
    )
    crank_start = jnp.where(is_start, rank[cid], chain_capacity)
    start_limbs = (
        jnp.zeros((chain_capacity, L), jnp.uint32)
        .at[crank_start]
        .set(edge_limbs, mode="drop")
    )
    return DeviceEmission(
        buf=buf,
        chain_off=chain_off_t,
        chain_len=chain_len_t,
        start_limbs=start_limbs,
        n_chains=jnp.sum(is_rep.astype(jnp.int32)),
        total=total,
    )


@functools.partial(jax.jit, static_argnames=("k", "out_capacity", "chain_capacity"))
def emit_chains_device_spec(
    spec_limbs: jax.Array,
    chains: UnitigChains,
    k: int,
    out_capacity: int,
    chain_capacity: int,
) -> DeviceEmission:
    """``emit_chains_device`` over the VIRTUAL doubled edge array.

    Never materializes [E, L] edge keys: per-edge last bases come from two
    sequential column reads of the spectrum (row r < C: its own last base;
    row r >= C: complement of forward row r-C's FIRST base — the revcomp's
    last base), and chain-start keys are gathered for the chain_capacity
    start edges only (scatter the edge id, gather + revcomp the few rows)
    instead of scattering all E rows.
    """
    from tpu_euler.graph.build import gather_edge_rows
    from tpu_euler.kmer import keys as kk

    C, L = spec_limbs.shape
    E = 2 * C
    eid = jnp.arange(E, dtype=jnp.int32)
    valid = chains.in_chain
    is_rep = valid & (chains.chain == eid)
    is_start = valid & (chains.pos == 0)

    contrib = jnp.where(is_rep, chains.length + (k - 1), 0)
    cs = jnp.cumsum(contrib) - contrib
    total = cs[-1] + contrib[-1]
    rank = jnp.cumsum(is_rep.astype(jnp.int32)) - 1

    cid = jnp.clip(chains.chain, 0, E - 1)
    chain_off = cs[cid]

    out_pos = chain_off + (k - 1) + chains.pos
    tb = 2 * k - 32 * (L - 1)  # bits used in limb 0
    fw_last = (spec_limbs[:, L - 1] & jnp.uint32(3)).astype(jnp.uint8)
    fw_first = (
        (spec_limbs[:, 0] >> jnp.uint32(tb - 2)) & jnp.uint32(3)
    ).astype(jnp.uint8)
    lastb = jnp.concatenate([fw_last, jnp.uint8(3) - fw_first])
    dest = jnp.where(valid & (out_pos < out_capacity), out_pos, out_capacity)
    buf = jnp.zeros((out_capacity,), jnp.uint8).at[dest].set(lastb, mode="drop")

    crank_end = jnp.where(is_rep, rank, chain_capacity)
    chain_off_t = (
        jnp.zeros((chain_capacity,), jnp.int32).at[crank_end].set(cs, mode="drop")
    )
    chain_len_t = (
        jnp.zeros((chain_capacity,), jnp.int32)
        .at[crank_end]
        .set(chains.length + (k - 1), mode="drop")
    )
    crank_start = jnp.where(is_start, rank[cid], chain_capacity)
    start_eid = (
        jnp.zeros((chain_capacity,), jnp.int32)
        .at[crank_start]
        .set(eid, mode="drop")
    )
    start_limbs = gather_edge_rows(spec_limbs, start_eid, k)
    return DeviceEmission(
        buf=buf,
        chain_off=chain_off_t,
        chain_len=chain_len_t,
        start_limbs=start_limbs,
        n_chains=jnp.sum(is_rep.astype(jnp.int32)),
        total=total,
    )


def chains_to_contigs_device_spec(
    spec_limbs: jax.Array,
    chains: UnitigChains,
    k: int,
    out_capacity: int | None = None,
    chain_capacity: int | None = None,
) -> set[bytes]:
    """Device-scatter emission over the virtual doubled edge array."""
    E = 2 * spec_limbs.shape[0]
    out_capacity = out_capacity or E + (k - 1) * max(1024, E >> 4)
    chain_capacity = chain_capacity or max(1024, E >> 4)
    em = emit_chains_device_spec(
        spec_limbs, chains, k, out_capacity, chain_capacity
    )
    n_chains = int(em.n_chains)
    total = int(em.total)
    if n_chains > chain_capacity or total > out_capacity:
        global HOST_FALLBACKS
        if n_chains <= (chain_capacity << 4):
            log.warning(
                "device emission capacity exceeded (%d chains > %d or %d "
                "bytes > %d); retrying device path with exact capacities",
                n_chains, chain_capacity, total, out_capacity,
            )
            g2 = max(1 << 14, 1 << (max(n_chains - 1, 1)).bit_length())
            g3 = max(1 << 20, 1 << (max(total - 1, 1)).bit_length())
            return chains_to_contigs_device_spec(spec_limbs, chains, k, g3, g2)
        HOST_FALLBACKS += 1
        log.warning(
            "device emission fell back to the host O(E) path "
            "(%d chains, %d bytes)", n_chains, total,
        )
        from tpu_euler.graph.build import gather_edge_rows

        idx = np.flatnonzero(np.asarray(chains.in_chain))
        if idx.size == 0:
            return set()
        rows = np.asarray(
            gather_edge_rows(spec_limbs, jnp.asarray(idx, jnp.int32), k)
        )
        return assemble_contig_bytes(
            np.asarray(chains.chain)[idx], np.asarray(chains.pos)[idx], rows, k
        )
    if n_chains == 0:
        return set()
    return _emission_to_contigs(em, n_chains, total, k)


def _emission_to_contigs(
    em: DeviceEmission, n_chains: int, total: int, k: int
) -> set[bytes]:
    """Shared O(output)-transfer tail of the device emission paths."""
    buf = _pad_slice(em.buf, total)
    off = _pad_slice(em.chain_off, n_chains, 1 << 14).astype(np.int64)
    start_limbs = _pad_slice(em.start_limbs, n_chains, 1 << 14)
    seq = _BASES[buf]
    # stitch all (k-1)-base chain prefixes with ONE 2-D scatter
    prefixes = decode_bases_np(start_limbs, k - 1, k)
    seq[off[:, None] + np.arange(k - 1)[None, :]] = prefixes
    off_full = np.concatenate([off, [total]])
    return canonicalize_contig_buffer(seq, off_full)


def _pad_slice(arr, n, granule=1 << 20):
    """D2H slice rounded up to a granule so the eager slice op compiles once,
    not once per distinct data-dependent length (each fresh XLA program is a
    compile)."""
    m = min(arr.shape[0], -(-n // granule) * granule)
    return np.asarray(arr[:m])[:n]


def chains_to_contigs_device(
    g: DeBruijnGraph | jax.Array,
    chains: UnitigChains,
    k: int,
    out_capacity: int | None = None,
    chain_capacity: int | None = None,
) -> set[bytes]:
    """Device-scatter emission; falls back to the host path on capacity overflow.

    ``g`` may be a DeBruijnGraph or just its edge-key array."""
    edge_limbs = _edge_limbs_of(g)
    E = edge_limbs.shape[0]
    out_capacity = out_capacity or E + (k - 1) * max(1024, E >> 4)
    chain_capacity = chain_capacity or max(1024, E >> 4)
    em = emit_chains_device(edge_limbs, chains, k, out_capacity, chain_capacity)
    n_chains = int(em.n_chains)
    total = int(em.total)
    if n_chains > chain_capacity or total > out_capacity:
        # Fragmented assembly (> E/16 unitigs by default): retry the device
        # path once with exact-need capacities before conceding to the O(E)
        # D2H host path; either way, say so (a silent fallback on the hot
        # path hides an O(E) transfer regression).
        global HOST_FALLBACKS
        if n_chains <= (chain_capacity << 4):  # one retry is enough
            log.warning(
                "device emission capacity exceeded (%d chains > %d or %d "
                "bytes > %d); retrying device path with exact capacities",
                n_chains, chain_capacity, total, out_capacity,
            )
            g2 = max(1 << 14, 1 << (max(n_chains - 1, 1)).bit_length())
            g3 = max(1 << 20, 1 << (max(total - 1, 1)).bit_length())
            return chains_to_contigs_device(edge_limbs, chains, k, g3, g2)
        HOST_FALLBACKS += 1
        log.warning(
            "device emission fell back to the host O(E) path "
            "(%d chains, %d bytes)", n_chains, total,
        )
        return chains_to_contigs(edge_limbs, chains, k)  # pathological fragment blowup
    if n_chains == 0:
        return set()
    # O(output) transfers only (see _pad_slice / _emission_to_contigs)
    return _emission_to_contigs(em, n_chains, total, k)


def assemble_contig_bytes(
    chain: np.ndarray, pos: np.ndarray, limbs: np.ndarray, k: int
) -> set[bytes]:
    """Shared host assembly core: (chain id, position, edge key) per valid edge
    -> canonical contig byte-set. Used by the host emission path and the
    sharded-traversal emission (dist/traverse_dist.py)."""
    if chain.size == 0:
        return set()
    last = _BASES[(limbs[:, -1] & 3).astype(np.int64)]
    # Dense chain ids 0..n_chains-1 in deterministic (end-edge id) order.
    uchain, dense = np.unique(chain, return_inverse=True)
    n_chains = uchain.size
    chain_len = np.zeros(n_chains, dtype=np.int64)
    np.maximum.at(chain_len, dense, pos.astype(np.int64) + 1)
    # contig c occupies [(k-1)+len_c] bytes at offset off_c in one flat buffer
    out_len = chain_len + (k - 1)
    off = np.zeros(n_chains + 1, dtype=np.int64)
    np.cumsum(out_len, out=off[1:])
    buf = np.empty(off[-1], dtype=np.uint8)
    # last base of every edge at its position (k-1 + pos)
    buf[off[dense] + (k - 1) + pos] = last
    # (k-1)-prefix of each chain's start edge at positions 0..k-2
    starts = pos == 0
    prefixes = decode_bases_np(limbs[starts], k - 1, k)
    buf[off[dense[starts]][:, None] + np.arange(k - 1)[None, :]] = prefixes
    return canonicalize_contig_buffer(buf, off)


def chains_to_contigs(
    g: DeBruijnGraph | jax.Array, chains: UnitigChains, k: int
) -> set[bytes]:
    """Assemble canonical contig byte-strings from per-edge chain assignments."""
    idx = np.flatnonzero(np.asarray(chains.in_chain))
    if idx.size == 0:
        return set()
    return assemble_contig_bytes(
        np.asarray(chains.chain)[idx],
        np.asarray(chains.pos)[idx],
        np.asarray(_edge_limbs_of(g))[idx],
        k,
    )
