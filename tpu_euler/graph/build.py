"""De Bruijn graph construction as sorted-edge-array CSR.

Reference counterpart: SURVEY.md R4/R6 — the PyCUDA reference assigned vertex ids
for (k-1)-mers with an atomics-based GPU hash table and built adjacency arrays.
TPU-native redesign (BASELINE.json north star): node ids come from a variadic
sort + segment-rank over all edge endpoints; degrees and unique-successor arrays
from segment-sums/scatter-mins. Everything is dense int32/uint32 with static
capacities and validity masks — no pointers, no atomics, no dynamic shapes.

Graph semantics (shared with the CPU oracle, tpu_euler/reference_impl/oracle.py):
the *doubled* directed graph — both orientations of every surviving canonical
k-mer are edges; nodes are (k-1)-mers; edge w: w[:-1] -> w[1:].
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpu_euler.kmer import keys
from tpu_euler.kmer.count import Spectrum


class DeBruijnGraph(NamedTuple):
    """Doubled de Bruijn graph in dense-array form.

    E = edge capacity (2x spectrum capacity); node arrays have capacity
    ``node_cap`` (default 2E — every edge endpoint distinct, the exact worst
    case; memory-bound callers may trim, see ``assign_node_ids``). Consumers
    must bound node-id gathers by the node arrays' own shape, not 2E. k is
    NOT stored here (it is a static Python value threaded separately so the
    pytree stays array-only).
    """

    edge_limbs: jax.Array  # [E, L] uint32 — k-mer of each edge
    edge_valid: jax.Array  # [E] bool
    tail: jax.Array  # [E] int32 node id of prefix (k-1)-mer (garbage if invalid)
    head: jax.Array  # [E] int32 node id of suffix (k-1)-mer
    n_edges: jax.Array  # [] int32
    n_nodes: jax.Array  # [] int32
    indeg: jax.Array  # [node_cap] int32 distinct in-edges per node
    outdeg: jax.Array  # [node_cap] int32 distinct out-edges per node
    out_first: jax.Array  # [node_cap] int32 min edge id with tail==node (E if none)
    succ_cand: jax.Array  # [node_cap] int32 out_first where node is simple, else -1
    # (precomputed so the successor kernel costs ONE random gather per edge
    #  instead of three — random-gather transactions, not bytes, are the cost)

    @property
    def edge_capacity(self) -> int:
        return self.edge_limbs.shape[0]


@functools.partial(jax.jit, static_argnames=("k",))
def doubled_edges(spec: Spectrum, k: int) -> tuple[jax.Array, jax.Array]:
    """Emit both orientations of each surviving canonical k-mer as edges.

    Returns (edge_limbs [2C, L], edge_valid [2C]). k odd => orientations distinct.
    """
    C = spec.limbs.shape[0]
    fwd = spec.limbs
    rev = keys.revcomp(spec.limbs, k)
    valid = jnp.arange(C, dtype=jnp.int32) < spec.n
    return (
        jnp.concatenate([fwd, rev], axis=0),
        jnp.concatenate([valid, valid], axis=0),
    )


@functools.partial(jax.jit, static_argnames=("k", "node_cap"))
def assign_node_ids(
    edge_limbs: jax.Array, edge_valid: jax.Array, k: int, node_cap: int = 0
):
    """Assign dense node ids to the distinct endpoint (k-1)-mers of all edges.

    Returns (tail [E], head [E], n_nodes [], outdeg [node_cap], indeg
    [node_cap]). ``node_cap`` (0 -> 2E, the exact worst case: every endpoint
    distinct) sizes the per-node arrays: in a connected assembly graph
    n_nodes ~~ E, so a caller at memory-bound scale can pass ~1.15*E and
    save half the node-array footprint (4 int32 arrays). If n_nodes exceeds
    node_cap the degree scatters silently drop — callers that trim MUST
    check the returned n_nodes against node_cap on host and fail/retry.

    The doubled graph's endpoint multiset is closed under reverse complement
    (every edge's RC is also an edge), so the distinct RAW endpoints are
    exactly {distinct canonical (k-1)-mers} x {strands} (palindromes once).
    Sorting only the 2C canonical endpoints of the FORWARD half (prefix +
    suffix per spectrum k-mer) therefore determines every id — HALF the rows
    of the naive all-raw-endpoints sort, the graph stage's dominant op.

    Node id = base(c) + strand, where base(c) = 2*rank(c) - #palindromic
    canonical keys before c (so ids stay dense), rank(c) = rank among sorted
    distinct canonical endpoint keys, and strand(m) = [m != canonical(m)]
    (palindromes collapse both strands onto base). Ids are deterministic and
    strand-pair-consistent; only id VALUES differ from the raw-rank scheme —
    a bijection of endpoints, so successor pairing, degrees and contigs are
    unchanged. Degrees fall out of the same sort via cumsum-diff segment
    counting: per canonical segment, out-strand counts (s0, s1) give
    outdeg=(s0, s1) and — since in-strand = 1 - out-strand off palindromes —
    indeg=(s1, s0) swapped; 2 segment sums total.
    """
    fwd = edge_limbs[: edge_limbs.shape[0] // 2]
    valid = edge_valid[: edge_limbs.shape[0] // 2]
    ops, strands = _canon_endpoint_parts(fwd, valid, k)
    sorted_ops = jax.lax.sort(list(ops), num_keys=len(ops))
    tail, head, n_nodes = _ids_from_sorted(sorted_ops, strands, edge_valid)
    outdeg, indeg = _degrees_from_sorted(
        sorted_ops, node_cap or 2 * edge_limbs.shape[0]
    )
    return tail, head, n_nodes, outdeg, indeg


_SENT = jnp.uint32(0xFFFFFFFF)


def _canon_endpoint_parts(fwd: jax.Array, valid: jax.Array, k: int):
    """Sentinel-masked canonical endpoint sort operands + per-row strand bits.

    Odd k guarantees spare high bits in limb 0 of a (k-1)-mer stored in
    nlimbs(k) limbs (2(k-1) <= 32L - 4 for odd k), so invalid rows carry the
    all-ones sentinel IN limb 0: no separate validity operand through the
    build's dominant sort, and the payload rides as the FINAL sort key
    (total order -> deterministic without is_stable).

    Returns (ops, strands): ops = L limb operands + packed payload, each
    [2C] uint32; strands[i] = s_pre | s_suf<<1 per spectrum row (needed by
    ``_ids_from_sorted`` to orient tail/head, packed small so the staged
    build can pass it between jits cheaply).
    """
    assert 2 * (k - 1) - 32 * (keys.nlimbs(k) - 1) < 32, "odd k required"
    C = fwd.shape[0]
    # payload packs the row position into 30 bits (strand bit 30, pal bit 31):
    # fail loudly rather than silently corrupt ids past 2^30 endpoint rows
    # (config 5 is ~240M rows; the next scale step needs a wider payload limb)
    assert 2 * C < 1 << 30, (
        f"endpoint payload packs row ids into 30 bits; 2C={2 * C} overflows"
    )
    pre = keys.prefix(fwd, k)
    suf = keys.suffix(fwd, k)

    def canon3(m):
        rc = keys.revcomp(m, k - 1)
        rc_smaller = keys.key_less(rc, m, k - 1)
        pal = keys.key_eq(m, rc)
        return jnp.where(rc_smaller[..., None], rc, m), rc_smaller, pal

    cpre, s_pre, pal_pre = canon3(pre)
    csuf, s_suf, pal_suf = canon3(suf)

    endpoints = jnp.concatenate([cpre, csuf], axis=0)  # [2C, L]
    valid2 = jnp.concatenate([valid, valid])
    pal2 = jnp.concatenate([pal_pre, pal_suf])
    # out-strand of each occurrence: pre rows are fwd-edge tails (strand s);
    # suf rows are rev-edge tails through rc (strand 1-s). Pal rows fold to 0.
    s_out2 = jnp.concatenate([s_pre, ~s_suf]) & ~pal2
    pos2 = jnp.arange(2 * C, dtype=jnp.uint32)
    payload = pos2 | (s_out2.astype(jnp.uint32) << 30) | (
        pal2.astype(jnp.uint32) << 31
    )
    L = endpoints.shape[1]
    ops = tuple(
        jnp.where(valid2, endpoints[:, j], _SENT) for j in range(L)
    ) + (jnp.where(valid2, payload, _SENT),)
    strands = (
        s_pre.astype(jnp.uint8) | (s_suf.astype(jnp.uint8) << 1)
    )
    return ops, strands


def _ids_from_sorted(sorted_ops, strands, edge_valid):
    """(tail [E], head [E], n_nodes) from sorted endpoint operands.

    See ``assign_node_ids`` for the id scheme. ``sorted_ops`` is the output
    of sorting ``_canon_endpoint_parts``' operands (L limbs + payload).
    """
    L = len(sorted_ops) - 1
    M = sorted_ops[0].shape[0]  # = 2C
    C = M // 2
    spay = sorted_ops[L]
    sv = sorted_ops[0] != _SENT
    is_new = jnp.zeros((M,), jnp.bool_)
    for j in range(L):
        is_new = is_new | (sorted_ops[j] != jnp.roll(sorted_ops[j], 1))
    is_new = is_new.at[0].set(True) & sv
    rank = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    n_canon = jnp.sum(is_new.astype(jnp.int32))
    pal_s = spay >> 31 != 0
    pos_s = (spay & jnp.uint32((1 << 30) - 1)).astype(jnp.int32)
    # dense base id: 2*rank minus # palindromic distinct ranks BEFORE this
    # one (pal_s is segment-constant, so the per-row correction term makes
    # the inclusive cumsum exclusive for every row of a palindromic segment)
    pal_seg = jnp.cumsum((is_new & pal_s).astype(jnp.int32)) - jnp.where(
        pal_s, 1, 0
    )
    base = 2 * rank - pal_seg
    n_pal = jnp.sum((is_new & pal_s).astype(jnp.int32))
    n_nodes = 2 * n_canon - n_pal

    # scatter (base<<1 | pal) back to original endpoint rows
    dest = jnp.where(sv, pos_s, M)
    packed = (base.astype(jnp.uint32) << 1) | pal_s.astype(jnp.uint32)
    back = jnp.zeros((M,), jnp.uint32).at[dest].set(packed, mode="drop")
    base_pre = (back[:C] >> 1).astype(jnp.int32)
    palp = (back[:C] & 1).astype(jnp.bool_)
    base_suf = (back[C:] >> 1).astype(jnp.int32)
    pals = (back[C:] & 1).astype(jnp.bool_)

    s_pre = (strands & 1).astype(jnp.bool_)
    s_suf = (strands >> 1).astype(jnp.bool_)
    sp = s_pre & ~palp  # strand of raw pre (pal -> 0)
    ss = s_suf & ~pals
    tail_fwd = base_pre + sp.astype(jnp.int32)
    head_fwd = base_suf + ss.astype(jnp.int32)
    tail_rev = base_suf + (~ss & ~pals).astype(jnp.int32)
    head_rev = base_pre + (~sp & ~palp).astype(jnp.int32)
    tail = jnp.concatenate([tail_fwd, tail_rev])
    head = jnp.concatenate([head_fwd, head_rev])
    tail = jnp.where(edge_valid, tail, 0)
    head = jnp.where(edge_valid, head, 0)
    return tail, head, n_nodes


def _degrees_from_sorted(sorted_ops, node_cap: int):
    """(outdeg, indeg) [node_cap] from sorted endpoint operands.

    Recomputes the cheap per-row scans (is_new/rank/base) rather than
    carrying them between jits — two cumsums beat 3 x [2C] int32 residency
    in the staged build.
    """
    from tpu_euler.kmer.count import segment_sums_sorted

    L = len(sorted_ops) - 1
    M = sorted_ops[0].shape[0]
    spay = sorted_ops[L]
    sv = sorted_ops[0] != _SENT
    is_new = jnp.zeros((M,), jnp.bool_)
    for j in range(L):
        is_new = is_new | (sorted_ops[j] != jnp.roll(sorted_ops[j], 1))
    is_new = is_new.at[0].set(True) & sv
    rank = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    n_canon = jnp.sum(is_new.astype(jnp.int32))
    pal_s = spay >> 31 != 0
    s_out_s = (spay >> 30) & 1
    pal_seg = jnp.cumsum((is_new & pal_s).astype(jnp.int32)) - jnp.where(
        pal_s, 1, 0
    )
    base = 2 * rank - pal_seg

    # degrees: per-segment out-strand counts; indeg is the strand-swapped twin
    w0 = jnp.where(sv & (s_out_s == 0), 1, 0).astype(jnp.int32)
    w1 = jnp.where(sv & (s_out_s == 1), 1, 0).astype(jnp.int32)
    out0 = segment_sums_sorted(is_new, rank, w0, M)  # [2C] per-rank
    out1 = segment_sums_sorted(is_new, rank, w1, M)
    ridx = jnp.arange(M, dtype=jnp.int32)
    rvalid = ridx < n_canon
    # per-rank pal flag + base, gathered from segment starts via scatter
    pal_rank = (
        jnp.zeros((M,), jnp.bool_)
        .at[jnp.where(is_new, rank, M)]
        .set(pal_s, mode="drop")
    )
    base_rank = (
        jnp.zeros((M,), jnp.int32)
        .at[jnp.where(is_new, rank, M)]
        .set(base, mode="drop")
    )
    deg_dest0 = jnp.where(rvalid, base_rank, node_cap)
    deg_dest1 = jnp.where(rvalid & ~pal_rank, base_rank + 1, node_cap)
    outdeg = (
        jnp.zeros((node_cap,), jnp.int32)
        .at[deg_dest0].set(out0, mode="drop")
        .at[deg_dest1].set(out1, mode="drop")
    )
    indeg = (
        jnp.zeros((node_cap,), jnp.int32)
        .at[deg_dest0].set(jnp.where(pal_rank, out0, out1), mode="drop")
        .at[deg_dest1].set(out0, mode="drop")
    )
    return outdeg, indeg


# ---------------------------------------------------------------------------
# Staged low-memory build (SPEC config-5 scale: 100 Mbp on one device).
#
# The monolithic ``build_graph`` jit at 220M doubled edges peaks at ~14 GB: the
# 2C-row endpoint sort (in+out), the materialized [E, L] edge keys, the input
# spectrum and the node arrays all coexist inside one program. The staged
# path bounds each stage's peak instead:
#   A. endpoint operands from the spectrum          (spectrum + operands)
#   B. DONATED full-key sort                        (operands alias in place)
#   C1. node ids (tail/head/n_nodes)                (sorted ops + ids)
#   C2. degrees, sorted ops donated                 (sorted ops + degree arrays)
#   D. out_first/succ_cand                          (small)
# and it never materializes the doubled edge-key array at all: row r >= C of
# the doubled graph is revcomp(spectrum row r - C) by construction
# (``doubled_edges``), so traversal/emission gather edge keys virtually via
# ``gather_edge_rows`` (one spectrum gather + branchless revcomp).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("k",))
def endpoint_sort_operands(limbs: jax.Array, n: jax.Array, k: int):
    """Stage A: sort operands + strand bits from a compacted spectrum."""
    C = limbs.shape[0]
    valid = jnp.arange(C, dtype=jnp.int32) < n
    return _canon_endpoint_parts(limbs, valid, k)


@functools.partial(jax.jit, donate_argnums=(0,))
def sort_endpoint_operands(ops: tuple):
    """Stage B: donated full-key sort — outputs alias the donated inputs."""
    return tuple(jax.lax.sort(list(ops), num_keys=len(ops)))


@functools.partial(jax.jit, static_argnames=("C",))
def _edge_valid_of(n: jax.Array, C: int):
    v = jnp.arange(C, dtype=jnp.int32) < n
    return jnp.concatenate([v, v])


@jax.jit
def endpoint_ids(sorted_ops: tuple, strands: jax.Array, edge_valid: jax.Array):
    """Stage C1."""
    return _ids_from_sorted(sorted_ops, strands, edge_valid)


@functools.partial(jax.jit, static_argnames=("node_cap",))
def endpoint_degrees(sorted_ops: tuple, node_cap: int):
    """Stage C2. No donation: the [2C] operands cannot alias the [node_cap]
    int32 outputs (donating would only emit the 'not usable' warning); the
    caller drops its reference right after, which frees them just as well."""
    return _degrees_from_sorted(sorted_ops, node_cap)


@functools.partial(jax.jit, static_argnames=("node_cap",))
def succ_tables(
    tail: jax.Array, edge_valid: jax.Array, indeg: jax.Array,
    outdeg: jax.Array, node_cap: int,
):
    """Stage D: min-out-edge per node + folded simple-node successor table."""
    E = tail.shape[0]
    eid = jnp.arange(E, dtype=jnp.int32)
    tail_c = jnp.where(edge_valid, tail, node_cap - 1)
    out_first = (
        jnp.full((node_cap,), E, jnp.int32)
        .at[tail_c]
        .min(jnp.where(edge_valid, eid, E), mode="drop")
    )
    simple = (indeg == 1) & (outdeg == 1) & (out_first < E)
    succ_cand = jnp.where(simple, out_first, -1)
    return out_first, succ_cand


def build_graph_staged(
    spec: Spectrum, k: int, node_cap: int = 0, sync: bool = False
) -> DeBruijnGraph:
    """Low-memory staged graph build. Bit-identical ids/degrees to
    ``build_graph``; the returned record has ``edge_limbs=None`` (edge keys
    stay virtual — see ``gather_edge_rows``).

    ``sync`` blocks at stage boundaries: PJRT allocates a computation's
    output buffers at ENQUEUE time, so without syncs the host running ahead
    pre-allocates every stage's outputs while the first stage still runs —
    the sum-of-all-stages peak is what exhausted device memory at 100 Mbp
    scale. With syncs the live set is one stage's (inputs + outputs +
    workspace) at a time. Leave False at bench scale (each sync stalls
    dispatch until the device catches up)."""

    def _s(x):
        if sync:
            jax.block_until_ready(x)
        return x

    C = spec.limbs.shape[0]
    E = 2 * C
    node_cap = node_cap or 2 * E
    ops, strands = endpoint_sort_operands(spec.limbs, spec.n, k)
    _s(ops)
    ops = sort_endpoint_operands(ops)
    _s(ops)
    edge_valid = _edge_valid_of(spec.n, C)
    # degrees BEFORE ids: during the degree stage only the spectrum and
    # edge_valid persist; during the id stage the degree arrays persist but
    # the sorted operands die with it — the widest stage never holds
    # tail/head AND the operands at once.
    outdeg, indeg = endpoint_degrees(ops, node_cap)
    _s(outdeg)
    tail, head, n_nodes = endpoint_ids(ops, strands, edge_valid)
    _s(tail)
    del ops, strands
    out_first, succ_cand = succ_tables(tail, edge_valid, indeg, outdeg, node_cap)
    _s(succ_cand)
    return DeBruijnGraph(
        edge_limbs=None,
        edge_valid=edge_valid,
        tail=tail,
        head=head,
        n_edges=2 * spec.n,
        n_nodes=n_nodes,
        indeg=indeg,
        outdeg=outdeg,
        out_first=out_first,
        succ_cand=succ_cand,
    )


@functools.partial(jax.jit, static_argnames=("k",))
def gather_edge_rows(spec_limbs: jax.Array, idx: jax.Array, k: int) -> jax.Array:
    """Edge keys of the VIRTUAL doubled edge array at ``idx`` ([N] -> [N, L]).

    Doubled row r is spectrum row r for r < C and revcomp(spectrum row r - C)
    otherwise (``doubled_edges`` layout) — one gather + branchless revcomp,
    so the 12-byte-per-edge doubled key array (2.6 GB at config-5 scale)
    never exists. Out-of-range idx is clipped (callers mask).
    """
    C = spec_limbs.shape[0]
    is_rev = idx >= C
    base = spec_limbs[jnp.clip(jnp.where(is_rev, idx - C, idx), 0, C - 1)]
    return jnp.where(is_rev[..., None], keys.revcomp(base, k), base)


@functools.partial(jax.jit, static_argnames=("k", "node_cap"))
def build_graph(spec: Spectrum, k: int, node_cap: int = 0) -> DeBruijnGraph:
    """Full graph build from a (cutoff-filtered) canonical k-mer spectrum.

    ``node_cap`` (0 -> exact worst case 2E) trims the four per-node arrays;
    trimming callers must verify n_nodes <= node_cap on host afterwards.
    """
    edge_limbs, edge_valid = doubled_edges(spec, k)
    E = edge_limbs.shape[0]
    node_cap = node_cap or 4 * E // 2  # = 2E; keep int for static hashing
    tail, head, n_nodes, outdeg, indeg = assign_node_ids(
        edge_limbs, edge_valid, k, node_cap
    )
    one = jnp.where(edge_valid, 1, 0).astype(jnp.int32)
    tail_c = jnp.where(edge_valid, tail, node_cap - 1)
    # min edge id per tail node (the unique out-edge where outdeg == 1);
    # invalid edges write the E sentinel, which never wins a min
    eid = jnp.arange(E, dtype=jnp.int32)
    out_first = (
        jnp.full((node_cap,), E, jnp.int32)
        .at[tail_c]
        .min(jnp.where(edge_valid, eid, E), mode="drop")
    )
    simple = (indeg == 1) & (outdeg == 1) & (out_first < E)
    succ_cand = jnp.where(simple, out_first, -1)
    return DeBruijnGraph(
        edge_limbs=edge_limbs,
        edge_valid=edge_valid,
        tail=tail,
        head=head,
        n_edges=jnp.sum(one),
        n_nodes=n_nodes,
        indeg=indeg,
        outdeg=outdeg,
        out_first=out_first,
        succ_cand=succ_cand,
    )
