"""Graph cleaning: iterative tip clipping (SURVEY.md section 7 step 7).

Real error-containing reads (SPEC config 3) leave artifacts the frequency
cutoff can't always remove: short dead-end branches ("tips") from errors near
read ends. A unitig chain is a tip iff its edge count is < tip_len and EXACTLY
one of its ends is dead (start node in-degree 0 / end node out-degree 0 —
both-dead chains are standalone contigs and stay). Tip k-mers are removed in
both orientations (strand symmetry preserved: the mirror chain is a mirror
tip) and chains recomputed; iterate a bounded number of rounds.

Semantics are shared exactly with the CPU oracle
(reference_impl/oracle.py:find_tip_kmers).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpu_euler.euler.unitigs import unitig_chains
from tpu_euler.graph.build import build_graph
from tpu_euler.kmer.count import Spectrum


@functools.partial(jax.jit, static_argnames=("tip_len",))
def _tip_mark(
    spec: Spectrum, head, tail, indeg, outdeg, chains, tip_len: int
) -> tuple[Spectrum, jax.Array]:
    """Shared tip-marking + compaction body (jit). Works from the graph
    pieces + chains so the BIG path can supply ruling-set chains computed
    outside any single program (see ``clip_tips_once_big``)."""
    E = chains.chain.shape[0]
    C = E // 2

    h = jnp.clip(head, 0, outdeg.shape[0] - 1)
    tl = jnp.clip(tail, 0, indeg.shape[0] - 1)
    # chain-indexed dead flags (chain id = end edge id in [0, E))
    is_end = chains.in_chain & (chains.pos == chains.length - 1)
    dead_s = (
        jnp.zeros((E,), jnp.bool_)
        .at[jnp.where(chains.is_start, chains.chain, E)]
        .set(indeg[tl] == 0, mode="drop")
    )
    dead_e = (
        jnp.zeros((E,), jnp.bool_)
        .at[jnp.where(is_end, chains.chain, E)]
        .set(outdeg[h] == 0, mode="drop")
    )
    cid = jnp.clip(chains.chain, 0, E - 1)
    is_tip = (
        chains.in_chain
        & (chains.length < tip_len)
        & (dead_s[cid] ^ dead_e[cid])
    )

    # edge i maps to spectrum row i % C (rows emit 2 orientations)
    tip_row = is_tip[:C] | is_tip[C:]
    valid_row = jnp.arange(C, dtype=jnp.int32) < spec.n
    keep = valid_row & ~tip_row
    dest = jnp.cumsum(keep.astype(jnp.int32)) - 1
    dest = jnp.where(keep, dest, C)
    limbs = jnp.zeros_like(spec.limbs).at[dest].set(spec.limbs, mode="drop")
    counts = jnp.zeros_like(spec.counts).at[dest].set(spec.counts, mode="drop")
    n_removed = jnp.sum((valid_row & tip_row).astype(jnp.int32))
    return Spectrum(limbs, counts, spec.n - n_removed), n_removed


@functools.partial(jax.jit, static_argnames=("k", "tip_len"))
def clip_tips_once(spec: Spectrum, k: int, tip_len: int) -> tuple[Spectrum, jax.Array]:
    """One tip-clipping round over a (cutoff-filtered) spectrum.

    Returns (new spectrum with tip k-mers removed, number of k-mers removed).
    """
    g = build_graph(spec, k)
    chains = unitig_chains(g, k)
    return _tip_mark(spec, g.head, g.tail, g.indeg, g.outdeg, chains, tip_len)


def clip_tips_once_big(
    spec: Spectrum, k: int, tip_len: int
) -> tuple[Spectrum, jax.Array]:
    """Tip round for LARGE graphs: staged build + ruling-set chains.

    The monolithic ``clip_tips_once`` jit builds the graph and runs
    O(E log E) pointer-DOUBLING chains in one program — at the 12 Mbp
    adversarial run's 25M-edge cleaning graphs that dominated the run's
    wall. This path reuses the main
    pipeline's machinery: ``build_graph_staged`` (bounded transients) +
    ``chains_from_successors_spec`` (ruling-set walk, output bit-identical
    to ``unitig_chains``), then the same marking jit.
    """
    from tpu_euler.euler.unitigs import chains_from_successors_spec, successor
    from tpu_euler.graph.build import build_graph_staged

    E = 2 * spec.limbs.shape[0]
    g = build_graph_staged(spec, k, 0, sync=E > (1 << 26))
    succ0 = successor(g, k)
    chains = chains_from_successors_spec(spec.limbs, g.edge_valid, succ0, k)
    del succ0
    return _tip_mark(spec, g.head, g.tail, g.indeg, g.outdeg, chains, tip_len)


# cleaning graphs past this many (doubled) edges take the staged+ruling path
_BIG_CLEAN_EDGES = 1 << 22


def clip_tips(
    spec: Spectrum,
    k: int,
    tip_rounds: int,
    tip_len: int = 0,
    big_edges: int = _BIG_CLEAN_EDGES,
) -> tuple[Spectrum, int]:
    """Iterate tip clipping to a fixed point (bounded rounds). Host loop."""
    tip_len = tip_len or 2 * k
    total = 0
    for _ in range(tip_rounds):
        if 2 * spec.limbs.shape[0] >= big_edges:
            spec, n = clip_tips_once_big(spec, k, tip_len)
        else:
            spec, n = clip_tips_once(spec, k, tip_len)
        n = int(n)
        total += n
        if n == 0:
            break
    return spec, total


def _compact_rows(spec: Spectrum, drop_row: jax.Array) -> tuple[Spectrum, jax.Array]:
    """Remove flagged rows from a spectrum, keeping key-sorted order."""
    C = spec.limbs.shape[0]
    valid_row = jnp.arange(C, dtype=jnp.int32) < spec.n
    keep = valid_row & ~drop_row
    dest = jnp.cumsum(keep.astype(jnp.int32)) - 1
    dest = jnp.where(keep, dest, C)
    limbs = jnp.zeros_like(spec.limbs).at[dest].set(spec.limbs, mode="drop")
    counts = jnp.zeros_like(spec.counts).at[dest].set(spec.counts, mode="drop")
    n_removed = jnp.sum((valid_row & drop_row).astype(jnp.int32))
    return Spectrum(limbs, counts, spec.n - n_removed), n_removed


@functools.partial(jax.jit, static_argnames=("bubble_len",))
def _bubble_mark(
    spec: Spectrum, head, tail, indeg, outdeg, chains, bubble_len: int
) -> tuple[Spectrum, jax.Array]:
    """Shared bubble-marking + compaction body (jit); see pop_bubbles_once
    for the semantics. The BIG path supplies ruling-set chains."""
    E = chains.chain.shape[0]
    C = E // 2
    BIG = jnp.int32(0x7FFFFFFF)

    eid = jnp.arange(E, dtype=jnp.int32)
    member = chains.in_chain & ~chains.from_cycle
    cid = jnp.where(member, chains.chain, E)  # E = dropped
    row = eid % C

    # chain-level tables (chain id = end-edge id, slots [0, E))
    is_end = member & (chains.pos == chains.length - 1)
    h = jnp.clip(head, 0, outdeg.shape[0] - 1)
    tl = jnp.clip(tail, 0, indeg.shape[0] - 1)
    u = jnp.full((E,), BIG).at[jnp.where(chains.is_start & member, cid, E)].set(
        tl, mode="drop"
    )
    v = jnp.full((E,), BIG).at[jnp.where(is_end, cid, E)].set(h, mode="drop")
    clen = jnp.zeros((E,), jnp.int32).at[
        jnp.where(chains.is_start & member, cid, E)
    ].set(chains.length, mode="drop")
    cov = jnp.zeros((E,), jnp.int32).at[cid].add(
        jnp.where(member, spec.counts[row], 0), mode="drop"
    )
    minrow = jnp.full((E,), BIG).at[cid].min(
        jnp.where(member, row, BIG), mode="drop"
    )
    cvalid = u != BIG

    # group chains by (u, v); within a group order by (-cov, minrow)
    slot = jnp.arange(E, dtype=jnp.int32)
    su, sv, sneg, smin, slen, sslot = jax.lax.sort(
        [u, v, -cov, minrow, clen, slot], num_keys=4
    )
    svalid = su != BIG
    prev_same = (
        (su == jnp.roll(su, 1)) & (sv == jnp.roll(sv, 1)) & svalid
    ).at[0].set(False)
    seg = jnp.cumsum((~prev_same).astype(jnp.int32)) - 1
    # group passes the length bar iff its MAX chain length < bubble_len
    seg_maxlen = jnp.zeros((E,), jnp.int32).at[seg].max(slen)
    # a tie between ranks 0 and 1 poisons the group
    second = prev_same & ~jnp.roll(prev_same, 1).at[0].set(False)
    tie = (
        second
        & (sneg == jnp.roll(sneg, 1))
        & (smin == jnp.roll(smin, 1))
    )
    seg_tied = jnp.zeros((E,), jnp.bool_).at[seg].max(tie)
    pop_sorted = (
        svalid & prev_same & (seg_maxlen[seg] < bubble_len) & ~seg_tied[seg]
    )
    popped_chain = jnp.zeros((E,), jnp.bool_).at[sslot].set(pop_sorted)

    edge_popped = member & popped_chain[jnp.clip(cid, 0, E - 1)]
    drop_row = edge_popped[:C] | edge_popped[C:]
    return _compact_rows(spec, drop_row)


@functools.partial(jax.jit, static_argnames=("k", "bubble_len"))
def pop_bubbles_once(
    spec: Spectrum, k: int, bubble_len: int
) -> tuple[Spectrum, jax.Array]:
    """One simple-bubble popping round. Semantics shared EXACTLY with the CPU
    oracle (reference_impl/oracle.py:find_bubble_kmers):

    Non-cycle unitig chains group by (start node u, end node v). A group with
    >= 2 chains, all shorter than ``bubble_len`` edges, is a bubble; chains
    rank by (coverage DESC, min canonical k-mer ASC) — both strand-symmetric,
    so the mirror group pops the mirror branches. A tie at the top skips the
    group (the tied chains spell the same canonical sequence == same rows).
    Every non-winner chain's rows are removed (both orientations at once,
    since row i underlies edges i and i+C).

    Returns (new spectrum, number of rows removed).
    """
    g = build_graph(spec, k)
    chains = unitig_chains(g, k)
    return _bubble_mark(
        spec, g.head, g.tail, g.indeg, g.outdeg, chains, bubble_len
    )


def pop_bubbles_once_big(
    spec: Spectrum, k: int, bubble_len: int
) -> tuple[Spectrum, jax.Array]:
    """Bubble round for LARGE graphs: staged build + ruling-set chains
    (same rationale as ``clip_tips_once_big``)."""
    from tpu_euler.euler.unitigs import chains_from_successors_spec, successor
    from tpu_euler.graph.build import build_graph_staged

    E = 2 * spec.limbs.shape[0]
    g = build_graph_staged(spec, k, 0, sync=E > (1 << 26))
    succ0 = successor(g, k)
    chains = chains_from_successors_spec(spec.limbs, g.edge_valid, succ0, k)
    del succ0
    return _bubble_mark(
        spec, g.head, g.tail, g.indeg, g.outdeg, chains, bubble_len
    )


def pop_bubbles(
    spec: Spectrum,
    k: int,
    bubble_rounds: int,
    bubble_len: int = 0,
    big_edges: int = _BIG_CLEAN_EDGES,
) -> tuple[Spectrum, int]:
    """Iterate bubble popping to a fixed point (bounded rounds). Host loop."""
    bubble_len = bubble_len or 2 * k
    total = 0
    for _ in range(bubble_rounds):
        if 2 * spec.limbs.shape[0] >= big_edges:
            spec, n = pop_bubbles_once_big(spec, k, bubble_len)
        else:
            spec, n = pop_bubbles_once(spec, k, bubble_len)
        n = int(n)
        total += n
        if n == 0:
            break
    return spec, total
