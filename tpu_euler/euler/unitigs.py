"""Unitig (contig chain) computation by pointer jumping and list ranking.

This is the TPU-native recasting of the reference's traversal kernels
(SURVEY.md R7-R10: per-vertex successor assignment, circuit identification,
circuit merging, tour walk) demanded by BASELINE.json's north star: "Eulerian
tour/contig traversal recast as iterative pointer-jumping and list-ranking over
dense int32 arrays to stay XLA-friendly".

Pipeline (all static shapes, O(log E) doubling sweeps, no data-dependent Python
control flow):

1. successor assignment: succ[e] = the unique out-edge of head(e) when head(e)
   is simple (in-degree == out-degree == 1), else -1. Chains of succ links are
   exactly the unitigs.
2. cycle detection: pointer doubling; edges whose pointer never reaches -1 lie
   on pure cycles.
3. cycle cutting: each cycle is cut at every transition whose canonical
   (k+1)-mer achieves the cycle minimum (computed by min-propagating pointer
   doubling over multi-limb keys). Strand-symmetric and deterministic — the
   forward and reverse-complement copies of a cycle cut at mirror positions, so
   their contigs are exact reverse complements (matches the CPU oracle rule).
4. Wyllie list ranking over the cut successor array: distance-to-end and
   end-edge labels per edge; positions from chain start follow by one scatter.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpu_euler.graph.build import DeBruijnGraph
from tpu_euler.kmer import keys


class UnitigChains(NamedTuple):
    """Per-edge chain assignment. Edges with ``in_chain`` False are padding."""

    chain: jax.Array  # [E] int32 — chain id (the id of the chain's END edge)
    pos: jax.Array  # [E] int32 — 0-based position of edge within its chain
    length: jax.Array  # [E] int32 — total chain length (edges), per edge
    is_start: jax.Array  # [E] bool — pos == 0
    from_cycle: jax.Array  # [E] bool — chain was cut from a pure cycle
    in_chain: jax.Array  # [E] bool — edge is valid / participates


def _safe_gather(arr: jax.Array, idx: jax.Array) -> jax.Array:
    """arr[idx] with idx == -1 propagating -1 (for pointer arrays)."""
    out = arr[jnp.clip(idx, 0, arr.shape[0] - 1)]
    return jnp.where(idx < 0, -1, out)


def _log2_ceil(n: int) -> int:
    return max(1, (n - 1).bit_length())


def wyllie_rank(succ: jax.Array, rounds: int) -> tuple[jax.Array, jax.Array]:
    """Wyllie list ranking with packed [E, 3] state rows (p, d, q).

    Returns (d = distance to chain end, end_edge label per edge). One row
    gather per doubling round; q uses a terminal self-loop so it converges to
    the end edge (and q[e] == p[e] whenever p[e] is live, letting d/q share the
    same gathered row).
    """
    E = succ.shape[0]
    SENT = jnp.uint32(0xFFFFFFFF)
    eid = jnp.arange(E, dtype=jnp.uint32)
    p0 = jnp.where(succ >= 0, succ.astype(jnp.uint32), SENT)
    d0 = jnp.where(succ >= 0, 1, 0).astype(jnp.uint32)
    q0 = jnp.where(succ >= 0, succ.astype(jnp.uint32), eid)
    S0 = jnp.stack([p0, d0, q0], axis=1)

    def round_fn(_, S):
        p = S[:, 0]
        alive = p != SENT
        idx = jnp.where(alive, p, eid).astype(jnp.int32)
        rows = S[idx]
        p_new = jnp.where(alive, rows[:, 0], SENT)
        d_new = S[:, 1] + jnp.where(alive, rows[:, 1], 0)
        q_new = rows[:, 2]
        return jnp.stack([p_new, d_new, q_new], axis=1)

    S = jax.lax.fori_loop(0, rounds, round_fn, S0)
    return S[:, 1].astype(jnp.int32), S[:, 2].astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k",))
def successor(g: DeBruijnGraph, k: int) -> jax.Array:
    """succ[e]: unique following edge through a simple head node, else -1.

    ONE random gather per edge: ``g.succ_cand`` pre-folds the simple-node
    test and out_first into a single array at graph-build time.
    """
    h = jnp.clip(g.head, 0, g.succ_cand.shape[0] - 1)
    nxt = g.succ_cand[h]
    return jnp.where(g.edge_valid, nxt, -1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k",))
def transition_keys_el(
    edge_limbs: jax.Array, succ: jax.Array, k: int
) -> jax.Array:
    """t[e] = canonical (k+1)-mer of edge e + its successor's last base.

    The deterministic, strand-symmetric tie-break key for cycle cutting:
    the forward and reverse-complement copies of a cycle see mirror-equal
    keys, so they cut at mirror positions and emit exact-RC contigs (matches
    the CPU oracle rule). All-ones sentinel where succ < 0.

    Takes the bare edge-key array (not the full graph) so memory-bound
    callers can free the graph's node arrays before the traversal.
    """
    E = succ.shape[0]
    SENT = jnp.uint32(0xFFFFFFFF)
    nb = keys.last_base(edge_limbs[jnp.clip(succ, 0, E - 1)])
    t = keys.append_base(edge_limbs, nb, k)
    t, _ = keys.canonical(t, k + 1)
    return jnp.where((succ >= 0)[:, None], t, SENT)


def transition_keys(g: DeBruijnGraph, succ: jax.Array, k: int) -> jax.Array:
    return transition_keys_el(g.edge_limbs, succ, k)


@functools.partial(jax.jit, static_argnames=("k",))
def transition_keys_spec(
    spec_limbs: jax.Array, succ: jax.Array, k: int
) -> jax.Array:
    """``transition_keys`` over the VIRTUAL doubled edge array.

    Edge keys come from the spectrum (+ branchless revcomp for the reverse
    half) instead of a materialized [E, L] array — the memory-lean path for
    100 Mbp single-chip scale. Transients are kept C-sized where possible:
    the successor's last base needs only TWO gathered uint32 columns (its
    own last limb, or — for reverse rows — the forward row's first limb,
    complemented), and append+canonicalize run per strand-half before one
    concat. Output identical to ``transition_keys_el`` on the materialized
    array.
    """
    C, L = spec_limbs.shape
    E = succ.shape[0]
    SENT = jnp.uint32(0xFFFFFFFF)
    # successor's last base via two 1-column gathers (not a [E, L] row gather)
    sc = jnp.clip(succ, 0, E - 1)
    is_rev = sc >= C
    row = jnp.where(is_rev, sc - C, sc)
    lastl = spec_limbs[row, L - 1]
    firstl = spec_limbs[row, 0]
    tb = 2 * k - 32 * (L - 1)  # bits used in limb 0
    nb = jnp.where(
        is_rev,
        jnp.uint32(3) - ((firstl >> jnp.uint32(tb - 2)) & jnp.uint32(3)),
        lastl & jnp.uint32(3),
    ).astype(jnp.int32)

    def half(rows_limbs, nb_half):
        t = keys.append_base(rows_limbs, nb_half, k)
        t, _ = keys.canonical(t, k + 1)
        return t

    t_f = half(spec_limbs, nb[:C])
    t_r = half(keys.revcomp(spec_limbs, k), nb[C:])
    t = jnp.concatenate([t_f, t_r], axis=0)
    return jnp.where((succ >= 0)[:, None], t, SENT)


@functools.partial(jax.jit, static_argnames=("k",))
def cut_cycles_from_t(
    t: jax.Array, edge_valid: jax.Array, succ: jax.Array, k: int
) -> tuple[jax.Array, jax.Array]:
    """Break pure cycles deterministically from precomputed transition keys.

    Cycle detection and min-transition propagation run in ONE fused doubling
    loop whose per-edge state (pointer + candidate min key) lives in a single
    packed [E, 1+L] row — one row-gather per round instead of several scalar
    gathers (random-gather transactions, not bytes, are taken to dominate).
    """
    E = succ.shape[0]
    rounds = _log2_ceil(E) + 1
    SENT = jnp.uint32(0xFFFFFFFF)

    # packed state: column 0 = pointer (sentinel = all-ones), columns 1..L = min key
    p0 = jnp.where(succ >= 0, succ.astype(jnp.uint32), SENT)
    state0 = jnp.concatenate([p0[:, None], t], axis=1)

    def round_fn(_, S):
        p = S[:, 0]
        alive = p != SENT
        rows = S[jnp.clip(p, 0, jnp.uint32(E - 1)).astype(jnp.int32)]
        p_new = jnp.where(alive, rows[:, 0], SENT)
        m_nxt = jnp.where(alive[:, None], rows[:, 1:], SENT)
        take = keys.key_less(m_nxt, S[:, 1:], k + 1)
        m_new = jnp.where(take[:, None], m_nxt, S[:, 1:])
        return jnp.concatenate([p_new[:, None], m_new], axis=1)

    S = jax.lax.fori_loop(0, rounds, round_fn, state0)
    on_cycle = (S[:, 0] != SENT) & edge_valid
    is_cut = on_cycle & keys.key_eq(t, S[:, 1:])
    succ_cut = jnp.where(is_cut, -1, succ)
    return succ_cut, on_cycle


def cut_cycles_el(
    edge_limbs: jax.Array, edge_valid: jax.Array, succ: jax.Array, k: int
) -> tuple[jax.Array, jax.Array]:
    return cut_cycles_from_t(
        transition_keys_el(edge_limbs, succ, k), edge_valid, succ, k
    )


def cut_cycles(
    g: DeBruijnGraph, succ: jax.Array, k: int
) -> tuple[jax.Array, jax.Array]:
    return cut_cycles_el(g.edge_limbs, g.edge_valid, succ, k)


@jax.jit
def _chains_from_rank(
    edge_valid: jax.Array,
    succ: jax.Array,
    d: jax.Array,
    end_edge: jax.Array,
    on_cycle: jax.Array,
) -> UnitigChains:
    """Assemble the UnitigChains record from a ranked cut successor array."""
    E = succ.shape[0]
    # --- chain starts: edges no one points to (under the cut successor) ---
    has_pred = (
        jnp.zeros((E,), jnp.bool_)
        .at[jnp.where(succ >= 0, succ, E)]
        .set(True, mode="drop")
    )
    in_chain = edge_valid
    is_start = in_chain & ~has_pred

    # --- chain length broadcast: scatter d[start]+1 to the end edge slot ---
    start_dest = jnp.where(is_start, end_edge, E)
    len_at_end = (
        jnp.zeros((E,), jnp.int32).at[start_dest].set(d + 1, mode="drop")
    )
    length = jnp.where(in_chain, len_at_end[jnp.clip(end_edge, 0, E - 1)], 0)
    pos = jnp.where(in_chain, length - 1 - d, 0)

    return UnitigChains(
        chain=jnp.where(in_chain, end_edge, -1),
        pos=pos,
        length=length,
        is_start=is_start,
        from_cycle=on_cycle,
        in_chain=in_chain,
    )


@functools.partial(jax.jit, static_argnames=("k",))
def _doubling_chains_from_t(
    t: jax.Array, edge_valid: jax.Array, succ0: jax.Array, k: int
) -> UnitigChains:
    """Doubling-path chain computation from precomputed transition keys."""
    E = succ0.shape[0]
    rounds = _log2_ceil(E) + 1
    succ, on_cycle = cut_cycles_from_t(t, edge_valid, succ0, k)
    d, end_edge = wyllie_rank(succ, rounds)
    return _chains_from_rank(edge_valid, succ, d, end_edge, on_cycle)


def unitig_chains_el(
    edge_limbs: jax.Array, edge_valid: jax.Array, succ0: jax.Array, k: int
) -> UnitigChains:
    """Doubling-path chain computation from a precomputed successor array."""
    return _doubling_chains_from_t(
        transition_keys_el(edge_limbs, succ0, k), edge_valid, succ0, k
    )


def unitig_chains(g: DeBruijnGraph, k: int) -> UnitigChains:
    """Full chain computation; see module docstring."""
    return unitig_chains_el(g.edge_limbs, g.edge_valid, successor(g, k), k)


@jax.jit
def _apply_cut(succ0, t, on_cycle, cyc_min):
    is_cut = on_cycle & keys.key_eq(t, cyc_min)
    return jnp.where(is_cut, -1, succ0), is_cut


def chains_from_t(
    t: jax.Array | list,
    edge_valid: jax.Array,
    succ0: jax.Array,
    k: int,
    min_edges: int = 1 << 17,
    t_factory=None,
) -> UnitigChains:
    """Chain computation via sparse-ruling-set ranking (euler/ranking.py).

    ONE ruler walk total: the cycle-min walk's owner/ruler tables are reused
    to rank the cut list (``ranking.rank_chains_with_cut``), replacing the
    former second O(E) walk with per-gid cut tables + a contracted re-rank +
    a tiny compacted patch. Host-orchestrated (ruler capacities are picked
    from live counts), output bit-identical to ``unitig_chains``. Falls back
    to the doubling path for small graphs (fewer programs) and on the ranking
    module's rare overflow returns.

    Takes precomputed transition keys + successors rather than the graph
    record, so callers at memory-bound scale can free the graph's node
    arrays (~half its footprint) — and the edge-key array itself, when t was
    computed from the virtual doubled array (``transition_keys_spec``) —
    before this walk.

    ``t`` may be passed as a 1-element list (ownership handoff): it is
    popped here and DELETED right after the cycle cut, freeing its [E, L]
    bytes (2.6 GB at config-5 scale) before the cut-rank phase; the rare
    fallback paths then recompute it via ``t_factory``. With a bare array
    and no factory, t is retained for the fallbacks (old behavior).
    """
    from tpu_euler.euler import ranking

    if isinstance(t, list):
        t = t.pop()
    E = succ0.shape[0]
    if E <= min_edges:
        return _doubling_chains_from_t(t, edge_valid, succ0, k)
    res = ranking.cycle_min_ruling_tables(succ0, edge_valid, t)
    if res is None:
        return _doubling_chains_from_t(t, edge_valid, succ0, k)
    on_cycle, cyc_min, owner_off, tabs, succ_c = res
    succ, is_cut = _apply_cut(succ0, t, on_cycle, cyc_min)
    del res, cyc_min  # cyc_min is [E, L]-sized; dead after the cut
    if t_factory is not None:
        del t  # freed before the cut-rank phase; fallbacks recompute below
    rr = ranking.rank_chains_with_cut(
        succ, edge_valid, is_cut, owner_off, tabs, succ_c
    )
    del owner_off, tabs, succ_c, is_cut
    if rr is None:
        rr = ranking.rank_chains_ruling(succ, edge_valid)
    if rr is None:
        t2 = t_factory() if t_factory is not None else t
        return _doubling_chains_from_t(t2, edge_valid, succ0, k)
    d, end_edge = rr
    del succ0
    return _chains_from_rank(edge_valid, succ, d, end_edge, on_cycle)


def chains_from_successors(
    edge_limbs: jax.Array,
    edge_valid: jax.Array,
    succ0: jax.Array,
    k: int,
    min_edges: int = 1 << 17,
) -> UnitigChains:
    """``chains_from_t`` with transition keys from a materialized edge array."""
    return chains_from_t(
        transition_keys_el(edge_limbs, succ0, k), edge_valid, succ0, k,
        min_edges,
    )


def chains_from_successors_spec(
    spec_limbs: jax.Array,
    edge_valid: jax.Array,
    succ0: jax.Array,
    k: int,
    min_edges: int = 1 << 17,
) -> UnitigChains:
    """``chains_from_t`` over the VIRTUAL doubled edge array (no [E, L]
    edge-key materialization — the config-5 memory path)."""
    return chains_from_t(
        transition_keys_spec(spec_limbs, succ0, k), edge_valid, succ0, k,
        min_edges,
    )


def unitig_chains_fast(
    g: DeBruijnGraph, k: int, min_edges: int = 1 << 17
) -> UnitigChains:
    return chains_from_successors(
        g.edge_limbs, g.edge_valid, successor(g, k), k, min_edges
    )
