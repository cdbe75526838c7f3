"""Sparse-ruling-set list ranking: O(E) traversal instead of O(E log E).

Pointer doubling (euler/unitigs.py) ranks successor lists in ceil(log2(E))
full-array random-gather sweeps — ~25 passes over every edge at benchmark
scale, and each random row access costs about the same no matter how the
rows are batched. This module implements the sparse-ruling-set scheme
(Reid-Miller; Wei & JaJa's GPU list ranking), recast for XLA static shapes —
the data-parallel answer to the reference's sequential tour walk (SURVEY.md
R8-R10). Every element is touched O(1) times instead of O(log E):

1. rulers = every chain head + a deterministic 1/RULER_STRIDE hash sample
   (+ self-loops for the cycle phase);
2. all rulers walk their sublists IN LOCKSTEP under one `lax.while_loop`,
   each iteration advancing every live walk one successor hop and scattering
   (ruler id, offset) into the visited element. Rounds are capped at
   WALK_CAP hops: walks still alive spawn a "virtual ruler" at their
   continuation element, and the next round walks only those — a pow2 ladder
   of shrinking shapes, so the geometric tail of sublist lengths costs
   O(E) total slot-iterations instead of (max gap) x (#rulers);
3. the contracted ruler-level list (~E/RULER_STRIDE nodes) is ranked by the
   old packed-state pointer doubling — on arrays ~64x smaller;
4. per-edge results are one gather from the ruler tables.

Two entry points mirror the two doubling loops they replace:
  * ``cycle_min_ruling``   — which edges lie on pure cycles + each cycle's
    minimum transition key (deterministic cycle cutting);
  * ``rank_chains_ruling`` — distance-to-end + end-edge label per edge of a
    cycle-free successor array (replaces ``unitigs.wyllie_rank``).

Ruler-free cycles (cycles shorter than the hash stride that dodged the
sample) are resolved by a compacted doubling pass over just the uncovered
elements. All choices are deterministic, so contigs are bit-identical to the
doubling path's. Callers receive ``None`` on the (pathological) overflow
paths and fall back to full doubling.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_euler.kmer import keys

RULER_STRIDE = 64  # expected elements per hash-sampled ruler
WALK_CAP = 128  # max hops per walk round (offsets must fit 8 bits)
_SENT32 = jnp.uint32(0xFFFFFFFF)
_GID_BITS = 24  # packed owner word: [gid:24 | offset:8]


def _log2_ceil(n: int) -> int:
    return max(1, (n - 1).bit_length())


def _pow2(n: int, lo: int = 1 << 12) -> int:
    return 1 << max(_log2_ceil(max(1, n)), _log2_ceil(lo))


def _cap_rows(n: int, lo: int = 1 << 12) -> int:
    """Walk-frontier capacity: pow2 up to 64k, then a 16k granule.

    Dead frontier slots pay every walk iteration (gather + scatter), so pow2
    rounding wastes up to 2x of the walk's total work at large sizes; the 16k
    granule caps the waste at ~10% while keeping the compiled-shape count
    low (each distinct shape costs one fresh XLA program). Always a multiple
    of the previous capacity's granule, so ladder slicing stays valid.
    """
    n = max(int(n), lo)
    if n <= (1 << 16):
        return 1 << _log2_ceil(n)
    g = 1 << 14
    return -(-n // g) * g


def _hash_sample(n: int) -> jax.Array:
    h = keys._mix32(jnp.arange(n, dtype=jnp.uint32))
    return h < jnp.uint32((1 << 32) // RULER_STRIDE)


@functools.partial(jax.jit, static_argnames=("with_self",))
def _pick_rulers(succ: jax.Array, valid: jax.Array, with_self: bool):
    """Ruler mask: valid chain heads + hash sample (+ self-loops)."""
    E = succ.shape[0]
    live = succ >= 0
    has_pred = (
        jnp.zeros((E,), jnp.bool_)
        .at[jnp.where(live, succ, E)]
        .set(True, mode="drop")
    )
    is_ruler = valid & (~has_pred | _hash_sample(E))
    if with_self:
        is_ruler = is_ruler | (succ == jnp.arange(E, dtype=jnp.int32))
    return is_ruler, jnp.sum(is_ruler.astype(jnp.int32))


@jax.jit
def _build_succ2(succ: jax.Array, is_ruler: jax.Array):
    """Encode 'next element is a ruler' into the successor array itself, so
    the walk needs ONE gather per hop: succ2[e] = succ[e] normally, -1 at
    chain ends, -2-succ[e] when succ[e] is a ruler."""
    E = succ.shape[0]
    nxt_is_ruler = is_ruler[jnp.clip(succ, 0, E - 1)] & (succ >= 0)
    return jnp.where(nxt_is_ruler, -2 - succ, succ)


@functools.partial(jax.jit, static_argnames=("s_cap",))
def _compact_rulers(is_ruler: jax.Array, s_cap: int):
    """Element ids of the first s_cap rulers, padded with -1."""
    E = is_ruler.shape[0]
    eid = jnp.arange(E, dtype=jnp.int32)
    slot = jnp.cumsum(is_ruler.astype(jnp.int32)) - 1
    dest = jnp.where(is_ruler & (slot < s_cap), slot, s_cap)
    return jnp.full((s_cap,), -1, jnp.int32).at[dest].set(eid, mode="drop")


@jax.jit
def _build_rows(succ2: jax.Array, t: jax.Array) -> jax.Array:
    """Pack (succ2, t) into one [E, 1+L] uint32 row array (or [E] when L==0).

    The min-tracking walk chases pointers — each hop needs succ2[x] AND t[x]
    of the element it just entered. Random-gather TRANSACTIONS, not bytes,
    are the working hypothesis for the walk's cost (PERF.md), so fusing both
    into one row halves that walk's gathers. succ2 is stored bitcast
    int32->uint32 (modular), recovered exactly on read. Without min tracking
    the array stays 1-D: a [E, 1] row has nothing to fuse.
    """
    if t.shape[1] == 0:
        return succ2.astype(jnp.uint32)
    return jnp.concatenate([succ2.astype(jnp.uint32)[:, None], t], axis=1)


@functools.partial(
    jax.jit, static_argnames=("track_min", "walk_cap"), donate_argnums=(0, 3)
)
def _walk_round(
    rows: jax.Array,
    frontier: jax.Array,
    gid_base: jax.Array,
    owner_off: jax.Array,
    walk_cap: int,
    track_min: bool,
):
    """One capped lockstep walk round from ``frontier`` (element ids, -1 pad).

    ``rows`` is the packed [E, 1+L] (succ2, t) array from ``_build_rows``.
    Returns (owner_off, rows, next_r, end_e, hops, span_min, capped, n_capped):
    per-slot next ruler element id (-1 none), chain-end element id (-1 none),
    hop count to the recorded stop, span min key; ``capped`` = compacted
    continuation element ids (new virtual rulers) for the next round. Each
    walk iteration costs exactly ONE [s_cap, 1+L] row gather + one scatter:
    the successor value for the element just entered rides in the same row as
    its transition key, carried in the loop state for the next iteration.
    """
    E = rows.shape[0]
    s_cap = frontier.shape[0]
    gid = gid_base + jnp.arange(s_cap, dtype=jnp.uint32)

    live0 = frontier >= 0
    f_c = jnp.clip(frontier, 0, E - 1)
    # rulers own themselves at offset 0
    owner_off = owner_off.at[jnp.where(live0, frontier, E)].set(
        gid << jnp.uint32(8), mode="drop"
    )
    rows0 = rows[f_c]
    succ_col = rows0[:, 0] if track_min else rows0
    raw0 = jnp.where(live0, succ_col.astype(jnp.int32), -1)
    if track_min:
        m0 = jnp.where(live0[:, None], rows0[:, 1:], _SENT32)
    else:
        m0 = jnp.zeros((s_cap, 0), jnp.uint32)

    state = dict(
        x=jnp.where(live0, frontier, -1),
        raw=raw0,  # succ2[x], gathered when x was entered
        step=jnp.zeros((s_cap,), jnp.int32),
        next_r=jnp.full((s_cap,), -1, jnp.int32),
        end_e=jnp.full((s_cap,), -1, jnp.int32),
        hops=jnp.zeros((s_cap,), jnp.int32),
        mmin=m0,
        owner_off=owner_off,
        it=jnp.zeros((), jnp.int32),
    )

    def cond(s):
        return (s["it"] < walk_cap) & jnp.any(s["x"] >= 0)

    def body(s):
        x, raw = s["x"], s["raw"]
        alive = x >= 0
        stop_ruler = alive & (raw <= -2)
        stop_end = alive & (raw == -1)
        advance = alive & (raw >= 0)
        step1 = s["step"] + advance.astype(jnp.int32)
        next_r = jnp.where(stop_ruler, -2 - raw, s["next_r"])
        end_e = jnp.where(stop_end, x, s["end_e"])
        hops = jnp.where(
            stop_ruler, s["step"] + 1, jnp.where(stop_end, s["step"], s["hops"])
        )
        x1 = jnp.where(advance, raw, -1)
        vdest = jnp.where(advance, raw, E)
        owner_off = s["owner_off"].at[vdest].set(
            (gid << jnp.uint32(8)) | step1.astype(jnp.uint32), mode="drop"
        )
        rows_g = rows[jnp.clip(x1, 0, E - 1)]  # the ONE gather per hop
        succ_g = rows_g[:, 0] if track_min else rows_g
        raw1 = jnp.where(advance, succ_g.astype(jnp.int32), -1)
        if track_min:
            tn = jnp.where(advance[:, None], rows_g[:, 1:], _SENT32)
            take = keys.key_less(tn, s["mmin"])
            mmin = jnp.where(take[:, None], tn, s["mmin"])
        else:
            mmin = s["mmin"]
        return dict(
            x=x1,
            raw=raw1,
            step=step1,
            next_r=next_r,
            end_e=end_e,
            hops=hops,
            mmin=mmin,
            owner_off=owner_off,
            it=s["it"] + 1,
        )

    s = jax.lax.while_loop(cond, body, state)

    # classify walks still alive at the cap (their succ2 is already in state)
    x, step, raw = s["x"], s["step"], s["raw"]
    alive = x >= 0
    cap_ruler = alive & (raw <= -2)
    cap_end = alive & (raw == -1)
    cap_cont = alive & (raw >= 0)
    next_r = jnp.where(cap_ruler | cap_cont, jnp.where(cap_cont, raw, -2 - raw), s["next_r"])
    end_e = jnp.where(cap_end, x, s["end_e"])
    hops = jnp.where(
        cap_ruler | cap_cont, step + 1, jnp.where(cap_end, step, s["hops"])
    )
    # continuation elements become next round's rulers; patch succ2 at their
    # (unique) predecessor so later walks stop there.
    patch_dest = jnp.where(cap_cont, x, E)
    patch_val = jnp.where(cap_cont, -2 - raw, 0).astype(jnp.uint32)
    if track_min:
        rows = rows.at[patch_dest, 0].set(patch_val, mode="drop")
    else:
        rows = rows.at[patch_dest].set(patch_val, mode="drop")
    cslot = jnp.cumsum(cap_cont.astype(jnp.int32)) - 1
    capped = (
        jnp.full((s_cap,), -1, jnp.int32)
        .at[jnp.where(cap_cont, cslot, s_cap)]
        .set(jnp.where(cap_cont, raw, -1), mode="drop")
    )
    n_capped = jnp.sum(cap_cont.astype(jnp.int32))
    return s["owner_off"], rows, next_r, end_e, hops, s["mmin"], capped, n_capped


@functools.partial(jax.jit, donate_argnums=(0,))
def _append_tables(tabs: dict, base: jax.Array, frontier, next_r, end_e, hops, mmin):
    """Write one round's ruler tables at [base : base+s_cap] — all on device.

    Rounds only ship ONE scalar (the capped-walk count) to host, so a
    round costs one host<->device round trip, not one per table.
    """
    return dict(
        elem=jax.lax.dynamic_update_slice(tabs["elem"], frontier, (base,)),
        next_r=jax.lax.dynamic_update_slice(tabs["next_r"], next_r, (base,)),
        end_e=jax.lax.dynamic_update_slice(tabs["end_e"], end_e, (base,)),
        hops=jax.lax.dynamic_update_slice(tabs["hops"], hops, (base,)),
        mmin=jax.lax.dynamic_update_slice(
            tabs["mmin"], mmin, (base, jnp.zeros((), base.dtype))
        ),
    )


def _empty_tables(S_cap: int, L: int):
    return dict(
        elem=jnp.full((S_cap,), -1, jnp.int32),
        next_r=jnp.full((S_cap,), -1, jnp.int32),
        end_e=jnp.full((S_cap,), -1, jnp.int32),
        hops=jnp.zeros((S_cap,), jnp.int32),
        mmin=jnp.full((S_cap, L), _SENT32),
    )


@functools.partial(jax.jit, static_argnames=("S_cap",))
def _grow_tables(tabs: dict, S_cap: int):
    old = tabs["elem"].shape[0]
    fresh = _empty_tables(S_cap, tabs["mmin"].shape[1])
    return {
        k: jax.lax.dynamic_update_slice(
            fresh[k], v, (0,) * v.ndim
        )
        for k, v in tabs.items()
    }


def _run_walk(succ, valid, t, track_min, with_self):
    """All walk rounds; returns (owner_off [E], device ruler tables dict) or
    (None, None) on gid overflow. Each round ships exactly one scalar to the
    host (the capped-walk count that sizes the next round's pow2 shape)."""
    E = succ.shape[0]
    is_ruler, n_rulers = _pick_rulers(succ, valid, with_self)
    succ2 = _build_succ2(succ, is_ruler)
    s_cap = _cap_rows(int(n_rulers))
    owner_off = jnp.full((E,), _SENT32)
    L = t.shape[1] if track_min else 0
    if not track_min:
        t = jnp.zeros((E, 0), jnp.uint32)
    rows = _build_rows(succ2, t)

    frontier = _compact_rulers(is_ruler, s_cap)
    del succ2, is_ruler  # dead once rows + frontier exist (0.9+ GB at scale)
    base = 0
    S_cap = _pow2(2 * s_cap)  # headroom for virtual rulers (~16% expected)
    tabs = _empty_tables(S_cap, L)
    while True:
        if base + s_cap >= (1 << _GID_BITS):
            return None, None
        if base + s_cap > S_cap:
            S_cap = _pow2(base + s_cap)
            tabs = _grow_tables(tabs, S_cap)
        owner_off, rows, next_r, end_e, hops, mmin, capped, n_capped = _walk_round(
            rows, frontier, jnp.uint32(base), owner_off, WALK_CAP, track_min
        )
        tabs = _append_tables(
            tabs, jnp.asarray(base, jnp.int32), frontier, next_r, end_e, hops, mmin
        )
        base += s_cap
        n = int(n_capped)
        if n == 0:
            break
        s_cap = _cap_rows(n)
        frontier = capped[:s_cap]
    return owner_off, tabs


@functools.partial(jax.jit, static_argnames=("E",))
def _contract_succ(elem: jax.Array, next_r: jax.Array, E: int):
    """Contracted successor over ruler slots: slot -> slot of next ruler."""
    S = elem.shape[0]
    slot_of = (
        jnp.full((E,), -1, jnp.int32)
        .at[jnp.where(elem >= 0, elem, E)]
        .set(jnp.arange(S, dtype=jnp.int32), mode="drop")
    )
    return jnp.where(next_r >= 0, slot_of[jnp.clip(next_r, 0, E - 1)], -1)


@jax.jit
def _contracted_cycle_min(succ_c: jax.Array, mmin: jax.Array):
    """Packed-state min-propagating doubling over the contracted list."""
    S, L = mmin.shape
    rounds = _log2_ceil(S) + 1
    p0 = jnp.where(succ_c >= 0, succ_c.astype(jnp.uint32), _SENT32)
    S0 = jnp.concatenate([p0[:, None], mmin], axis=1)

    def round_fn(_, St):
        p = St[:, 0]
        alive = p != _SENT32
        rows = St[jnp.clip(p, 0, jnp.uint32(S - 1)).astype(jnp.int32)]
        p_new = jnp.where(alive, rows[:, 0], _SENT32)
        m_nxt = jnp.where(alive[:, None], rows[:, 1:], _SENT32)
        take = keys.key_less(m_nxt, St[:, 1:])
        m_new = jnp.where(take[:, None], m_nxt, St[:, 1:])
        return jnp.concatenate([p_new[:, None], m_new], axis=1)

    St = jax.lax.fori_loop(0, rounds, round_fn, S0)
    return St[:, 0] != _SENT32, St[:, 1:]  # (ruler_on_cycle, ruler_min)


@jax.jit
def _contracted_rank(succ_c: jax.Array, hops: jax.Array, end_e: jax.Array):
    """Weighted Wyllie over the contracted list.

    Returns per-slot (D = hops to chain end, chain_end element id)."""
    S = succ_c.shape[0]
    rounds = _log2_ceil(S) + 1
    sid = jnp.arange(S, dtype=jnp.uint32)
    p0 = jnp.where(succ_c >= 0, succ_c.astype(jnp.uint32), _SENT32)
    d0 = hops.astype(jnp.uint32)
    q0 = jnp.where(succ_c >= 0, succ_c.astype(jnp.uint32), sid)
    S0 = jnp.stack([p0, d0, q0], axis=1)

    def round_fn(_, St):
        p = St[:, 0]
        alive = p != _SENT32
        idx = jnp.where(alive, p, sid).astype(jnp.int32)
        rows = St[jnp.clip(idx, 0, S - 1)]
        p_new = jnp.where(alive, rows[:, 0], _SENT32)
        d_new = St[:, 1] + jnp.where(alive, rows[:, 1], 0)
        q_new = rows[:, 2]
        return jnp.stack([p_new, d_new, q_new], axis=1)

    St = jax.lax.fori_loop(0, rounds, round_fn, S0)
    D = St[:, 1].astype(jnp.int32)
    q = St[:, 2].astype(jnp.int32)
    chain_end = end_e[jnp.clip(q, 0, S - 1)]
    has_cycle = jnp.any(St[:, 0] != _SENT32)  # a slot never reached an end
    return D, chain_end, has_cycle


@jax.jit
def _broadcast_cycle(owner_off, ruler_on_cycle, ruler_min, succ):
    covered = owner_off != _SENT32
    gid = (owner_off >> jnp.uint32(8)).astype(jnp.int32)
    S = ruler_on_cycle.shape[0]
    g = jnp.clip(gid, 0, S - 1)
    on_cycle = covered & ruler_on_cycle[g]
    cyc_min = jnp.where(on_cycle[:, None], ruler_min[g], _SENT32)
    uncovered = (succ >= 0) & ~covered
    return on_cycle, cyc_min, uncovered


@jax.jit
def _broadcast_rank(owner_off, D, chain_end, succ):
    E = succ.shape[0]
    covered = owner_off != _SENT32
    gid = (owner_off >> jnp.uint32(8)).astype(jnp.int32)
    off = (owner_off & jnp.uint32(0xFF)).astype(jnp.int32)
    S = D.shape[0]
    g = jnp.clip(gid, 0, S - 1)
    d = jnp.where(covered, D[g] - off, 0)
    end_edge = jnp.where(covered, chain_end[g], jnp.arange(E, dtype=jnp.int32))
    uncovered = (succ >= 0) & ~covered
    return d, end_edge, uncovered


@functools.partial(jax.jit, static_argnames=("u_cap",))
def _uncovered_cycle_min(
    succ: jax.Array, t: jax.Array, uncovered: jax.Array, u_cap: int
):
    """Min-propagating doubling over the compacted uncovered subset.

    Uncovered elements are exactly the members of ruler-free cycles (every
    path element is reachable from a head ruler), so all lie on cycles and
    the subset's successor structure is closed within it.
    """
    E, L = t.shape
    eid = jnp.arange(E, dtype=jnp.int32)
    slot = jnp.cumsum(uncovered.astype(jnp.int32)) - 1
    dest = jnp.where(uncovered & (slot < u_cap), slot, u_cap)
    elem = jnp.full((u_cap,), -1, jnp.int32).at[dest].set(eid, mode="drop")
    slot_of = (
        jnp.full((E,), -1, jnp.int32)
        .at[jnp.where(uncovered & (slot < u_cap), eid, E)]
        .set(jnp.clip(slot, 0, u_cap - 1), mode="drop")
    )
    live = elem >= 0
    ec = jnp.clip(elem, 0, E - 1)
    succ_u = jnp.where(
        live, slot_of[jnp.clip(succ[ec], 0, E - 1)], -1
    )
    m0 = jnp.where(live[:, None], t[ec], _SENT32)
    on_c, cmin_u = _contracted_cycle_min(succ_u, m0)
    cyc_min = (
        jnp.full((E, L), _SENT32)
        .at[jnp.where(live, ec, E)]
        .set(cmin_u, mode="drop")
    )
    return cyc_min


def cycle_min_ruling_tables(succ, valid, t):
    """Like ``cycle_min_ruling`` but also returns the walk's owner/ruler
    tables so the caller can rank the CUT list without a second walk
    (``rank_chains_with_cut``). Returns None on gid overflow."""
    owner_off, tabs = _run_walk(succ, valid, t, track_min=True, with_self=True)
    if owner_off is None:
        return None
    E = succ.shape[0]
    succ_c = _contract_succ(tabs["elem"], tabs["next_r"], E)
    ruler_on_cycle, ruler_min = _contracted_cycle_min(succ_c, tabs["mmin"])
    on_cycle, cyc_min, uncovered = _broadcast_cycle(
        owner_off, ruler_on_cycle, ruler_min, succ
    )
    n_unc = int(jnp.sum(uncovered.astype(jnp.int32)))
    if n_unc:
        u_cap = _pow2(n_unc)
        cyc_min_u = _uncovered_cycle_min(succ, t, uncovered, u_cap)
        on_cycle = on_cycle | uncovered
        cyc_min = jnp.where(uncovered[:, None], cyc_min_u, cyc_min)
    return on_cycle, cyc_min, owner_off, tabs, succ_c


def cycle_min_ruling(succ, valid, t):
    """(on_cycle [E], cycle-min transition key [E, L]) — semantics identical
    to the min-propagating doubling in ``unitigs.cut_cycles``. Returns None
    on gid overflow (caller falls back to doubling)."""
    res = cycle_min_ruling_tables(succ, valid, t)
    if res is None:
        return None
    return res[0], res[1]


# ---------------------------------------------------------------------------
# Fused rank: rank the CUT successor list from the cycle walk's tables,
# avoiding the second full O(E) walk entirely. The cut changes the list
# structure only AT cut edges, so per-gid "first cut" tables + a contracted
# re-rank + a tiny compacted patch (elements past an intra-sublist cut, plus
# ruler-free-cycle members) reconstruct every edge's (distance-to-end,
# end-edge) exactly as rank_chains_ruling would.
# ---------------------------------------------------------------------------

_INF32 = jnp.int32(1 << 30)


@jax.jit
def _cut_tables(is_cut: jax.Array, owner_off: jax.Array, succ_c: jax.Array):
    """Per-gid (first-cut offset, cut-edge id at that offset); INF/E if none."""
    E = is_cut.shape[0]
    S = succ_c.shape[0]
    covered = owner_off != _SENT32
    gid = (owner_off >> jnp.uint32(8)).astype(jnp.int32)
    off = (owner_off & jnp.uint32(0xFF)).astype(jnp.int32)
    use = is_cut & covered
    dest = jnp.where(use, gid, S)
    m1 = (
        jnp.full((S,), _INF32)
        .at[dest]
        .min(jnp.where(use, off, _INF32), mode="drop")
    )
    at_m1 = use & (off == m1[jnp.clip(gid, 0, S - 1)])
    eid = jnp.arange(E, dtype=jnp.int32)
    cut_edge = (
        jnp.full((S,), E, jnp.int32)
        .at[jnp.where(at_m1, gid, S)]
        .min(jnp.where(at_m1, eid, E), mode="drop")
    )
    return m1, cut_edge


@jax.jit
def _contracted_rank_cut(succ_c, hops, end_e, m1, cut_edge):
    """Contracted weighted rank where gids containing a cut terminate there."""
    has_cut = m1 < _INF32
    succ2 = jnp.where(has_cut, -1, succ_c)
    hops2 = jnp.where(has_cut, m1, hops)
    end2 = jnp.where(has_cut, cut_edge, end_e)
    return _contracted_rank(succ2, hops2, end2)


@jax.jit
def _broadcast_rank_cut(owner_off, D, chain_end, valid, m1):
    """Per-edge (d, end_edge, known, n_patch): closed-form for every covered
    edge at offset <= its gid's first cut; the rest go to the patch set."""
    E = valid.shape[0]
    covered = owner_off != _SENT32
    gid = (owner_off >> jnp.uint32(8)).astype(jnp.int32)
    off = (owner_off & jnp.uint32(0xFF)).astype(jnp.int32)
    S = D.shape[0]
    g = jnp.clip(gid, 0, S - 1)
    known = valid & covered & (off <= m1[g])
    d = jnp.where(known, D[g] - off, 0)
    end_edge = jnp.where(known, chain_end[g], jnp.arange(E, dtype=jnp.int32))
    patch = valid & ~known
    return d, end_edge, patch, jnp.sum(patch.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("u_cap",))
def _patch_rank(succ_cut, patch, d_known, end_known, u_cap: int):
    """Weighted Wyllie over the compacted patch set with absorbing boundaries.

    A patch element whose successor is outside the patch absorbs that
    successor's already-known (d, end) as its initial hop weight/label — the
    patch's chains are closed under that convention, so a bounded doubling
    resolves them. Returns per-edge (d, end, leaked): ``leaked`` flags a live
    pointer after full doubling (a cycle survived the cut — impossible unless
    an invariant broke; caller falls back to full doubling).
    """
    E = succ_cut.shape[0]
    eid = jnp.arange(E, dtype=jnp.int32)
    slot = jnp.cumsum(patch.astype(jnp.int32)) - 1
    ok = patch & (slot < u_cap)
    elem = (
        jnp.full((u_cap,), -1, jnp.int32)
        .at[jnp.where(ok, slot, u_cap)]
        .set(eid, mode="drop")
    )
    slot_of = (
        jnp.full((E,), -1, jnp.int32)
        .at[jnp.where(ok, eid, E)]
        .set(jnp.clip(slot, 0, u_cap - 1), mode="drop")
    )
    overflow = jnp.sum(patch.astype(jnp.int32)) > u_cap

    live = elem >= 0
    ec = jnp.clip(elem, 0, E - 1)
    x = jnp.where(live, succ_cut[ec], -1)
    xc = jnp.clip(x, 0, E - 1)
    x_in = (x >= 0) & (slot_of[xc] >= 0)
    sid = jnp.arange(u_cap, dtype=jnp.uint32)

    p0 = jnp.where(live & x_in, slot_of[xc].astype(jnp.uint32), _SENT32)
    d0 = jnp.where(
        ~live | (x < 0),
        0,
        jnp.where(x_in, 1, 1 + d_known[xc]),
    ).astype(jnp.uint32)
    # terminal label: own element at a real end, else the absorbed end
    e0 = jnp.where(x < 0, ec, end_known[xc])
    q0 = jnp.where(p0 != _SENT32, p0, sid)
    St = jnp.stack([p0, d0, q0], axis=1)

    def round_fn(_, St):
        p = St[:, 0]
        alive = p != _SENT32
        idx = jnp.where(alive, p, sid).astype(jnp.int32)
        rows = St[jnp.clip(idx, 0, u_cap - 1)]
        p_new = jnp.where(alive, rows[:, 0], _SENT32)
        d_new = St[:, 1] + jnp.where(alive, rows[:, 1], 0)
        q_new = rows[:, 2]
        return jnp.stack([p_new, d_new, q_new], axis=1)

    St = jax.lax.fori_loop(0, _log2_ceil(u_cap) + 1, round_fn, St)
    leaked = jnp.any(jnp.where(live, St[:, 0] != _SENT32, False)) | overflow
    Dp = St[:, 1].astype(jnp.int32)
    q = St[:, 2].astype(jnp.int32)
    endp = e0[jnp.clip(q, 0, u_cap - 1)]
    d_e = jnp.zeros((E,), jnp.int32).at[jnp.where(live, ec, E)].set(Dp, mode="drop")
    end_e = (
        jnp.full((E,), -1, jnp.int32)
        .at[jnp.where(live, ec, E)]
        .set(endp, mode="drop")
    )
    return d_e, end_e, leaked


@jax.jit
def _merge_patch(d, end_edge, patch, dp, ep):
    return (
        jnp.where(patch, dp, d),
        jnp.where(patch, ep, end_edge),
    )


def rank_chains_with_cut(succ_cut, valid, is_cut, owner_off, tabs, succ_c):
    """(distance to chain end, end-edge label) of the cut list, computed from
    the CYCLE walk's tables — no second O(E) walk. Semantics exactly equal
    ``rank_chains_ruling(succ_cut, valid)`` (true distance/end labels, not
    ruler-choice-dependent). Returns None if an invariant breaks (caller
    falls back)."""
    m1, cut_edge = _cut_tables(is_cut, owner_off, succ_c)
    D, chain_end, has_cycle = _contracted_rank_cut(
        succ_c, tabs["hops"], tabs["end_e"], m1, cut_edge
    )
    d, end_edge, patch, n_patch = _broadcast_rank_cut(
        owner_off, D, chain_end, valid, m1
    )
    n = int(n_patch)
    if n:
        u_cap = _pow2(n, lo=1 << 10)
        dp, ep, leaked = _patch_rank(succ_cut, patch, d, end_edge, u_cap)
        if bool(leaked):
            return None
        d, end_edge = _merge_patch(d, end_edge, patch, dp, ep)
    if bool(has_cycle):
        return None  # a contracted cycle survived the cut: invariant broke
    return d, end_edge


def rank_chains_ruling(succ, valid):
    """(distance to chain end, end-edge label) per element of a cycle-free
    successor array — replaces ``unitigs.wyllie_rank``. Returns None if a
    cycle leaked through the cut or on gid overflow."""
    owner_off, tabs = _run_walk(
        succ, valid, None, track_min=False, with_self=False
    )
    if owner_off is None:
        return None
    E = succ.shape[0]
    succ_c = _contract_succ(tabs["elem"], tabs["next_r"], E)
    D, chain_end, has_cycle = _contracted_rank(
        succ_c, tabs["hops"], tabs["end_e"]
    )
    d, end_edge, uncovered = _broadcast_rank(owner_off, D, chain_end, succ)
    if bool(has_cycle) or bool(jnp.any(uncovered)):
        return None  # a cycle leaked through the cut: caller falls back
    return d, end_edge
