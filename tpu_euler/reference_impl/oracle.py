"""Pure-CPU oracle assembler: the correctness ground truth.

SURVEY.md section 2b: the reference binary is unavailable (empty mount), so the
practical oracle for the SPEC's "exact contig sequence-set equality after
canonicalization" bar is this CPU implementation. The device pipeline must produce
the identical canonical contig set.

Semantics (shared, exactly, with the device implementation):

1. Extract all k-mers from reads (windows containing N are dropped); count by
   canonical form min(kmer, revcomp); drop canonical count < min_count.
2. Build the *doubled* directed de Bruijn graph: for each surviving canonical
   k-mer insert both orientations as edges (k odd => always 2 distinct edges).
   Nodes are (k-1)-mers; edge w goes w[:-1] -> w[1:].
3. Contigs are unitigs: maximal chains through "simple" nodes (in-degree ==
   out-degree == 1, counting distinct edges). Edge e2 follows e1 iff
   head(e1) == tail(e2) is simple.
4. Chains with no start edge are cycles. A cycle is cut at *every* transition
   (e -> succ(e)) whose (k+1)-mer spelling achieves the cycle's smallest
   canonical form; the edge after each cut starts a chain. (Strand-symmetric:
   guarantees the forward and reverse-strand cycle contigs are exact reverse
   complements. The min is achieved once per ordinary cycle; a self-reverse-
   complement cycle hits it twice and splits into two mutually-RC arcs.)
5. A chain e_0..e_{m-1} spells tail(e_0) + last base of each e_i: length
   (k-1) + m.
6. Output = the set of canonical contigs min(s, revcomp(s)), deduplicated.
"""

from __future__ import annotations

from collections import Counter, defaultdict

_COMP = str.maketrans("ACGT", "TGCA")


def rc(s: str) -> str:
    return s.translate(_COMP)[::-1]


def canon(s: str) -> str:
    r = rc(s)
    return s if s <= r else r


def count_canonical_kmers(reads: list[str], k: int) -> Counter:
    counts: Counter = Counter()
    for read in reads:
        for i in range(len(read) - k + 1):
            w = read[i : i + k]
            if "N" in w or len(w) < k:
                continue
            counts[canon(w)] += 1
    return counts


def assemble_oracle(
    reads: list[str],
    k: int,
    min_count: int = 1,
    tip_rounds: int = 0,
    tip_len: int = 0,
    bubble_rounds: int = 0,
    bubble_len: int = 0,
) -> set[str]:
    """Assemble reads into the canonical contig set. See module docstring.

    tip_rounds > 0 enables iterative tip clipping: a unitig chain is a tip iff
    its edge count is < tip_len (default 2k) and EXACTLY one of its ends is
    dead (start node with in-degree 0, or end node with out-degree 0). Tips'
    canonical k-mers are removed (both orientations) and chains recomputed.

    bubble_rounds > 0 then enables iterative simple-bubble popping (see
    find_bubble_kmers for the exact shared rule).
    """
    if k % 2 == 0 or k < 3:
        raise ValueError("k must be odd and >= 3")
    counts = count_canonical_kmers(reads, k)
    edges = set()
    for km, c in counts.items():
        if c >= min_count:
            edges.add(km)
            edges.add(rc(km))

    for _ in range(tip_rounds):
        tips = find_tip_kmers(edges, k, tip_len or 2 * k)
        if not tips:
            break
        edges -= tips

    for _ in range(bubble_rounds):
        pops = find_bubble_kmers(edges, counts, k, bubble_len or 2 * k)
        if not pops:
            break
        edges -= pops

    return contigs_from_edges(edges, k)


def find_tip_kmers(edges: set[str], k: int, tip_len: int) -> set[str]:
    """k-mers (both orientations) of all tip chains in the doubled graph."""
    out_edges: dict[str, list[str]] = defaultdict(list)
    in_deg: Counter = Counter()
    out_deg: Counter = Counter()
    for e in edges:
        out_edges[e[:-1]].append(e)
        out_deg[e[:-1]] += 1
        in_deg[e[1:]] += 1

    def simple(node: str) -> bool:
        return in_deg[node] == 1 and out_deg[node] == 1

    def succ(e: str):
        h = e[1:]
        return out_edges[h][0] if simple(h) else None

    tips: set[str] = set()
    starts = [e for e in edges if not simple(e[:-1])]
    for s0 in starts:
        chain = [s0]
        e = succ(s0)
        while e is not None and e != s0:
            chain.append(e)
            e = succ(e)
        dead_start = in_deg[chain[0][:-1]] == 0
        dead_end = out_deg[chain[-1][1:]] == 0
        if len(chain) < tip_len and (dead_start != dead_end):
            for e in chain:
                tips.add(e)
                tips.add(rc(e))
    return tips


def find_bubble_kmers(
    edges: set[str], counts: Counter, k: int, bubble_len: int
) -> set[str]:
    """k-mers (both orientations) of all popped bubble branches.

    Shared rule (exactly mirrored by the device path, euler/clean.py:
    pop_bubbles_once):

    * Candidate chains are the non-cycle unitig chains. Chains are grouped by
      (start node u = tail of first edge, end node v = head of last edge).
    * A group is a bubble iff it has >= 2 chains and EVERY chain in it has
      edge count < bubble_len.
    * Chains rank by (total canonical-count coverage DESC, minimum canonical
      k-mer ASC). Both attributes are strand-symmetric, so the mirror group
      (rc(v), rc(u)) ranks its mirror chains identically and pops the mirror
      branches — the doubled-graph invariant is preserved.
    * If the top two chains tie on BOTH attributes the group is skipped
      (such chains spell the same canonical sequence, i.e. share rows —
      popping one would delete the other's k-mers too).
    * Otherwise every chain but the winner is popped: its k-mers removed in
      both orientations.
    """
    out_edges: dict[str, list[str]] = defaultdict(list)
    in_deg: Counter = Counter()
    out_deg: Counter = Counter()
    for e in edges:
        out_edges[e[:-1]].append(e)
        out_deg[e[:-1]] += 1
        in_deg[e[1:]] += 1

    def simple(node: str) -> bool:
        return in_deg[node] == 1 and out_deg[node] == 1

    def succ(e: str):
        h = e[1:]
        return out_edges[h][0] if simple(h) else None

    groups: dict[tuple[str, str], list] = defaultdict(list)
    for s0 in edges:
        if simple(s0[:-1]):
            continue  # not a chain start; pure cycles excluded by construction
        chain = [s0]
        e = succ(s0)
        while e is not None and e != s0:
            chain.append(e)
            e = succ(e)
        u, v = chain[0][:-1], chain[-1][1:]
        cov = sum(counts[canon(w)] for w in chain)
        minkmer = min(canon(w) for w in chain)
        groups[(u, v)].append((-cov, minkmer, chain))

    pops: set[str] = set()
    for members in groups.values():
        if len(members) < 2:
            continue
        if any(len(c) >= bubble_len for _, _, c in members):
            continue
        members.sort(key=lambda m: (m[0], m[1]))
        if members[0][:2] == members[1][:2]:
            continue  # ambiguous winner: identical canonical spelling
        for _, _, chain in members[1:]:
            for w in chain:
                pops.add(w)
                pops.add(rc(w))
    return pops


def contigs_from_edges(edges: set[str], k: int) -> set[str]:
    """Unitig extraction on an explicit doubled edge set (distinct k-mers)."""
    out_edges: dict[str, list[str]] = defaultdict(list)
    in_deg: Counter = Counter()
    out_deg: Counter = Counter()
    for e in edges:
        out_edges[e[:-1]].append(e)
        out_deg[e[:-1]] += 1
        in_deg[e[1:]] += 1

    def simple(node: str) -> bool:
        return in_deg[node] == 1 and out_deg[node] == 1

    def succ(e: str):
        h = e[1:]
        if simple(h):
            return out_edges[h][0]
        return None

    # Start edges: predecessor link absent (tail node not simple).
    starts = [e for e in edges if not simple(e[:-1])]
    contigs: set[str] = set()
    used: set[str] = set()

    def emit(chain: list[str]):
        s = chain[0][:-1] + "".join(e[-1] for e in chain)
        contigs.add(canon(s))

    for s0 in starts:
        chain = [s0]
        used.add(s0)
        e = succ(s0)
        while e is not None and e not in used:
            chain.append(e)
            used.add(e)
            e = succ(e)
        emit(chain)

    # Remaining edges form pure cycles (every node simple).
    remaining = sorted(edges - used)
    for e0 in remaining:
        if e0 in used:
            continue
        cycle = [e0]
        used.add(e0)
        e = succ(e0)
        while e != e0:
            cycle.append(e)
            used.add(e)
            e = succ(e)
        # Cut at every transition achieving the minimal canonical (k+1)-mer;
        # each cut's successor starts a chain (ordinarily exactly one cut).
        m = len(cycle)
        trans = [canon(cycle[i] + cycle[(i + 1) % m][-1]) for i in range(m)]
        best = min(trans)
        cuts = sorted(i for i in range(m) if trans[i] == best)
        for ci, cut in enumerate(cuts):
            start = (cut + 1) % m
            nxt_cut = cuts[(ci + 1) % len(cuts)]
            arc_len = (nxt_cut - cut) % m or m
            emit([cycle[(start + j) % m] for j in range(arc_len)])

    return contigs
