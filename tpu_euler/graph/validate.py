"""Debug validation of graph/traversal invariants (SURVEY.md section 5: the JAX
answer to cuda-memcheck/sanitizers — XLA is race-free inside jit, so what needs
checking is index/semantic invariants, on demand, off the hot path)."""

from __future__ import annotations

import numpy as np

from tpu_euler.euler.unitigs import UnitigChains
from tpu_euler.graph.build import DeBruijnGraph


def validate_graph(g: DeBruijnGraph, k: int) -> list[str]:
    """Host-side invariant checks. Returns a list of violation messages."""
    errs: list[str] = []
    valid = np.asarray(g.edge_valid)
    tail = np.asarray(g.tail)[valid]
    head = np.asarray(g.head)[valid]
    n_nodes = int(g.n_nodes)
    n_edges = int(g.n_edges)
    if valid.sum() != n_edges:
        errs.append(f"edge_valid sum {valid.sum()} != n_edges {n_edges}")
    if n_edges % 2 != 0:
        errs.append("doubled graph must have an even number of edges")
    if tail.size and (tail.min() < 0 or tail.max() >= n_nodes):
        errs.append("tail ids out of range")
    if head.size and (head.min() < 0 or head.max() >= n_nodes):
        errs.append("head ids out of range")
    indeg = np.asarray(g.indeg)
    outdeg = np.asarray(g.outdeg)
    if indeg[:n_nodes].sum() != n_edges or outdeg[:n_nodes].sum() != n_edges:
        errs.append("degree sums != edge count")
    # strand symmetry: total in-degree distribution == out-degree distribution
    if not np.array_equal(
        np.sort(indeg[:n_nodes]), np.sort(outdeg[:n_nodes])
    ):
        errs.append("in/out degree multisets differ (strand asymmetry)")
    return errs


def validate_chains(g: DeBruijnGraph, chains: UnitigChains, k: int) -> list[str]:
    """Chain invariants: each valid edge in exactly one chain slot; positions
    contiguous; successors adjacent."""
    errs: list[str] = []
    in_chain = np.asarray(chains.in_chain)
    chain = np.asarray(chains.chain)
    pos = np.asarray(chains.pos)
    length = np.asarray(chains.length)
    tail = np.asarray(g.tail)
    head = np.asarray(g.head)
    idx = np.flatnonzero(in_chain)
    pairs = {(int(chain[e]), int(pos[e])) for e in idx}
    if len(pairs) != idx.size:
        errs.append("duplicate (chain, pos) slots")
    order = np.lexsort((pos[idx], chain[idx]))
    ov = idx[order]
    for i in range(len(ov) - 1):
        a, b = ov[i], ov[i + 1]
        if chain[a] == chain[b]:
            if pos[b] != pos[a] + 1:
                errs.append(f"non-contiguous positions in chain {chain[a]}")
                break
            if head[a] != tail[b]:
                errs.append(f"non-adjacent consecutive edges in chain {chain[a]}")
                break
    for e in idx:
        if not (0 <= pos[e] < length[e]):
            errs.append(f"pos out of range at edge {e}")
            break
    return errs
