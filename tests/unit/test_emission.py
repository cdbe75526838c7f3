"""Vectorized contig emission (euler/extract.py canonicalize_contig_buffer).

Per-contig Python loops made fragmented assemblies
(millions of unitigs) emission-bound. These tests pin the vectorized
canonicalizer against the obvious per-contig reference and require 10^5
fragments to emit in seconds.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from tpu_euler.euler.extract import canonicalize_contig_buffer, rc_bytes

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _naive(buf: np.ndarray, off: np.ndarray) -> set[bytes]:
    out = set()
    for c in range(off.size - 1):
        seq = buf[off[c] : off[c + 1]]
        fwd = seq.tobytes()
        rev = rc_bytes(seq).tobytes()
        out.add(fwd if fwd <= rev else rev)
    return out


def _random_contigs(rng, n, min_len, max_len):
    lens = rng.integers(min_len, max_len + 1, size=n)
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    buf = _ACGT[rng.integers(0, 4, size=off[-1])]
    return buf, off


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_naive_random(seed):
    rng = np.random.default_rng(seed)
    buf, off = _random_contigs(rng, 200, 1, 40)
    assert canonicalize_contig_buffer(buf, off) == _naive(buf, off)


def test_palindromes_and_singletons():
    # revcomp-palindromic contig (fwd == rc), single-base contigs, duplicates
    seqs = [b"ACGT", b"A", b"T", b"GCATGC", b"ACGT", b"TTTT", b"AAAA"]
    buf = np.frombuffer(b"".join(seqs), dtype=np.uint8).copy()
    off = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=off[1:])
    assert canonicalize_contig_buffer(buf, off) == _naive(buf, off)


def test_empty():
    assert canonicalize_contig_buffer(
        np.zeros(0, np.uint8), np.zeros(1, np.int64)
    ) == set()


def test_all_forward_smaller():
    # contigs already canonical (no mismatch edge cases w/ searchsorted)
    seqs = [b"AAAC", b"AACC"]
    buf = np.frombuffer(b"".join(seqs), dtype=np.uint8).copy()
    off = np.array([0, 4, 8], dtype=np.int64)
    assert canonicalize_contig_buffer(buf, off) == {b"AAAC", b"AACC"}


def test_device_emission_capacity_retry(caplog):
    """> E/16 chains (default chain_capacity) must NOT silently fall back to
    the O(E) host path: the device path retries with exact capacities, logs
    the event, and still matches the host emission bit-for-bit."""
    import logging

    from tpu_euler.config import AssemblyConfig
    from tpu_euler.euler import extract
    from tpu_euler.euler.unitigs import unitig_chains
    from tpu_euler.graph.build import build_graph
    from tpu_euler.kmer.count import apply_cutoff
    from tpu_euler.pipeline.assemble import count_spectrum

    # ~1.5k disconnected random 21-mers -> every edge is its own chain, so
    # n_chains = E = 2 * distinct > max(1024, E >> 4)
    rng = np.random.default_rng(11)
    reads = [
        "".join("ACGT"[b] for b in rng.integers(0, 4, size=21))
        for _ in range(1500)
    ]
    cfg = AssemblyConfig(k=21, read_len=21, spectrum_capacity=1 << 14)
    acc, _ = count_spectrum(
        np.array([[("ACGT".index(c)) for c in r] for r in reads], np.int8), cfg
    )
    g = build_graph(apply_cutoff(acc, 1), 21)
    chains = unitig_chains(g, 21)
    host = extract.chains_to_contigs(g, chains, 21)
    before = extract.HOST_FALLBACKS
    with caplog.at_level(logging.WARNING, logger="tpu_euler"):
        dev = extract.chains_to_contigs_device(g, chains, 21)
    assert dev == host
    assert extract.HOST_FALLBACKS == before  # retried on device, no host path
    assert any("capacity exceeded" in r.message for r in caplog.records)


def test_device_emission_true_host_fallback(caplog):
    """Drive the REAL host-fallback branch
    (extract.py's `n_chains > chain_capacity << 4` path). With
    chain_capacity=1 and > 16 chains the single device retry is not allowed,
    so the call must announce the fallback, bump HOST_FALLBACKS, and still
    produce contigs identical to the host path."""
    import logging

    from tpu_euler.config import AssemblyConfig
    from tpu_euler.euler import extract
    from tpu_euler.euler.unitigs import unitig_chains
    from tpu_euler.graph.build import build_graph
    from tpu_euler.kmer.count import apply_cutoff
    from tpu_euler.pipeline.assemble import count_spectrum

    rng = np.random.default_rng(23)
    reads = [
        "".join("ACGT"[b] for b in rng.integers(0, 4, size=21))
        for _ in range(200)
    ]
    cfg = AssemblyConfig(k=21, read_len=21, spectrum_capacity=1 << 12)
    acc, _ = count_spectrum(
        np.array([[("ACGT".index(c)) for c in r] for r in reads], np.int8), cfg
    )
    g = build_graph(apply_cutoff(acc, 1), 21)
    chains = unitig_chains(g, 21)
    host = extract.chains_to_contigs(g, chains, 21)
    assert len(host) > 16  # precondition: beyond the 16x single-retry window
    before = extract.HOST_FALLBACKS
    with caplog.at_level(logging.WARNING, logger="tpu_euler"):
        dev = extract.chains_to_contigs_device(
            g, chains, 21, out_capacity=64, chain_capacity=1
        )
    assert dev == host  # fallback output is bit-identical to the host path
    assert extract.HOST_FALLBACKS == before + 1
    assert any("fell back to the host" in r.message for r in caplog.records)


def test_hundred_thousand_fragments_fast():
    rng = np.random.default_rng(7)
    n = 120_000
    buf, off = _random_contigs(rng, n, 31, 90)
    t0 = time.perf_counter()
    got = canonicalize_contig_buffer(buf, off)
    wall = time.perf_counter() - t0
    # generous bound: the pre-vectorization loop took minutes at this size;
    # headroom covers CPU contention from concurrent jobs on shared boxes
    assert wall < 15.0, f"emission of {n} fragments took {wall:.1f}s"
    # spot-check 500 random fragments against the naive rule
    idx = rng.integers(0, n, size=500)
    for c in idx:
        seq = buf[off[c] : off[c + 1]]
        fwd = seq.tobytes()
        rev = rc_bytes(seq).tobytes()
        assert (fwd if fwd <= rev else rev) in got
