"""Bubble popping: device pipeline vs CPU oracle with identical semantics
(SURVEY.md §5 "tip/bubble handling"; SPEC config 3 error artifacts)."""

import numpy as np
import pytest

from tpu_euler.config import AssemblyConfig
from tpu_euler.pipeline.assemble import assemble_reads
from tpu_euler.reference_impl.oracle import assemble_oracle
from tpu_euler.reference_impl.simulate import random_genome, simulate_reads
from tpu_euler.verify.compare import canonical_contig_set


def reads_with_bubbles(genome, n_bubbles=4, seed=0, read_len=100, bad_copies=4):
    """Clean circular reads + repeated SNP reads that form simple bubbles.

    Each bad read is a genome window with ONE substitution in the middle,
    repeated enough to survive the frequency cutoff — a classic error bubble:
    two short parallel branches between the same flanking nodes, the true
    branch at full coverage, the SNP branch at ``bad_copies``.
    """
    rng = np.random.default_rng(seed)
    reads = simulate_reads(
        genome, read_len=read_len, coverage=25, seed=seed + 1, circular=True
    )
    for b in range(n_bubbles):
        pos = int(rng.integers(0, len(genome) - read_len))
        w = list(genome[pos : pos + read_len])
        mid = read_len // 2
        w[mid] = "ACGT"[("ACGT".index(w[mid]) + 1 + int(rng.integers(0, 3))) % 4]
        reads.extend(["".join(w)] * bad_copies)
    return reads


@pytest.mark.parametrize("k", [21, 31])
def test_bubble_popping_matches_oracle(k):
    genome = random_genome(3000, seed=701)
    reads = reads_with_bubbles(genome, seed=702)
    cfg = AssemblyConfig(
        k=k, min_count=3, bubble_rounds=3, read_batch=512, read_len=100,
        spectrum_capacity=1 << 15,
    )
    got = assemble_reads(reads, cfg)
    expected = assemble_oracle(reads, k, min_count=3, bubble_rounds=3)
    assert canonical_contig_set(got.contig_strings) == expected


def test_bubble_popping_recovers_clean_assembly():
    """Popping removes the SNP branches: result == clean-reads assembly."""
    k = 21
    genome = random_genome(2500, seed=711)
    reads = reads_with_bubbles(genome, seed=712)
    clean = simulate_reads(genome, read_len=100, coverage=25, seed=713, circular=True)
    cfg = AssemblyConfig(
        k=k, min_count=3, bubble_rounds=3, read_batch=512, read_len=100,
        spectrum_capacity=1 << 15,
    )
    got = assemble_reads(reads, cfg)
    assert canonical_contig_set(got.contig_strings) == assemble_oracle(clean, k)
    # without popping the SNP branches fragment the assembly
    cfg_off = AssemblyConfig(
        k=k, min_count=3, read_batch=512, read_len=100, spectrum_capacity=1 << 15
    )
    got_off = assemble_reads(reads, cfg_off)
    assert canonical_contig_set(got_off.contig_strings) != assemble_oracle(clean, k)


def test_equal_coverage_bubble_skipped_deterministically():
    """A 2-branch bubble at EQUAL coverage still pops deterministically (the
    min-canonical-kmer tie-break) and device == oracle."""
    k = 21
    genome = random_genome(2000, seed=721)
    rng = np.random.default_rng(722)
    reads = simulate_reads(genome, read_len=100, coverage=20, seed=723, circular=True)
    pos = 700
    w = list(genome[pos : pos + 100])
    w[50] = "ACGT"[("ACGT".index(w[50]) + 2) % 4]
    reads.extend(["".join(w)] * 20)  # same coverage as the true branch
    cfg = AssemblyConfig(
        k=k, bubble_rounds=2, read_batch=512, read_len=100,
        spectrum_capacity=1 << 15,
    )
    got = assemble_reads(reads, cfg)
    expected = assemble_oracle(reads, k, bubble_rounds=2)
    assert canonical_contig_set(got.contig_strings) == expected


def test_tips_then_bubbles_combined():
    """Config-3-style errored input cleans with BOTH passes, device == oracle."""
    k = 21
    genome = random_genome(2800, seed=731)
    reads = reads_with_bubbles(genome, n_bubbles=3, seed=732)
    rng = np.random.default_rng(733)
    for t in range(3):
        p = int(rng.integers(0, len(genome) - 100))
        junk = "".join("ACGT"[c] for c in rng.integers(0, 4, 30))
        reads.extend([(genome[p : p + 70] + junk)[:100]] * 5)
    cfg = AssemblyConfig(
        k=k, min_count=3, tip_rounds=3, bubble_rounds=3, read_batch=512,
        read_len=100, spectrum_capacity=1 << 15,
    )
    got = assemble_reads(reads, cfg)
    expected = assemble_oracle(
        reads, k, min_count=3, tip_rounds=3, bubble_rounds=3
    )
    assert canonical_contig_set(got.contig_strings) == expected


def test_long_parallel_paths_not_popped():
    """Parallel paths longer than bubble_len are genuine repeats — kept."""
    k = 21
    # two long distinct segments between shared flanks
    flank_a = random_genome(300, seed=741)
    mid1 = random_genome(200, seed=742)
    mid2 = random_genome(200, seed=743)
    flank_b = random_genome(300, seed=744)
    g1 = flank_a + mid1 + flank_b
    g2 = flank_a + mid2 + flank_b
    reads = simulate_reads(g1, read_len=100, coverage=20, seed=745)
    reads += simulate_reads(g2, read_len=100, coverage=10, seed=746)
    cfg = AssemblyConfig(
        k=k, bubble_rounds=2, read_batch=512, read_len=100,
        spectrum_capacity=1 << 15,
    )
    got = assemble_reads(reads, cfg)
    expected = assemble_oracle(reads, k, bubble_rounds=2)
    assert canonical_contig_set(got.contig_strings) == expected
    # the two mid segments are ~200bp branches (>2k edges): both survive
    off = assemble_oracle(reads, k)
    assert expected == off
