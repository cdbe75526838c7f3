"""Tip clipping: device pipeline vs CPU oracle with identical semantics."""

import numpy as np
import pytest

from tpu_euler.config import AssemblyConfig
from tpu_euler.pipeline.assemble import assemble_reads
from tpu_euler.reference_impl.oracle import assemble_oracle
from tpu_euler.reference_impl.simulate import random_genome, simulate_reads
from tpu_euler.verify.compare import canonical_contig_set


def reads_with_tips(genome, n_tips=6, seed=0):
    """Clean circular reads + repeated truncated-chimera reads that form tips.

    Each bad read = a genome window whose tail is replaced by random bases; it
    is repeated so the frequency cutoff alone cannot remove it, creating a
    short dead-end branch off the main path.
    """
    rng = np.random.default_rng(seed)
    reads = simulate_reads(genome, read_len=100, coverage=25, seed=seed + 1,
                           circular=True)
    for t in range(n_tips):
        pos = int(rng.integers(0, len(genome) - 100))
        junk = "".join("ACGT"[c] for c in rng.integers(0, 4, 30))
        bad = genome[pos : pos + 70] + junk
        reads.extend([bad[:100]] * 5)  # seen 5x: survives min_count=3
    return reads


@pytest.mark.parametrize("k", [21, 31])
def test_tip_clipping_matches_oracle(k):
    genome = random_genome(3000, seed=601)
    reads = reads_with_tips(genome, seed=602)
    cfg = AssemblyConfig(
        k=k, min_count=3, tip_rounds=3, read_batch=512, read_len=100,
        spectrum_capacity=1 << 15,
    )
    got = assemble_reads(reads, cfg)
    expected = assemble_oracle(reads, k, min_count=3, tip_rounds=3)
    assert canonical_contig_set(got.contig_strings) == expected


def test_tip_clipping_recovers_clean_assembly():
    k = 21
    genome = random_genome(2500, seed=611)
    reads = reads_with_tips(genome, seed=612)
    clean = simulate_reads(genome, read_len=100, coverage=25, seed=613, circular=True)
    cfg = AssemblyConfig(
        k=k, min_count=3, tip_rounds=3, read_batch=512, read_len=100,
        spectrum_capacity=1 << 15,
    )
    got = assemble_reads(reads, cfg)
    # with tips clipped, the assembly equals the clean-reads assembly
    assert canonical_contig_set(got.contig_strings) == assemble_oracle(clean, k)
    # without clipping it does NOT (tips fragment the graph)
    cfg_off = AssemblyConfig(
        k=k, min_count=3, read_batch=512, read_len=100, spectrum_capacity=1 << 15
    )
    got_off = assemble_reads(reads, cfg_off)
    assert canonical_contig_set(got_off.contig_strings) != assemble_oracle(clean, k)


def test_isolated_short_chain_survives():
    """Both-ends-dead chains are contigs, not tips (rule: exactly one dead end)."""
    k = 21
    g1 = random_genome(2000, seed=621)
    plasmid = random_genome(60, seed=622)  # short linear fragment, both ends dead
    reads = simulate_reads(g1, read_len=100, coverage=20, seed=623, circular=True)
    reads += [plasmid] * 4
    cfg = AssemblyConfig(
        k=k, tip_rounds=3, read_batch=512, read_len=100, spectrum_capacity=1 << 15
    )
    got = assemble_reads(reads, cfg)
    expected = assemble_oracle(reads, k, tip_rounds=3)
    assert canonical_contig_set(got.contig_strings) == expected
    assert any(len(c) == 60 for c in got.contig_strings)
