"""Oracle integration tests (SURVEY.md section 4): the device pipeline's contig set
must exactly equal the CPU oracle's after canonicalization — the SPEC bar."""

import pytest

from tpu_euler.config import AssemblyConfig
from tpu_euler.pipeline.assemble import assemble_reads
from tpu_euler.reference_impl.oracle import assemble_oracle
from tpu_euler.reference_impl.simulate import PHIX174, random_genome, simulate_reads
from tpu_euler.verify.compare import canonical_contig_set, diff_contig_sets


def check_equal(reads, cfg):
    got = assemble_reads(reads, cfg)
    expected = assemble_oracle(reads, cfg.k, cfg.min_count)
    only_got, only_exp = diff_contig_sets(got.contig_strings, expected)
    assert not only_got and not only_exp, (
        f"contig mismatch: {len(only_got)} extra, {len(only_exp)} missing; "
        f"extra lens {[len(c) for c in list(only_got)[:5]]}, "
        f"missing lens {[len(c) for c in list(only_exp)[:5]]}"
    )
    return got


def test_config1_phix_error_free_k21():
    """SPEC config 1: phiX174-sized circular genome, error-free 100bp reads, k=21."""
    reads = simulate_reads(PHIX174, read_len=100, coverage=30, seed=42, circular=True)
    cfg = AssemblyConfig(
        k=21, read_batch=512, read_len=100, spectrum_capacity=1 << 14
    )
    got = check_equal(reads, cfg)
    # error-free circular genome with unique k-mers -> single circular contig
    assert len(got.contigs) == 1
    assert len(next(iter(got.contigs))) == len(PHIX174) + cfg.k - 1


def test_repeat_genome_k31():
    rep = random_genome(300, seed=61)
    genome = (
        random_genome(800, seed=62)
        + rep
        + random_genome(700, seed=63)
        + rep
        + random_genome(600, seed=64)
    )
    reads = [genome[i : i + 100] for i in range(0, len(genome) - 100 + 1, 3)]
    reads.append(genome[-100:])
    cfg = AssemblyConfig(k=31, read_batch=512, read_len=100, spectrum_capacity=1 << 14)
    got = check_equal(reads, cfg)
    assert len(got.contigs) > 1  # repeat breaks the genome into unitigs


def test_error_reads_with_cutoff_k21():
    """SPEC config 3 shape: errored reads + frequency cutoff."""
    genome = random_genome(3000, seed=71)
    reads = simulate_reads(
        genome, read_len=100, coverage=40, seed=72, circular=True, error_rate=0.005
    )
    cfg = AssemblyConfig(
        k=21, min_count=4, read_batch=512, read_len=100, spectrum_capacity=1 << 16
    )
    got = check_equal(reads, cfg)
    # cutoff should recover the clean assembly
    clean = simulate_reads(genome, read_len=100, coverage=40, seed=72, circular=True)
    assert canonical_contig_set(got.contig_strings) == assemble_oracle(clean, 21)


def test_short_and_ragged_reads():
    genome = random_genome(1000, seed=81)
    reads = [genome[i : i + 60 + (i % 30)] for i in range(0, 900, 7)]
    cfg = AssemblyConfig(k=21, read_batch=256, read_len=96, spectrum_capacity=1 << 13)
    check_equal([r[:96] for r in reads], cfg)


def test_k41_pipeline():
    """SPEC config 5 key shape: k=41 needs 3 uint32 limbs (>64-bit keys)."""
    genome = random_genome(2000, seed=91)
    reads = simulate_reads(genome, read_len=120, coverage=25, seed=92, circular=True)
    cfg = AssemblyConfig(k=41, read_batch=256, read_len=120, spectrum_capacity=1 << 14)
    check_equal(reads, cfg)


def test_multiple_components():
    g1 = random_genome(900, seed=101)
    g2 = random_genome(700, seed=102)
    reads = simulate_reads(g1, 80, 20, seed=103, circular=True) + simulate_reads(
        g2, 80, 20, seed=104, circular=True
    )
    cfg = AssemblyConfig(k=21, read_batch=512, read_len=80, spectrum_capacity=1 << 14)
    got = check_equal(reads, cfg)
    assert len(got.contigs) == 2


def test_streamed_and_oneshot_counting_agree():
    """Both counting strategies produce identical spectra/contigs."""
    import dataclasses

    genome = random_genome(2500, seed=111)
    reads = simulate_reads(genome, read_len=100, coverage=18, seed=112, circular=True)
    base = AssemblyConfig(k=31, read_batch=256, read_len=100, spectrum_capacity=1 << 14)
    one = assemble_reads(reads, base)  # one-shot (small run)
    streamed = assemble_reads(
        reads, dataclasses.replace(base, oneshot_rows=0)
    )
    assert one.contigs == streamed.contigs
    assert one.n_distinct_kmers == streamed.n_distinct_kmers
    assert one.n_kmers_counted == streamed.n_kmers_counted
    # grouped one-shot (config-5 scale path): force multiple groups — 18
    # reads/batch x 70 windows = 1260 rows/batch; 3 batches per group
    grouped = assemble_reads(
        reads, dataclasses.replace(base, read_batch=18, oneshot_rows=3 * 18 * 70)
    )
    assert one.contigs == grouped.contigs
    assert one.n_distinct_kmers == grouped.n_distinct_kmers
    assert one.n_kmers_counted == grouped.n_kmers_counted
    # grouped with a partial final group
    grouped2 = assemble_reads(
        reads, dataclasses.replace(base, read_batch=64, oneshot_rows=2 * 64 * 70)
    )
    assert one.contigs == grouped2.contigs
    assert one.n_kmers_counted == grouped2.n_kmers_counted
