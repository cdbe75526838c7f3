"""Randomized property sweep (SURVEY.md section 4 property tests): for seeded
random parameter combinations, the device pipeline must equal the CPU oracle
exactly, and error-free assemblies must re-spell the genome."""

import numpy as np
import pytest

from tpu_euler.config import AssemblyConfig
from tpu_euler.pipeline.assemble import assemble_reads
from tpu_euler.reference_impl.oracle import assemble_oracle
from tpu_euler.reference_impl.simulate import random_genome, simulate_reads
from tpu_euler.verify.compare import canonical_contig_set, diff_contig_sets


# ---------------------------------------------------------------------------
# Adversarial genome profiles: repeat-heavy, homopolymer,
# GC-skewed and microsatellite genomes — the structures uniform-random fuzz
# never produces. Each must still match the CPU oracle EXACTLY.
# ---------------------------------------------------------------------------

_ADVERSARIAL = [
    # (name, genome_fn(glen, seed), k, cov, err, min_count, tips, bubbles)
    ("tandem_repeat", lambda n, s: __import__(
        "tpu_euler.reference_impl.simulate", fromlist=["x"]
    ).tandem_repeat_genome(n, unit_len=37, seed=s), 21, 25, 0.0, 1, 0, 0),
    ("tandem_mutated", lambda n, s: __import__(
        "tpu_euler.reference_impl.simulate", fromlist=["x"]
    ).tandem_repeat_genome(n, unit_len=53, seed=s, mutation_rate=0.01),
     25, 30, 0.0, 1, 0, 0),
    ("homopolymer", lambda n, s: __import__(
        "tpu_euler.reference_impl.simulate", fromlist=["x"]
    ).homopolymer_genome(n, seed=s, run_rate=0.03, max_run=40), 21, 25, 0.0,
     1, 0, 0),
    ("gc_skew_errored", lambda n, s: __import__(
        "tpu_euler.reference_impl.simulate", fromlist=["x"]
    ).skewed_genome(n, seed=s, gc=0.85), 21, 30, 0.005, 3, 2, 2),
    ("interspersed", lambda n, s: __import__(
        "tpu_euler.reference_impl.simulate", fromlist=["x"]
    ).interspersed_repeat_genome(n, seed=s, repeat_len=200, n_copies=5),
     31, 25, 0.0, 1, 0, 0),
    ("microsatellite", lambda n, s: __import__(
        "tpu_euler.reference_impl.simulate", fromlist=["x"]
    ).dinucleotide_repeat_genome(n, seed=s, array_len=300), 21, 25, 0.0,
     1, 0, 0),
]


@pytest.mark.parametrize(
    "profile", _ADVERSARIAL, ids=[p[0] for p in _ADVERSARIAL]
)
def test_adversarial_profiles_equal_oracle(profile):
    name, gen, k, cov, err, min_count, tips, bubbles = profile
    glen = 2500
    genome = gen(glen, 4242)
    reads = simulate_reads(
        genome, read_len=100, coverage=cov, seed=4300, error_rate=err,
        circular=False,
    )
    cfg = AssemblyConfig(
        k=k, min_count=min_count, tip_rounds=tips, bubble_rounds=bubbles,
        read_batch=512, read_len=100, spectrum_capacity=1 << 16,
    )
    got = assemble_reads(reads, cfg)
    expected = assemble_oracle(
        reads, k, min_count, tip_rounds=tips, bubble_rounds=bubbles
    )
    extra, missing = diff_contig_sets(got.contig_strings, expected)
    assert not extra and not missing, (
        f"profile {name}: {len(extra)} extra / {len(missing)} missing "
        f"of {len(expected)} oracle contigs"
    )
    assert len(expected) > 0


def test_adversarial_sharded_skew():
    """GC-skewed keys through the SHARDED distributed count+traversal path:
    ownership is by scrambled-key prefix, so composition skew is exactly what
    would overload one owner's slab if scrambling failed (the auto-retry /
    overflow machinery is the target here)."""
    import jax

    from tpu_euler.dist.pipeline import assemble_reads_distributed
    from tpu_euler.reference_impl.simulate import skewed_genome

    if jax.device_count() < 4:
        pytest.skip("needs 4 virtual devices")
    genome = skewed_genome(3000, seed=77, gc=0.88)
    reads = simulate_reads(genome, read_len=100, coverage=20, seed=78,
                           circular=False)
    cfg = AssemblyConfig(
        k=21, read_batch=256, read_len=100, spectrum_capacity=1 << 14,
    )
    res = assemble_reads_distributed(
        reads, cfg, n_devices=4, shard_traversal=True
    )
    expected = assemble_oracle(reads, 21, 1)
    extra, missing = diff_contig_sets(res.contig_strings, expected)
    assert not extra and not missing


@pytest.mark.parametrize("trial", range(8))
def test_fuzz_pipeline_equals_oracle(trial):
    rng = np.random.default_rng(7000 + trial)
    glen = int(rng.integers(800, 4000))
    k = int(rng.choice([17, 21, 25, 31, 41]))
    cov = float(rng.integers(12, 35))
    err = float(rng.choice([0.0, 0.0, 0.003, 0.008]))
    min_count = 1 if err == 0.0 else int(rng.integers(3, 5))
    tips = int(rng.choice([0, 0, 2])) if err else 0
    bubbles = int(rng.choice([0, 2, 3])) if err else 0
    circular = bool(rng.integers(0, 2))
    read_len = int(rng.choice([70, 100, 140]))
    if read_len <= k:
        read_len = k + 30

    genome = random_genome(glen, seed=8000 + trial)
    reads = simulate_reads(
        genome, read_len=read_len, coverage=cov, seed=9000 + trial,
        error_rate=err, circular=circular,
    )
    cfg = AssemblyConfig(
        k=k, min_count=min_count, tip_rounds=tips, bubble_rounds=bubbles,
        read_batch=512,
        read_len=read_len, spectrum_capacity=1 << 16,
    )
    got = assemble_reads(reads, cfg)
    expected = assemble_oracle(
        reads, k, min_count, tip_rounds=tips, bubble_rounds=bubbles
    )
    extra, missing = diff_contig_sets(got.contig_strings, expected)
    assert not extra and not missing, (
        f"trial {trial} (glen={glen} k={k} cov={cov} err={err} mc={min_count} "
        f"tips={tips} bubbles={bubbles} circ={circular} rl={read_len}): "
        f"{len(extra)} extra / {len(missing)} missing contigs"
    )
    if err == 0.0 and cov >= 15:
        # error-free: contigs must be genome substrings (up to revcomp/rotation)
        from tpu_euler.reference_impl.simulate import rc

        ref = genome + genome if circular else genome
        ref_rc = rc(genome) + rc(genome) if circular else rc(genome)
        for c in got.contig_strings:
            body = c[: len(genome)] if circular else c
            assert body in ref or body in ref_rc
