"""The large-graph cleaning path (staged build + ruling-set chains) must be
bit-identical to the monolithic doubling path — forced at small scale via
big_edges=1 (the 12 Mbp adversarial run's cleaning graphs made the
monolithic jit the dominant cost and, pre-fix, ran out of device memory)."""

import numpy as np

from tpu_euler.config import AssemblyConfig
from tpu_euler.euler.clean import clip_tips, pop_bubbles
from tpu_euler.kmer.count import apply_cutoff
from tpu_euler.pipeline.assemble import count_spectrum
from tpu_euler.reference_impl.simulate import random_genome, simulate_reads


def _spectrum(reads, k, min_count):
    from tpu_euler.io.encode import encode_reads

    cfg = AssemblyConfig(
        k=k, read_batch=256, read_len=100, spectrum_capacity=1 << 15,
        min_count=min_count,
    )
    spec, _ = count_spectrum(encode_reads(reads, 100), cfg, {})
    return apply_cutoff(spec, min_count)


def _dirty_reads(seed=0):
    rng = np.random.default_rng(seed)
    genome = random_genome(2500, seed=seed + 1)
    reads = simulate_reads(
        genome, read_len=100, coverage=25, seed=seed + 2, circular=True
    )
    # tips: truncated reads running into junk
    for _ in range(3):
        p = int(rng.integers(0, len(genome) - 100))
        junk = "".join("ACGT"[c] for c in rng.integers(0, 4, 30))
        reads.extend([(genome[p : p + 70] + junk)[:100]] * 5)
    # bubbles: repeated SNP reads
    for _ in range(3):
        p = int(rng.integers(0, len(genome) - 100))
        w = list(genome[p : p + 100])
        w[50] = "ACGT"[("ACGT".index(w[50]) + 1) % 4]
        reads.extend(["".join(w)] * 5)
    return reads


def _eq(a, b):
    na, nb = int(a.n), int(b.n)
    assert na == nb
    assert np.array_equal(np.asarray(a.limbs)[:na], np.asarray(b.limbs)[:nb])
    assert np.array_equal(np.asarray(a.counts)[:na], np.asarray(b.counts)[:nb])


def test_big_clean_path_identical_tips():
    spec = _spectrum(_dirty_reads(40), 21, 3)
    small, n_small = clip_tips(spec, 21, 3)
    big, n_big = clip_tips(spec, 21, 3, big_edges=1)
    assert n_small == n_big > 0
    _eq(small, big)


def test_big_clean_path_identical_bubbles():
    spec = _spectrum(_dirty_reads(50), 21, 3)
    spec, _ = clip_tips(spec, 21, 3)
    small, n_small = pop_bubbles(spec, 21, 3)
    big, n_big = pop_bubbles(spec, 21, 3, big_edges=1)
    assert n_small == n_big > 0
    _eq(small, big)
