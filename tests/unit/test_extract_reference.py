"""XLA k-mer extraction vs the host numpy reference (reference_impl.kmers)."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_euler.io.encode import encode_reads
from tpu_euler.kmer.extract import extract_canonical_kmers
from tpu_euler.reference_impl.kmers import canonical_kmers_np
from tpu_euler.reference_impl.simulate import random_genome, simulate_reads


@pytest.mark.parametrize("k", [21, 31, 41], ids=lambda k: f"k={k}")
def test_extract_matches_numpy_reference(k):
    reads = simulate_reads(random_genome(800, seed=k), read_len=100, coverage=4, seed=k)
    reads[3] = reads[3][:40] + "N" + reads[3][41:]  # an N in the middle
    reads[5] = reads[5][:55]  # short read (padded)
    codes = encode_reads(reads, 100)
    limbs, valid = extract_canonical_kmers(jnp.asarray(codes), k)
    ref_limbs, ref_valid = canonical_kmers_np(codes, k)
    limbs, valid = np.asarray(limbs), np.asarray(valid)
    np.testing.assert_array_equal(valid, ref_valid)
    assert 0 < valid.sum() < valid.size  # the N and the padding drop windows
    np.testing.assert_array_equal(limbs[valid], ref_limbs[ref_valid])
