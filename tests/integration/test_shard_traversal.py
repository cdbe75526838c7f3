"""Fully sharded traversal (SPEC configs 4-5): identical contigs to the
replicated path and the CPU oracle on 2/4/8-device meshes."""

import numpy as np
import pytest

from tpu_euler.config import AssemblyConfig
from tpu_euler.dist.pipeline import assemble_reads_distributed
from tpu_euler.reference_impl.oracle import assemble_oracle
from tpu_euler.reference_impl.simulate import random_genome, simulate_reads
from tpu_euler.verify.compare import canonical_contig_set


@pytest.fixture(scope="module")
def dataset():
    genome = random_genome(3500, seed=801)
    reads = simulate_reads(genome, read_len=100, coverage=22, seed=802, circular=True)
    return genome, reads


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_traversal_matches_oracle(dataset, n_dev):
    _, reads = dataset
    cfg = AssemblyConfig(k=21, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    got = assemble_reads_distributed(reads, cfg, n_devices=n_dev, shard_traversal=True)
    oracle = assemble_oracle(reads, cfg.k)
    assert canonical_contig_set(got.contig_strings) == oracle


def test_sharded_equals_replicated(dataset):
    _, reads = dataset
    cfg = AssemblyConfig(k=31, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    a = assemble_reads_distributed(reads, cfg, n_devices=4, shard_traversal=True)
    b = assemble_reads_distributed(reads, cfg, n_devices=4, shard_traversal=False)
    assert a.contigs == b.contigs
    assert a.n_distinct_kmers == b.n_distinct_kmers


def test_fragment_emission_matches_full_fetch(dataset):
    """The O(E/n)-D2H fragment emission path returns exactly the contigs the
    old full-array download produced, and accounts its D2H bytes."""
    from tpu_euler.dist.mesh import fetch_global, make_mesh
    from tpu_euler.dist.traverse_dist import (
        assemble_contig_fragments,
        local_chain_fragments,
        make_dist_chains_step,
        make_dist_cutoff_step,
    )
    from tpu_euler.euler.extract import assemble_contig_bytes
    from tpu_euler.dist.pipeline import assemble_reads_distributed

    _, reads = dataset
    k = 21
    cfg = AssemblyConfig(k=k, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    # run the sharded pipeline up to ShardChains by hand
    import jax
    from tpu_euler.dist.count_dist import empty_dist_spectrum

    res = assemble_reads_distributed(reads, cfg, n_devices=4, shard_traversal=True)

    # reconstruct sc for a direct comparison of the two emission paths
    mesh = make_mesh(4)
    from tpu_euler.dist import pipeline as dp

    # simplest: recount through the dist pipeline pieces
    from tpu_euler.dist.count_dist import make_dist_count_step
    from tpu_euler.dist.mesh import batch_sharding
    from tpu_euler.io.encode import encode_reads

    n_dev = 4
    rows = cfg.read_batch
    c_dest = int(2.0 * rows * cfg.windows_per_read / n_dev + 256)
    c_local = cfg.spectrum_capacity // n_dev
    count_step = make_dist_count_step(cfg.k, n_dev, c_dest, mesh)
    sharding = batch_sharding(mesh)
    from tpu_euler.dist.count_dist import DistSpectrum

    acc = empty_dist_spectrum(n_dev, c_local, cfg.nlimbs)
    acc = jax.device_put(
        acc,
        DistSpectrum(limbs=sharding, counts=sharding, n=sharding, dropped=sharding),
    )
    step_rows = rows * n_dev
    total = len(reads)
    for s in range((total + step_rows - 1) // step_rows):
        batch = reads[s * step_rows : (s + 1) * step_rows]
        cb = encode_reads(batch, cfg.read_len)
        if cb.shape[0] < step_rows:
            pad = np.full((step_rows - cb.shape[0], cfg.read_len), 4, np.int8)
            cb = np.concatenate([cb, pad], axis=0)
        acc, _ = count_step(jax.device_put(cb, sharding), acc)
    cut = make_dist_cutoff_step(cfg.min_count, mesh)
    cl, cc, cn = cut(acc.limbs, acc.counts, acc.n)
    sc = make_dist_chains_step(cfg.k, n_dev, c_local, mesh)(cl, cc, cn)

    # old full-fetch path
    valid = fetch_global(sc.valid)
    idx = np.flatnonzero(valid)
    old = assemble_contig_bytes(
        fetch_global(sc.chain)[idx],
        fetch_global(sc.pos)[idx],
        fetch_global(sc.edge_limbs)[idx],
        k,
    )
    # new fragment path
    frag = local_chain_fragments(sc, k)
    new = assemble_contig_fragments([frag], k)
    assert new == old
    assert res.contigs == new
    assert frag["d2h_bytes"] > 0
    # compact fragment material is far below the device-array volume
    compact = frag["chain"].nbytes + frag["pos"].nbytes + frag["base"].nbytes
    assert compact < frag["d2h_bytes"]


def test_sharded_with_cutoff_and_repeats():
    rep = random_genome(200, seed=811)
    genome = (
        random_genome(900, seed=812) + rep + random_genome(700, seed=813) + rep
        + random_genome(500, seed=814)
    )
    reads = simulate_reads(genome, read_len=100, coverage=30, seed=815,
                           error_rate=0.004, circular=False)
    cfg = AssemblyConfig(
        k=21, min_count=4, read_batch=128, read_len=100, spectrum_capacity=1 << 15
    )
    got = assemble_reads_distributed(reads, cfg, n_devices=8, shard_traversal=True)
    oracle = assemble_oracle(reads, cfg.k, min_count=4)
    assert canonical_contig_set(got.contig_strings) == oracle


def test_sharded_k41_three_limb_keys():
    """SPEC config 5 shape: k=41 (3 uint32 limbs) through the sharded path."""
    genome = random_genome(1500, seed=821)
    reads = simulate_reads(genome, read_len=120, coverage=18, seed=822, circular=True)
    cfg = AssemblyConfig(k=41, read_batch=64, read_len=120, spectrum_capacity=1 << 13)
    got = assemble_reads_distributed(reads, cfg, n_devices=8, shard_traversal=True)
    assert canonical_contig_set(got.contig_strings) == assemble_oracle(reads, 41)


def test_sharded_paired_end_reads():
    """SPEC config 4 shape: paired-end reads, graph sharded."""
    genome = random_genome(2500, seed=831)
    reads = simulate_reads(
        genome, read_len=100, coverage=25, seed=832, circular=True,
        paired=True, insert_size=280,
    )
    cfg = AssemblyConfig(k=31, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    got = assemble_reads_distributed(reads, cfg, n_devices=4, shard_traversal=True)
    assert canonical_contig_set(got.contig_strings) == assemble_oracle(reads, 31)


def test_sharded_tip_clipping_matches_oracle():
    """Tips clipped identically through the sharded path (configs 4-5 + errors)."""
    import numpy as np

    rng = np.random.default_rng(840)
    genome = random_genome(2500, seed=841)
    reads = simulate_reads(genome, read_len=100, coverage=25, seed=842, circular=True)
    for t in range(5):
        p = int(rng.integers(0, len(genome) - 100))
        junk = "".join("ACGT"[c] for c in rng.integers(0, 4, 30))
        reads.extend([(genome[p : p + 70] + junk)[:100]] * 5)
    cfg = AssemblyConfig(
        k=21, min_count=3, tip_rounds=3, read_batch=128, read_len=100,
        spectrum_capacity=1 << 15,
    )
    got = assemble_reads_distributed(reads, cfg, n_devices=8, shard_traversal=True)
    expected = assemble_oracle(reads, 21, min_count=3, tip_rounds=3)
    assert canonical_contig_set(got.contig_strings) == expected
    assert len(expected) == 1  # clean single-circle recovery


def test_dist_tip_step_matches_host_rows():
    """On-device sharded tip step == host find_tip_rows on every device count."""
    import jax

    from tpu_euler.dist.count_dist import (
        DistSpectrum,
        empty_dist_spectrum,
        make_dist_count_step,
    )
    from tpu_euler.dist.mesh import batch_sharding, fetch_global, make_mesh
    from tpu_euler.dist.traverse_dist import (
        find_tip_rows,
        make_dist_chains_step,
        make_dist_cutoff_step,
        make_dist_tip_step,
    )
    from tpu_euler.io.encode import encode_reads

    rng = np.random.default_rng(850)
    genome = random_genome(2500, seed=851)
    reads = simulate_reads(genome, read_len=100, coverage=25, seed=852, circular=True)
    for t in range(5):
        p = int(rng.integers(0, len(genome) - 100))
        junk = "".join("ACGT"[c] for c in rng.integers(0, 4, 30))
        reads.extend([(genome[p : p + 70] + junk)[:100]] * 5)
    cfg = AssemblyConfig(
        k=21, min_count=3, read_batch=128, read_len=100, spectrum_capacity=1 << 14
    )
    for n_dev in (2, 8):
        mesh = make_mesh(n_dev)
        c_local = cfg.spectrum_capacity // n_dev
        windows = cfg.read_batch * cfg.windows_per_read
        count_step = make_dist_count_step(cfg.k, n_dev, int(2.0 * windows / n_dev + 256), mesh)
        sharding = batch_sharding(mesh)
        acc = jax.device_put(
            empty_dist_spectrum(n_dev, c_local, cfg.nlimbs),
            DistSpectrum(limbs=sharding, counts=sharding, n=sharding, dropped=sharding),
        )
        step_rows = cfg.read_batch * n_dev
        for i in range(0, len(reads), step_rows):
            batch = reads[i : i + step_rows]
            cb = encode_reads(batch, cfg.read_len)
            if cb.shape[0] < step_rows:
                cb = np.concatenate(
                    [cb, np.full((step_rows - cb.shape[0], cfg.read_len), 4, np.int8)]
                )
            acc, _ = count_step(jax.device_put(cb, sharding), acc)
        cut = make_dist_cutoff_step(cfg.min_count, mesh)
        cl, cc, cn = cut(acc.limbs, acc.counts, acc.n)
        sc = make_dist_chains_step(cfg.k, n_dev, c_local, mesh)(cl, cc, cn)
        tip_len = 2 * cfg.k
        keep_dev, n_tips_dev, drops = make_dist_tip_step(tip_len, n_dev, c_local, mesh)(
            sc.valid, sc.chain, sc.pos, sc.tail_dead, sc.head_dead
        )
        keep_host, n_tips_host = find_tip_rows(sc, cfg.k, tip_len, c_local)
        assert int(fetch_global(drops)[0]) == 0
        assert int(fetch_global(n_tips_dev)[0]) == n_tips_host
        assert n_tips_host > 0  # the dataset really has tips
        np.testing.assert_array_equal(fetch_global(keep_dev), keep_host)


def test_slab_overflow_auto_retry(dataset, caplog):
    """A too-small first slab factor overflows, is caught, and the retry at a
    sane factor still produces oracle-equal contigs."""
    import logging

    _, reads = dataset
    cfg = AssemblyConfig(k=21, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    with caplog.at_level(logging.WARNING, logger="tpu_euler"):
        got = assemble_reads_distributed(
            reads, cfg, n_devices=4, shard_traversal=True,
            slab_factors=(0.02, 2.0),
        )
    assert canonical_contig_set(got.contig_strings) == assemble_oracle(reads, cfg.k)
    assert any("retrying with a bigger slab" in r.message for r in caplog.records)


def test_slab_overflow_exhausted_raises(dataset):
    """When every slab factor overflows, the failure is loud and actionable."""
    import pytest as _pytest

    _, reads = dataset
    cfg = AssemblyConfig(k=21, read_batch=128, read_len=100, spectrum_capacity=1 << 15)
    with _pytest.raises(RuntimeError, match="slab_factor"):
        assemble_reads_distributed(
            reads, cfg, n_devices=4, shard_traversal=True,
            slab_factors=(0.02,),
        )


def test_sharded_bubble_popping_matches_oracle():
    """Bubble popping through the SHARDED path — contigs
    identical to the CPU oracle and to the replicated pipeline."""
    import sys

    sys.path.insert(0, "tests/integration")
    from test_bubbles import reads_with_bubbles

    from tpu_euler.pipeline.assemble import assemble_reads

    k = 21
    genome = random_genome(3000, seed=761)
    reads = reads_with_bubbles(genome, seed=762)
    cfg = AssemblyConfig(
        k=k, min_count=3, bubble_rounds=3, read_batch=128, read_len=100,
        spectrum_capacity=1 << 15,
    )
    got = assemble_reads_distributed(
        reads, cfg, n_devices=4, shard_traversal=True
    )
    expected = assemble_oracle(reads, k, min_count=3, bubble_rounds=3)
    assert canonical_contig_set(got.contig_strings) == expected
    repl = assemble_reads(reads, cfg)
    assert got.contigs == repl.contigs


def test_sharded_tips_and_bubbles_combined():
    """Config-3-style errored input: cutoff + tips + bubbles all through the
    sharded path, equal-coverage tie-break included."""
    import sys

    sys.path.insert(0, "tests/integration")
    from test_bubbles import reads_with_bubbles

    k = 21
    genome = random_genome(2800, seed=771)
    rng = np.random.default_rng(772)
    reads = reads_with_bubbles(genome, n_bubbles=3, seed=773)
    for _ in range(3):
        p = int(rng.integers(0, len(genome) - 100))
        junk = "".join("ACGT"[c] for c in rng.integers(0, 4, 30))
        reads.extend([(genome[p : p + 70] + junk)[:100]] * 5)
    # an equal-coverage bubble exercises the minkey tie-break path
    pos = 900
    w = list(genome[pos : pos + 100])
    w[50] = "ACGT"[("ACGT".index(w[50]) + 2) % 4]
    reads.extend(["".join(w)] * 25)
    cfg = AssemblyConfig(
        k=k, min_count=3, tip_rounds=3, bubble_rounds=3, read_batch=128,
        read_len=100, spectrum_capacity=1 << 15,
    )
    got = assemble_reads_distributed(
        reads, cfg, n_devices=8, shard_traversal=True
    )
    expected = assemble_oracle(
        reads, k, min_count=3, tip_rounds=3, bubble_rounds=3
    )
    assert canonical_contig_set(got.contig_strings) == expected
