"""Deterministic genome / read simulators for tests and benchmarks.

SURVEY.md section 4 (golden files): seeded generators only — no network access
exists in the build environment, and the real phiX174 FASTA cannot be fetched, so
config 1's "phiX174" is represented by a deterministic synthetic circular genome
of the same length (5386 bp). All generators are seeded and stable across runs.
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = str.maketrans("ACGT", "TGCA")

PHIX_LENGTH = 5386


def rc(s: str) -> str:
    return s.translate(_COMP)[::-1]


def random_genome(length: int, seed: int = 0, circular: bool = True) -> str:
    """Seeded uniform-random genome string (A/C/G/T)."""
    rng = np.random.default_rng(seed)
    return bytes(_BASES[rng.integers(0, 4, length)]).decode()


# Deterministic stand-in for phiX174 (5386 bp circular ssDNA phage genome).
PHIX174 = random_genome(PHIX_LENGTH, seed=174, circular=True)


def simulate_reads(
    genome: str,
    read_len: int = 100,
    coverage: float = 30.0,
    seed: int = 0,
    error_rate: float = 0.0,
    circular: bool = True,
    both_strands: bool = True,
    paired: bool = False,
    insert_size: int = 300,
) -> list[str]:
    """Simulate uniform shotgun reads from a genome.

    Substitution errors only (Illumina-like), at ``error_rate`` per base.
    If ``paired``, emits read pairs (fwd mate, then revcomp mate) per fragment.
    """
    rng = np.random.default_rng(seed)
    g = genome + genome[: max(read_len, insert_size)] if circular else genome
    max_start = (len(genome)) if circular else (len(genome) - read_len + 1)
    if max_start <= 0:
        raise ValueError("genome shorter than read length")
    n_frag = int(np.ceil(coverage * len(genome) / (read_len * (2 if paired else 1))))
    reads: list[str] = []
    starts = rng.integers(0, max_start, n_frag)
    strands = rng.integers(0, 2, n_frag) if both_strands else np.zeros(n_frag, int)
    for s, st in zip(starts, strands):
        if paired:
            frag = g[s : s + insert_size]
            if len(frag) < insert_size:
                continue
            r1, r2 = frag[:read_len], rc(frag[-read_len:])
            if st:
                r1, r2 = rc(r2), rc(r1)
            reads.extend([r1, r2])
        else:
            r = g[s : s + read_len]
            if len(r) < read_len:
                continue
            reads.append(rc(r) if st else r)
    if error_rate > 0.0:
        reads = _add_errors(reads, error_rate, rng)
    return reads


def simulate_read_codes(
    genome: str,
    read_len: int = 100,
    coverage: float = 30.0,
    seed: int = 0,
    error_rate: float = 0.0,
    circular: bool = True,
    both_strands: bool = True,
) -> np.ndarray:
    """Vectorized simulator: returns an [R, read_len] int8 code matrix directly.

    Same model as simulate_reads (uniform substitution errors, random strand)
    but fully numpy — used for benchmark-scale inputs (millions of reads) where
    per-read Python string slicing would dominate the measured pipeline.
    """
    rng = np.random.default_rng(seed)
    lut = np.full(256, 4, dtype=np.int8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    g = lut[np.frombuffer(genome.encode(), dtype=np.uint8)]
    G = len(g)
    n_reads = int(np.ceil(coverage * G / read_len))
    max_start = G if circular else G - read_len + 1
    if max_start <= 0:
        raise ValueError("genome shorter than read length")
    starts = rng.integers(0, max_start, n_reads)
    codes = np.empty((n_reads, read_len), np.int8)
    rl = np.arange(read_len)[None, :]
    chunk = 1 << 22  # bound the int64 offset intermediate at config-5 scale
    for lo in range(0, n_reads, chunk):
        s = starts[lo : lo + chunk]
        offs = (s[:, None] + rl) % G if circular else s[:, None] + rl
        codes[lo : lo + len(s)] = g[offs]
    if both_strands:
        flip = rng.integers(0, 2, n_reads).astype(bool)
        codes[flip] = (3 - codes[flip])[:, ::-1]
    if error_rate > 0.0:
        for lo in range(0, n_reads, chunk):
            c = codes[lo : lo + chunk]
            mask = rng.random(c.shape) < error_rate
            shift = rng.integers(1, 4, c.shape).astype(np.int8)
            codes[lo : lo + chunk] = np.where(mask, (c + shift) % 4, c)
    return codes


def simulate_paired_read_codes(
    genome: str,
    read_len: int = 100,
    coverage: float = 30.0,
    seed: int = 0,
    insert_size: int = 300,
    circular: bool = True,
    chunk: int = 1 << 22,
) -> np.ndarray:
    """Vectorized paired-end simulator: [2*n_frag, read_len] int8 codes.

    Same fragment model as simulate_reads(paired=True): each fragment yields a
    forward mate (first read_len bases) and a reverse-complement mate (last
    read_len bases, revcomp'd). Generated in chunks so the int64 offset
    intermediate stays bounded at full-organism scale (config 4: 7.2M pairs).
    """
    rng = np.random.default_rng(seed)
    lut = np.full(256, 4, dtype=np.int8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    g = lut[np.frombuffer(genome.encode(), dtype=np.uint8)]
    G = len(g)
    n_frag = int(np.ceil(coverage * G / (2 * read_len)))
    max_start = G if circular else G - insert_size + 1
    if max_start <= 0:
        raise ValueError("genome shorter than insert size")
    starts = rng.integers(0, max_start, n_frag)
    out = np.empty((2 * n_frag, read_len), np.int8)
    rl = np.arange(read_len)[None, :]
    for lo in range(0, n_frag, chunk):
        s = starts[lo : lo + chunk]
        o1 = (s[:, None] + rl) % G if circular else s[:, None] + rl
        o2 = (
            (s[:, None] + (insert_size - read_len) + rl) % G
            if circular
            else s[:, None] + (insert_size - read_len) + rl
        )
        out[2 * lo : 2 * lo + 2 * len(s) : 2] = g[o1]
        out[2 * lo + 1 : 2 * lo + 1 + 2 * len(s) : 2] = (3 - g[o2])[:, ::-1]
    return out


# ---------------------------------------------------------------------------
# Adversarial genome profiles. Uniform-random genomes have
# unique k-mers whp, which never stresses repeat resolution, cycle cutting on
# short periodic cycles, homopolymer self-loops, or hash-owner balance. These
# seeded generators produce the structures real genomes are full of.
# ---------------------------------------------------------------------------


def tandem_repeat_genome(
    length: int,
    unit_len: int = 37,
    seed: int = 0,
    mutation_rate: float = 0.0,
    flank: int = 200,
) -> str:
    """Random flanks around a long tandem array of one repeat unit.

    Every k <= unit_len window inside the array occurs ~array/unit_len times:
    high-multiplicity k-mers and a repeat-collapsed cycle in the graph.
    ``mutation_rate`` > 0 sprinkles per-copy point mutations so near-identical
    copies create bubbles.
    """
    rng = np.random.default_rng(seed)
    unit = _BASES[rng.integers(0, 4, unit_len)]
    n_copies = max(1, (length - 2 * flank) // unit_len)
    arr = np.tile(unit, n_copies)
    if mutation_rate > 0.0:
        mask = rng.random(arr.size) < mutation_rate
        shift = rng.integers(1, 4, arr.size)
        lut = np.full(256, 0, np.int64)
        for i, b in enumerate(b"ACGT"):
            lut[b] = i
        codes = lut[arr]
        arr = np.where(mask, _BASES[(codes + shift) % 4], arr)
    left = _BASES[rng.integers(0, 4, flank)]
    right = _BASES[rng.integers(0, 4, max(0, length - 2 * flank - arr.size) + flank)]
    return bytes(np.concatenate([left, arr, right])[:length]).decode()


def homopolymer_genome(
    length: int, seed: int = 0, run_rate: float = 0.02, max_run: int = 30
) -> str:
    """Random genome with injected homopolymer runs (up to ``max_run`` bases).

    Long A/T/G/C runs produce k-mers equal to their own shifted selves —
    SELF-LOOP edges (prefix == suffix node) and period-1 cycles, the
    degenerate cases of successor pairing and cycle cutting.
    """
    rng = np.random.default_rng(seed)
    out = np.empty(length + max_run, np.uint8)
    i = 0
    while i < length:
        if rng.random() < run_rate:
            n = int(rng.integers(5, max_run + 1))
            out[i : i + n] = _BASES[rng.integers(0, 4)]
            i += n
        else:
            out[i] = _BASES[rng.integers(0, 4)]
            i += 1
    return bytes(out[:length]).decode()


def skewed_genome(length: int, seed: int = 0, gc: float = 0.8) -> str:
    """GC-skewed composition (default 80% G+C).

    Skew concentrates k-mers in a small corner of key space — the stress
    test for scrambled-prefix ownership balance in the distributed exchange
    (slab overflow/auto-retry) and for sort-segment imbalance.
    """
    rng = np.random.default_rng(seed)
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return bytes(_BASES[rng.choice(4, size=length, p=p)]).decode()


def interspersed_repeat_genome(
    length: int,
    seed: int = 0,
    repeat_len: int = 300,
    n_copies: int = 6,
) -> str:
    """Random backbone with one ``repeat_len`` element pasted at ``n_copies``
    random non-overlapping loci (transposon-like interspersed repeats).

    Each copy's boundary k-mers create branch nodes where the Eulerian walk
    must split contigs; the repeat interior collapses to multiplicity
    ``n_copies``.
    """
    rng = np.random.default_rng(seed)
    g = _BASES[rng.integers(0, 4, length)]
    elem = _BASES[rng.integers(0, 4, repeat_len)]
    # clamp to the available non-overlapping slot count so rng.choice cannot
    # raise when the genome is short relative to n_copies * repeat_len
    population = max(1, (length - repeat_len) // repeat_len)
    slots = rng.choice(
        population, size=min(n_copies, population), replace=False
    ) * repeat_len
    for s in slots:
        g[s : s + repeat_len] = elem
    return bytes(g).decode()


def dinucleotide_repeat_genome(
    length: int, seed: int = 0, array_len: int = 400
) -> str:
    """Random genome with a (AC)n microsatellite array in the middle.

    Period-2 repeats make 2-cycles in the de Bruijn graph whose two k-mers
    are each other's shifts — minimal-length cycles for the deterministic
    cycle-cutting rule, plus revcomp symmetry ((GT)n on the other strand).
    """
    rng = np.random.default_rng(seed)
    g = _BASES[rng.integers(0, 4, length)]
    mid = (length - array_len) // 2
    unit = np.frombuffer(b"AC", dtype=np.uint8)
    g[mid : mid + array_len] = np.tile(unit, array_len // 2 + 1)[:array_len]
    return bytes(g).decode()


def _add_errors(reads: list[str], rate: float, rng: np.random.Generator) -> list[str]:
    out = []
    for r in reads:
        arr = np.frombuffer(r.encode(), dtype=np.uint8).copy()
        mask = rng.random(len(arr)) < rate
        if mask.any():
            # substitute with a *different* base: code -> (code + 1 + u) % 4
            codes = np.zeros(len(arr), np.int64)
            for i, b in enumerate(b"ACGT"):
                codes[arr == b] = i
            shift = rng.integers(1, 4, mask.sum())
            codes[mask] = (codes[mask] + shift) % 4
            arr[mask] = _BASES[codes[mask]]
        out.append(bytes(arr).decode())
    return out
