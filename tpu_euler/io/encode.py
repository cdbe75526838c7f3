"""Host-side base encoding: read strings -> dense padded code batches.

Reference counterpart: SURVEY.md R2 (base encoder, A/C/G/T -> 2-bit codes). The
design keeps one int8 code per base on host and on device ([R, Lmax] batches,
N/pad = 4); 2-bit packing happens on device during k-mer extraction where it
fuses with windowing (tpu_euler/kmer/extract.py). Encoding is a numpy table
lookup — vectorized, no Python loop over bases.
"""

from __future__ import annotations

import numpy as np

BASE_N = 4

_LUT = np.full(256, BASE_N, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i
for _i, _b in enumerate(b"acgt"):
    _LUT[_b] = _i

_BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode_reads(reads: list[str] | list[bytes], read_len: int) -> np.ndarray:
    """Encode reads into an [R, read_len] int8 code matrix.

    Reads longer than ``read_len`` are truncated; shorter ones padded with N (=4).
    Unknown characters (including N) encode to 4 and invalidate the k-windows
    covering them.
    """
    R = len(reads)
    out = np.full((R, read_len), BASE_N, dtype=np.int8)
    for i, r in enumerate(reads):
        if isinstance(r, str):
            r = r.encode()
        L = min(len(r), read_len)
        out[i, :L] = _LUT[np.frombuffer(r[:L], dtype=np.uint8)]
    return out


def encode_reads_with_qual(
    reads: list[str],
    quals: list[str],
    read_len: int,
    min_qual: int,
    qual_offset: int = 33,
) -> np.ndarray:
    """Encode reads, masking bases with phred quality < min_qual as N.

    Low-quality bases invalidate only the k-windows covering them (SPEC config 3:
    real Illumina reads with sequencing errors), complementing the k-mer
    frequency cutoff.
    """
    out = encode_reads(reads, read_len)
    thresh = np.uint8(min_qual + qual_offset)
    for i, q in enumerate(quals):
        qa = np.frombuffer(q.encode(), dtype=np.uint8)[:read_len]
        low = qa < thresh
        if low.any():
            out[i, : len(qa)][low] = BASE_N
    return out


def pack_codes_np(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack an [R, L] int8 code matrix for H2D transfer: 2.25 bits/base.

    The 1-byte-per-base code matrix would be the largest host->device
    transfer at benchmark scale; packed it is ~3.5x smaller. Returns
    (packed [R, ceil(L/4)] uint8 — 4 bases/byte little-endian within the byte,
    nmask [R, ceil(L/8)] uint8 — 1 bit per base, set where the base is N/pad).
    Device-side inverse: kmer.extract.unpack_codes.
    """
    R, L = codes.shape
    L4, L8 = -(-L // 4), -(-L // 8)
    c = (codes.astype(np.uint8) & 3).astype(np.uint8)
    if L4 * 4 != L:
        c = np.concatenate([c, np.zeros((R, L4 * 4 - L), np.uint8)], axis=1)
    c = c.reshape(R, L4, 4)
    packed = c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)
    isn = (codes >= 4) | (codes < 0)
    if L8 * 8 != L:
        isn = np.concatenate([isn, np.ones((R, L8 * 8 - L), bool)], axis=1)
    isn = isn.reshape(R, L8, 8).astype(np.uint8)
    nmask = isn[:, :, 0]
    for b in range(1, 8):
        nmask = nmask | (isn[:, :, b] << b)
    return packed, nmask


def pack_codes(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """2.25-bit pack for H2D transfer; native threaded codec, numpy fallback."""
    from tpu_euler.io.native import pack_codes_native

    out = pack_codes_native(codes)
    return out if out is not None else pack_codes_np(codes)


def decode_read(codes: np.ndarray) -> str:
    """Decode one int8 code row back to a string (pads stripped)."""
    codes = np.asarray(codes)
    s = bytes(_BASES[np.clip(codes, 0, 4)]).decode()
    return s.rstrip("N")
