"""Host numpy reference for canonical k-mer extraction.

Independent of ``kmer.keys``: the reverse complement is packed directly from
the complemented bases in reverse order, by definition, instead of by bit
tricks on the forward key. Same key layout as ``kmer.keys`` (2 bits/base,
first base most significant, right-aligned in ceil(k/16) uint32 limbs, limb 0
most significant), so the two compare with ``==``.
"""

from __future__ import annotations

import numpy as np

BASE_N = 4


def canonical_kmers_np(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All k-windows of an [R, Lmax] code batch -> (canonical keys, valid).

    Returns keys [R * W, L] uint32 and valid [R * W] bool, W = Lmax - k + 1;
    a window is valid iff it holds no N/pad base (code 4). Keys of invalid
    windows are unspecified.
    """
    codes = np.asarray(codes)
    R, Lmax = codes.shape
    W = Lmax - k + 1
    L = -(-k // 16)
    fwd = np.zeros((L, R, W), np.uint32)
    rev = np.zeros((L, R, W), np.uint32)
    valid = np.ones((R, W), bool)
    for i in range(k):
        c = codes[:, i : i + W]
        valid &= c != BASE_N
        b = (c & 3).astype(np.uint32)
        # base i sits 2*(k-1-i) bits up the forward key; in the reverse
        # complement it is base k-1-i, complemented, 2*i bits up
        p = 2 * (k - 1 - i)
        fwd[L - 1 - p // 32] |= b << np.uint32(p % 32)
        q = 2 * i
        rev[L - 1 - q // 32] |= (np.uint32(3) - b) << np.uint32(q % 32)
    lt = np.zeros((R, W), bool)
    eq = np.ones((R, W), bool)
    for j in range(L):  # limb 0 is the most significant
        lt |= eq & (rev[j] < fwd[j])
        eq &= rev[j] == fwd[j]
    canon = np.where(lt[None], rev, fwd)
    return canon.transpose(1, 2, 0).reshape(R * W, L), valid.reshape(R * W)
