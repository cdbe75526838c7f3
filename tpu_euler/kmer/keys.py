"""Multi-limb 2-bit-packed k-mer keys.

Sort-friendly replacement for the reference's GPU hash-table keys (SURVEY.md section
2a R3/R4 — the PyCUDA reference packed l-tuples into 64-bit ints for a GPU hash
table; the mount was empty so this cites the survey, not files). Design choices:

* A k-mer is packed 2 bits/base (A=0, C=1, G=2, T=3), big-endian (first base most
  significant), **right-aligned** into ``L = ceil(k/16)`` uint32 limbs, limb 0 most
  significant. With fixed k, unsigned lexicographic comparison on the limb tuple
  equals lexicographic comparison on the base string.
* uint32 limbs instead of 64-bit ints: JAX runs with 64-bit types disabled, and
  XLA's variadic sort compares multiple uint32 key operands lexicographically —
  so k=41 (82-bit keys, SPEC config 5) costs one extra limb, not an emulated
  128-bit type. k must be odd so no k-mer is its own reverse complement.
* Arrays carry limbs in the trailing axis: shape [..., L]. All ops are vectorized
  and jit-safe (L and k are static).

Invalid slots are tracked with explicit validity masks (never sentinel keys: for
k % 16 == 0 the all-ones key is a legal poly-T k-mer).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Base codes. 4 = N / padding (invalid).
BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 0, 1, 2, 3, 4

_U32 = jnp.uint32
_FULL = np.uint32(0xFFFFFFFF)


def nlimbs(k: int) -> int:
    return -(-k // 16)


def _top_mask(k: int) -> int:
    """Mask of valid bits in limb 0 for a right-aligned 2k-bit key in L limbs."""
    L = nlimbs(k)
    top_bits = 2 * k - 32 * (L - 1)
    return int(_FULL) if top_bits == 32 else (1 << top_bits) - 1


def key_mask(k: int) -> np.ndarray:
    """Per-limb uint32 mask for a 2k-bit key, shape [L]."""
    L = nlimbs(k)
    m = np.full((L,), _FULL, dtype=np.uint32)
    m[0] = np.uint32(_top_mask(k))
    return m


@functools.partial(jax.jit, static_argnames=("k",))
def pack(codes: jax.Array, k: int) -> jax.Array:
    """Pack base codes [..., k] (int values 0..3) into limbs [..., L].

    Caller is responsible for masking windows containing N; this packs the low
    2 bits of each code.
    """
    L = nlimbs(k)
    codes = codes.astype(_U32) & _U32(3)
    limbs = []
    for a in range(L):  # a = limb index from most-significant side
        lj = L - 1 - a  # limb index from least-significant side
        lo_i = max(0, k - 16 * lj - 16)  # first base index in this limb
        hi_i = k - 1 - 16 * lj  # last base index in this limb
        acc = jnp.zeros(codes.shape[:-1], _U32)
        for i in range(lo_i, hi_i + 1):
            shift = 2 * (k - 1 - i) - 32 * lj
            acc = acc | (codes[..., i] << _U32(shift))
        limbs.append(acc)
    return jnp.stack(limbs, axis=-1)


def _rev2bit32(x: jax.Array) -> jax.Array:
    """Reverse the sixteen 2-bit groups within each uint32 lane."""
    x = ((x & _U32(0x33333333)) << _U32(2)) | ((x >> _U32(2)) & _U32(0x33333333))
    x = ((x & _U32(0x0F0F0F0F)) << _U32(4)) | ((x >> _U32(4)) & _U32(0x0F0F0F0F))
    x = ((x & _U32(0x00FF00FF)) << _U32(8)) | ((x >> _U32(8)) & _U32(0x00FF00FF))
    x = (x << _U32(16)) | (x >> _U32(16))
    return x


def _shift_right_bits(limbs: jax.Array, s: int) -> jax.Array:
    """Logical right shift of a multi-limb big-endian value by s bits (0<=s<32)."""
    if s == 0:
        return limbs
    lo = limbs >> _U32(s)
    carry = limbs << _U32(32 - s)
    hi = jnp.concatenate(
        [jnp.zeros_like(carry[..., :1]), carry[..., :-1]], axis=-1
    )
    return lo | hi


def _shift_left_bits(limbs: jax.Array, s: int) -> jax.Array:
    """Logical left shift by s bits (0<=s<32); overflow out of limb 0 is dropped."""
    if s == 0:
        return limbs
    hi = limbs << _U32(s)
    carry = limbs >> _U32(32 - s)
    lo = jnp.concatenate([carry[..., 1:], jnp.zeros_like(carry[..., :1])], axis=-1)
    return hi | lo


@functools.partial(jax.jit, static_argnames=("k",))
def revcomp(limbs: jax.Array, k: int) -> jax.Array:
    """Reverse complement of each key: reverse base order, complement each base.

    Works for keys stored in MORE limbs than nlimbs(k) (extra leading zero
    limbs) — e.g. the (k-1)-mer endpoints the graph build canonicalizes in the
    parent k-mer's limb count.
    """
    L = limbs.shape[-1]
    # Reverse all 16L 2-bit groups: per-limb group reversal + limb order reversal.
    rev = _rev2bit32(limbs)[..., ::-1]
    # The reversed key now sits in the HIGH 2k bits; realign to the low bits
    # (whole-limb shift first: the bit shift helper needs 0 <= s < 32).
    s = 32 * L - 2 * k
    if s >= 32:
        w = s // 32
        rev = jnp.concatenate(
            [jnp.zeros_like(rev[..., :w]), rev[..., : L - w]], axis=-1
        )
        s -= 32 * w
    rev = _shift_right_bits(rev, s)
    # Complement: each base c -> 3-c == c XOR 3, i.e. bitwise NOT on 2k bits.
    mask = jnp.asarray(key_mask(k))
    if L != nlimbs(k):
        mask = jnp.concatenate(
            [jnp.zeros((L - mask.shape[0],), _U32), mask]
        )
    return (rev ^ _FULL) & mask


@functools.partial(jax.jit, static_argnames=("k",))
def key_less(a: jax.Array, b: jax.Array, k: int | None = None) -> jax.Array:
    """Unsigned lexicographic a < b over the trailing limb axis."""
    L = a.shape[-1]
    lt = jnp.zeros(a.shape[:-1], bool)
    eq = jnp.ones(a.shape[:-1], bool)
    for j in range(L):
        lt = lt | (eq & (a[..., j] < b[..., j]))
        eq = eq & (a[..., j] == b[..., j])
    return lt


def key_eq(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.all(a == b, axis=-1)


@functools.partial(jax.jit, static_argnames=("k",))
def canonical(limbs: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Canonical form min(key, revcomp(key)); returns (canonical, was_rc)."""
    rc = revcomp(limbs, k)
    rc_smaller = key_less(rc, limbs, k)
    out = jnp.where(rc_smaller[..., None], rc, limbs)
    return out, rc_smaller


@functools.partial(jax.jit, static_argnames=("k",))
def prefix(limbs: jax.Array, k: int) -> jax.Array:
    """(k-1)-mer prefix: drop the last (least significant) base."""
    return _shift_right_bits(limbs, 2)


@functools.partial(jax.jit, static_argnames=("k",))
def suffix(limbs: jax.Array, k: int) -> jax.Array:
    """(k-1)-mer suffix: drop the first (most significant) base."""
    mask = jnp.asarray(key_mask(k - 1))
    if limbs.shape[-1] != nlimbs(k - 1):  # k-1 spans fewer limbs; keep L, mask top
        mask = jnp.concatenate(
            [jnp.zeros((limbs.shape[-1] - mask.shape[0],), _U32), mask]
        )
    return limbs & mask


@functools.partial(jax.jit, static_argnames=("k",))
def append_base(limbs: jax.Array, base: jax.Array, k: int) -> jax.Array:
    """(k+1)-mer from k-mer plus next base. Requires nlimbs(k+1) == nlimbs(k)
    (always true for odd k)."""
    assert nlimbs(k + 1) == nlimbs(k), "append_base requires headroom (odd k)"
    out = _shift_left_bits(limbs, 2)
    out = out.at[..., -1].set(out[..., -1] | (base.astype(_U32) & _U32(3)))
    return out & jnp.asarray(key_mask(k + 1))


def last_base(limbs: jax.Array) -> jax.Array:
    """Final (least significant) base code of each key."""
    return (limbs[..., -1] & _U32(3)).astype(jnp.int32)


def _mix32(x: jax.Array) -> jax.Array:
    """murmur3-style finalizer on uint32 lanes."""
    x = x ^ (x >> _U32(16))
    x = x * _U32(0x7FEB352D)
    x = x ^ (x >> _U32(15))
    x = x * _U32(0x846CA68B)
    x = x ^ (x >> _U32(16))
    return x


def bucket_hash(limbs: jax.Array) -> jax.Array:
    """32-bit scrambled hash of each key (fold over limbs), for bucket ownership.

    Used by the distributed spectrum exchange (SPEC D3): the owner of a k-mer is
    the top ``bucket_bits`` of this hash, so ownership is balanced (hash) yet
    contiguous in scrambled-key space (prefix partitioning, SPEC D4).
    """
    h = jnp.zeros(limbs.shape[:-1], _U32)
    for j in range(limbs.shape[-1]):
        h = _mix32(h ^ limbs[..., j])
    return h


def sort_by_key(limbs: jax.Array, valid: jax.Array, *payloads: jax.Array):
    """Sort rows by (invalid-last, key lexicographic). Returns (limbs, valid, *payloads).

    This is the workhorse primitive behind counting and CSR construction — the
    sort-based answer to the reference's atomics-based GPU hash table (SURVEY.md
    R4): XLA variadic sort with L+1 uint32 key operands.
    """
    L = limbs.shape[-1]
    inv = (~valid).astype(_U32)
    operands = [inv] + [limbs[..., j] for j in range(L)] + list(payloads)
    out = jax.lax.sort(operands, num_keys=L + 1, is_stable=True)
    sorted_limbs = jnp.stack(out[1 : L + 1], axis=-1)
    sorted_valid = out[0] == 0
    return (sorted_limbs, sorted_valid, *out[L + 1 :])


# ----------------------------------------------------------------------------
# Host-side (numpy) helpers for debugging / contig emission.
# ----------------------------------------------------------------------------

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def decode_np(limbs: np.ndarray, k: int) -> list[str]:
    """Decode numpy limb rows [..., L] into base strings (host side)."""
    limbs = np.asarray(limbs, dtype=np.uint64).reshape(-1, limbs.shape[-1])
    out = []
    L = limbs.shape[-1]
    for row in limbs:
        val = 0
        for j in range(L):
            val = (val << 32) | int(row[j])
        s = bytearray(k)
        for i in range(k - 1, -1, -1):
            s[i] = _BASES[val & 3]
            val >>= 2
        out.append(s.decode())
    return out


def encode_np(seqs: list[str], k: int) -> np.ndarray:
    """Encode base strings of length k into limb rows [N, L] (host side)."""
    L = nlimbs(k)
    out = np.zeros((len(seqs), L), dtype=np.uint32)
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    for n, s in enumerate(seqs):
        assert len(s) == k
        val = 0
        for ch in s:
            val = (val << 2) | code[ch]
        for j in range(L - 1, -1, -1):
            out[n, j] = val & 0xFFFFFFFF
            val >>= 32
    return out
