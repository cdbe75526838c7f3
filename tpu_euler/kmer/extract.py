"""k-mer extraction from encoded read batches.

Data-parallel counterpart of the reference's per-thread l-tuple extraction kernel
(SURVEY.md section 2a R3: one CUDA thread per read offset). Here a read batch is a
dense [R, Lmax] int8 code matrix and extraction is k static shifted slices fused
by XLA into a single vectorized window-pack — no scalar loops, no dynamic shapes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpu_euler.kmer import keys

BASE_N = 4  # padding / unknown base code


@functools.partial(jax.jit, static_argnames=("k",))
def extract_kmers(codes: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Extract all k-windows of a read batch.

    Args:
      codes: [R, Lmax] int8 base codes (0..3, 4 = N/pad).
      k: k-mer length.

    Returns:
      limbs: [R * W, L] uint32 keys (W = Lmax - k + 1 windows per read).
      valid: [R * W] bool — window contains no N/pad bases.
    """
    R, Lmax = codes.shape
    W = Lmax - k + 1
    # windows[r, w, i] = codes[r, w + i]; k static slices, XLA fuses the stack.
    windows = jnp.stack([codes[:, i : i + W] for i in range(k)], axis=-1)
    valid = jnp.all(windows != BASE_N, axis=-1)
    limbs = keys.pack(windows, k)
    return limbs.reshape(R * W, -1), valid.reshape(R * W)


@functools.partial(jax.jit, static_argnames=("k",))
def extract_canonical_kmers(codes: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Extract + canonicalize (min of k-mer and reverse complement)."""
    limbs, valid = extract_kmers(codes, k)
    canon, _ = keys.canonical(limbs, k)
    return canon, valid


@functools.partial(jax.jit, static_argnames=("read_len",))
def unpack_codes(packed: jax.Array, nmask: jax.Array, read_len: int) -> jax.Array:
    """Device-side inverse of io.encode.pack_codes_np: -> [R, read_len] int8.

    XLA fuses the unpack shifts into the extraction windowing, so shipping
    2.25 bits/base host->device costs no extra device-memory pass.
    """
    R = packed.shape[0]
    sh2 = jnp.arange(4, dtype=jnp.uint8) * 2
    c = (packed[:, :, None] >> sh2[None, None, :]) & jnp.uint8(3)
    c = c.reshape(R, -1)[:, :read_len]
    sh1 = jnp.arange(8, dtype=jnp.uint8)
    nb = (nmask[:, :, None] >> sh1[None, None, :]) & jnp.uint8(1)
    nb = nb.reshape(R, -1)[:, :read_len]
    return (c + nb * jnp.uint8(4)).astype(jnp.int8)


def unpack_codes_clean(packed: jax.Array, read_len: int) -> jax.Array:
    """``unpack_codes`` for batches with NO N/pad bases: the all-zeros
    validity bitmap (~a third of the packed H2D bytes) is never shipped —
    the fill step has a separate compiled variant for clean batches, which
    real error-free batches at benchmark scale always are."""
    R = packed.shape[0]
    sh2 = jnp.arange(4, dtype=jnp.uint8) * 2
    c = (packed[:, :, None] >> sh2[None, None, :]) & jnp.uint8(3)
    return c.reshape(R, -1)[:, :read_len].astype(jnp.int8)
