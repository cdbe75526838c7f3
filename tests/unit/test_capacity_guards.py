"""int32/uint32 frontier guards: the composite-key row
math in the counting paths wraps uint32 past 2^31 rows; these tests construct
the boundary condition at ZERO allocation (factory-time asserts and
jax.eval_shape abstract tracing) and check the guards fail loudly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_euler.kmer.count import Spectrum, merge_spectra_lean, oneshot_reduce
from tpu_euler.pipeline.assemble import make_arena_drain


def test_arena_drain_rejects_2p31_rows():
    # M = C + T >= 2^31 must fail at factory time, before any allocation
    with pytest.raises(AssertionError, match="2\\^31"):
        make_arena_drain(21, 1 << 30, 1 << 30)


def test_arena_drain_accepts_below_2p31():
    make_arena_drain(21, (1 << 30) - (1 << 20), 1 << 20 - 1)  # no raise


def test_oneshot_reduce_rejects_2p31_rows():
    s = (jax.ShapeDtypeStruct((1 << 31,), jnp.uint32),)
    with pytest.raises(AssertionError, match="2\\^31"):
        jax.eval_shape(lambda x: oneshot_reduce(x, 1 << 20), s)


def test_merge_lean_rejects_2p31_rows():
    C = 1 << 30
    acc = Spectrum(
        jax.ShapeDtypeStruct((C, 2), jnp.uint32),
        jax.ShapeDtypeStruct((C,), jnp.int32),
        jax.ShapeDtypeStruct((), jnp.int32),
    )
    with pytest.raises(AssertionError, match="2\\^31"):
        jax.eval_shape(lambda a, b: merge_spectra_lean(a, b, k=31), acc, acc)


def test_endpoint_payload_rejects_2p30_rows():
    """The graph endpoint sort packs row ids into 30 payload bits; 2C >= 2^30
    must fail loudly instead of corrupting strand/palindrome bits.
    Exercised abstractly via eval_shape."""
    from tpu_euler.graph.build import _canon_endpoint_parts

    C = 1 << 29
    fwd = jax.ShapeDtypeStruct((C, 2), jnp.uint32)
    valid = jax.ShapeDtypeStruct((C,), jnp.bool_)
    with pytest.raises(AssertionError, match="30 bits"):
        jax.eval_shape(lambda f, v: _canon_endpoint_parts(f, v, 31), fwd, valid)


def test_arena_drain_counts_exact_at_small_shapes():
    """Exactness spot-check of the drain the guards protect: random keys with
    duplicate multiplicities through two drain rounds == numpy Counter."""
    from collections import Counter

    rng = np.random.default_rng(9)
    C, T = 256, 96
    drain = make_arena_drain(21, C, T)
    SENT = np.uint32(0xFFFFFFFF)
    limb0 = rng.integers(0, 40, T).astype(np.uint32)  # k=21 -> 1 valid limb? no: 2 limbs
    limb1 = rng.integers(0, 7, T).astype(np.uint32)
    n_valid = 80
    limb0[n_valid:] = SENT
    limb1[n_valid:] = SENT

    bufs = (
        jnp.concatenate([jnp.full((C,), SENT), jnp.asarray(limb0)]),
        jnp.concatenate([jnp.full((C,), SENT), jnp.asarray(limb1)]),
    )
    counts = jnp.zeros((C + T,), jnp.uint32)
    bufs, counts, n, over = drain(bufs, counts)
    expected = Counter(zip(limb0[:n_valid].tolist(), limb1[:n_valid].tolist()))
    assert not bool(over)
    assert int(n) == len(expected)
    got = {}
    b0, b1, cn = np.asarray(bufs[0]), np.asarray(bufs[1]), np.asarray(counts)
    for i in range(int(n)):
        got[(int(b0[i]), int(b1[i]))] = int(cn[i])
    assert got == dict(expected)
    # keys sorted, fill region reset to sentinel
    assert np.all(b0[int(n) : C] == SENT)
    assert list(zip(b0[: int(n)], b1[: int(n)])) == sorted(expected)

    # second round: merge more raw keys on top of the accumulated head
    limb0b = rng.integers(0, 40, T).astype(np.uint32)
    limb1b = rng.integers(0, 7, T).astype(np.uint32)
    bufs = (
        jax.lax.dynamic_update_slice(bufs[0], jnp.asarray(limb0b), (C,)),
        jax.lax.dynamic_update_slice(bufs[1], jnp.asarray(limb1b), (C,)),
    )
    bufs, counts, n, over = drain(bufs, counts)
    expected.update(zip(limb0b.tolist(), limb1b.tolist()))
    assert not bool(over)
    assert int(n) == len(expected)
    b0, b1, cn = np.asarray(bufs[0]), np.asarray(bufs[1]), np.asarray(counts)
    got = {
        (int(b0[i]), int(b1[i])): int(cn[i]) for i in range(int(n))
    }
    assert got == dict(expected)
