"""Clean per-op timings of the grouped-drain constituents at EXACT config-5
shapes (T=188.7M rows x 3 limbs per group, capacity C=120M), on the real chip.

Complements scripts/profile_config5_count.py (in-pipeline per-group splits):
this gives each op's isolated steady-state cost so the pipeline residual
(stalls, H2D, allocator pressure) = per-group wall minus these numbers.

Usage: python scripts/microbench_drain5.py [--t-rows N] [--cap N] [--out F]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_euler.utils.runtime import setup_compilation_cache

setup_compilation_cache()

import jax
import jax.numpy as jnp
import numpy as np

SENT = jnp.uint32(0xFFFFFFFF)


def sync(x):
    # a 1-element D2H readback per leaf is the completion fence (same as
    # microbench_drain)
    leaves = [l for l in jax.tree_util.tree_leaves(x) if hasattr(l, "ndim")]
    for l in leaves:
        np.asarray(jax.device_get(l[(0,) * l.ndim]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--t-rows", type=int, default=12 * (1 << 18) * 60)
    ap.add_argument("--cap", type=int, default=120_000_000)
    ap.add_argument("--distinct", type=int, default=84_000_000)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    T, C, D = args.t_rows, args.cap, args.distinct
    L = 3
    res = {"t_rows": T, "cap": C, "distinct": D, "ms": {}}

    def timeit(name, fn, *fargs, make=None, reps=args.reps):
        """make() regenerates donated inputs per rep (untimed)."""
        timed = []
        for r in range(reps + 1):  # rep 0 = compile warmup
            a = make() if make else fargs
            sync(a)
            t0 = time.perf_counter()
            out = fn(*a)
            sync(out)
            dt = time.perf_counter() - t0
            if r > 0:
                timed.append(dt)
            del out, a
        ms = sum(timed) / len(timed) * 1e3
        res["ms"][name] = round(ms, 1)
        print(f"{name:44s} {ms:9.1f} ms", flush=True)
        if args.out:  # incremental: survive a crash mid-run
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)

    # ---- synthetic group buffer: T rows drawn from D distinct 3-limb keys,
    # built in slabs to keep setup memory bounded
    pool = [
        jax.random.bits(jax.random.PRNGKey(7 + j), (D,), jnp.uint32)
        for j in range(L)
    ]
    pool[0] = pool[0] >> 2  # k=41 limb 0 uses 18 bits; just keep < sentinel

    # pool is passed as an ARGUMENT, not a closure: closure arrays become
    # program constants, and the compiler would be handed the whole 1 GB
    # pool per compile
    @jax.jit
    def _mk_buf(p):
        idx = jax.random.randint(jax.random.PRNGKey(100), (T,), 0, D, jnp.int32)
        return tuple(p[j][idx] for j in range(L))

    def make_buf():
        buf = _mk_buf(pool)
        sync(buf)
        return (buf,)

    from tpu_euler.kmer.count import Spectrum, merge_spectra_lean
    from tpu_euler.pipeline.assemble import make_oneshot_count

    # oneshot = donated sort + reduce; time the two jits separately
    oneshot = make_oneshot_count(41, C)
    sort_j = jax.jit(lambda b: tuple(jax.lax.sort(list(b), num_keys=len(b))),
                     donate_argnums=(0,))

    timeit("group sort (3-op, T rows, donated)", lambda b: sort_j(b),
           make=make_buf)

    # reduce step: needs a SORTED buffer
    def make_sorted():
        (b,) = make_buf()
        s = sort_j(b)
        sync(s)
        return (s,)

    # replicate reduce_step's body via the public oneshot on a sorted-ish
    # buffer is wrong (it sorts again); instead grab the inner reduce jit by
    # timing oneshot total and subtracting is noisy — time the composite and
    # the sort; reduce = composite - sort.
    timeit("oneshot total (sort+reduce)", lambda b: oneshot(b), make=make_buf)

    # ---- lean merge at capacity scale: acc (n=D live) + grp (n=D live)
    @jax.jit
    def _mk_spec(p, xor):
        i = jnp.arange(C, dtype=jnp.int32)
        src = jnp.minimum(i, D - 1)
        limbs = jnp.stack(
            [jnp.where(i < D, p[j][src] ^ xor * jnp.uint32(j + 1), 0)
             for j in range(L)], axis=-1)
        return Spectrum(limbs, jnp.ones((C,), jnp.int32),
                        jnp.asarray(D, jnp.int32))

    def make_specs():
        acc = _mk_spec(pool, jnp.uint32(0))
        grp = _mk_spec(pool, jnp.uint32(1))
        sync((acc, grp))
        return (acc, grp)

    timeit("merge_spectra_lean (C+C rows, 4-op sort)",
           lambda a, g: merge_spectra_lean(a, g, k=41), make=make_specs)

    # ---- sentinel buffer alloc (3 x T uint32 fulls)
    fulls = jax.jit(lambda: tuple(jnp.full((T,), SENT) for _ in range(L)))
    timeit("sentinel buffer alloc (3xT full)", lambda: fulls(), make=lambda: ())

    # ---- round-5 arena drain (two carry-payload sorts, no gathers) at the
    # same shapes: C-row head of ~D uniques + T raw rows
    from tpu_euler.pipeline.assemble import make_arena_drain

    drain = make_arena_drain(41, C, T)
    M = C + T

    @jax.jit
    def _mk_arena(p):
        i = jnp.arange(M, dtype=jnp.int32)
        idx = jax.random.randint(jax.random.PRNGKey(200), (M,), 0, D, jnp.int32)
        head = i < D  # "accumulated" uniques
        tail = i >= C  # raw fill region
        bufs = tuple(
            jnp.where(head | tail, p[j][idx], SENT) for j in range(L)
        )
        counts = jnp.where(head, jnp.uint32(2), jnp.uint32(0))
        return bufs, counts

    def make_arena():
        bufs, counts = _mk_arena(pool)
        sync((bufs, counts))
        return (bufs, counts)

    timeit("arena drain (2 sorts, C+T rows, donated)",
           lambda b, c: drain(b, c), make=make_arena)

    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
