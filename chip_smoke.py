"""Smoke test of the assembler's main path on an NVIDIA GPU.

    python chip_smoke.py               # one card: device, extract, oracle, cli, large
    python chip_smoke.py --multi-gpu   # four cards: the sharded paths only

Phases (one card):

* ``device``  -- JAX's default backend must be a GPU; nothing falls back.
* ``extract`` -- ``extract_canonical_kmers`` at the bench batch [2^18, 100]
  for k = 21, 31, 41 (2 and 3 limbs), with N bases and short reads, equal
  to the host numpy reference; times the fill step at that shape.
* ``oracle``  -- ``assemble_codes`` on three datasets (errored reads with
  cutoff, tips and bubbles; k=41; a repeat genome), each equal to the CPU
  oracle as a canonical contig set.
* ``cli``     -- SPEC config 2 (4.6 Mbp, 50x, 100 bp, k=31) written to FASTQ
  and assembled twice through ``tpu_euler.cli.main`` in this process: one
  contig spelling a rotation of the genome, no host fallback, identical
  contig sets in both runs.
* ``large``   -- a 36 Mbp genome at 40x through ``assemble_codes``, twice:
  grouped counting with the arena drain (>= 2 groups) and the staged ``big``
  build (> 2^26 doubled edges), held to the same single-rotation check and
  to identical contigs in both runs.

``--multi-gpu`` runs only ``__graft_entry__.dryrun_multichip(4)`` (sharded
and replicated traversal against the oracle) and the ``cli`` FASTQ through
``--mesh 4`` and ``--mesh 4 --shard-traversal``, and checks that every card
held part of the work.

Everything runs in this one process: a second JAX process could not get the
card's memory. Any failed check raises and the exit code is non-zero. The
last line of standard output is one JSON object naming the devices; it is
printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

SEED = 2024
EXTRACT_BATCH = (1 << 18, 100)  # the bench's read batch
CLI_GENOME_BP, CLI_COVERAGE = 4_600_000, 50
LARGE_GENOME_BP, LARGE_COVERAGE = 36_000_000, 40
READ_LEN = 100


def say(msg: str) -> None:
    print(msg, flush=True)


class CompileMeter:
    """Backend compile seconds and persistent-cache hits, from JAX's events."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.compiles = 0
        self.cache_hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._duration)
        jax.monitoring.register_event_listener(self._event)

    def _duration(self, event, duration_secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration_secs
            self.compiles += 1

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1

    def snapshot(self) -> tuple[float, int, int]:
        return self.seconds, self.compiles, self.cache_hits

    def since(self, snap) -> dict:
        return {
            "compile_s": round(self.seconds - snap[0], 3),
            "compiles": self.compiles - snap[1],
            "cache_hits": self.cache_hits - snap[2],
        }


def peak_gib() -> list[float]:
    import jax

    return [
        round((d.memory_stats() or {}).get("peak_bytes_in_use", 0) / 2**30, 3)
        for d in jax.local_devices()
    ]


def device_time(trace_dir: str) -> tuple[float, dict]:
    """Device busy seconds (union of the device events) in a profiler trace,
    and the seconds of each kernel name."""
    import jax

    (path,) = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    spans, kernels = [], {}
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for e in line.events:
                spans.append((e.start_ns, e.end_ns))
                kernels[e.name] = kernels.get(e.name, 0.0) + e.duration_ns / 1e9
    busy, end = 0, 0
    for a, b in sorted(spans):
        busy += max(0, b - max(a, end))
        end = max(end, b)
    check(busy > 0, f"no device events in {path}")
    return busy / 1e9, kernels


def is_genome_rotation(contig: str, genome: str, k: int) -> bool:
    """A circular genome's single contig: G + k - 1 bases whose first G are a
    rotation of the genome or of its reverse complement, wrapping by k - 1."""
    from tpu_euler.reference_impl.simulate import rc

    G = len(genome)
    if len(contig) != G + k - 1 or contig[G:] != contig[: k - 1]:
        return False
    body = contig[:G]
    return body in genome + genome or body in rc(genome) * 2


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------- phases


def phase_device(n_expected: int | None) -> None:
    import jax

    from tpu_euler.utils.runtime import require_gpu

    require_gpu()
    devs = jax.devices()
    say(f"[device] jax {jax.__version__}; {len(devs)} x {devs[0].device_kind} "
        f"({devs[0].platform})")
    if n_expected is not None:
        check(len(devs) >= n_expected, f"need {n_expected} GPUs, have {len(devs)}")


def _extract_codes(rng) -> np.ndarray:
    """Random reads at the bench batch shape with N bases and short reads."""
    R, Lr = EXTRACT_BATCH
    codes = rng.integers(0, 4, (R, Lr)).astype(np.int8)
    rows = rng.integers(0, R, R // 50)
    codes[rows, rng.integers(0, Lr, rows.size)] = 4  # N bases
    codes[::64, 55:] = 4  # short reads, N-padded
    return codes


def phase_extract(tmp: str) -> dict:
    import jax
    import jax.numpy as jnp

    from tpu_euler.io.encode import pack_codes
    from tpu_euler.kmer.extract import extract_canonical_kmers
    from tpu_euler.pipeline.assemble import make_extract_fill_step
    from tpu_euler.reference_impl.kmers import canonical_kmers_np

    rng = np.random.default_rng(SEED)
    codes = _extract_codes(rng)
    R, Lr = codes.shape
    packed_h, nmask_h = pack_codes(codes)
    packed, nmask = jnp.asarray(packed_h), jnp.asarray(nmask_h)
    out = {}
    for k in (21, 31, 41):
        limbs, valid = extract_canonical_kmers(jnp.asarray(codes), k)
        limbs, valid = np.asarray(limbs), np.asarray(valid)
        ref_limbs, ref_valid = canonical_kmers_np(codes, k)
        check(np.array_equal(valid, ref_valid), f"extract k={k}: validity differs")
        check(np.array_equal(limbs[valid], ref_limbs[valid]), f"extract k={k}: keys differ")
        del limbs, ref_limbs

        # the fill step as the pipeline runs it: unpack + extract + sentinel
        # + write into the key buffer (donated, so the calls chain)
        W = Lr - k + 1
        L = -(-k // 16)
        fill = make_extract_fill_step(k, Lr)
        buf = tuple(jnp.full((R * W,), jnp.uint32(0xFFFFFFFF)) for _ in range(L))
        start = jnp.asarray(0, jnp.int32)
        buf, nw = fill(packed, nmask, buf, start)  # compile + warm-up
        check(int(nw) == int(ref_valid.sum()), f"fill k={k}: window count differs")
        reps = 20
        trace = tempfile.mkdtemp(dir=tmp)
        with jax.profiler.trace(trace):
            for _ in range(reps):
                buf, nw = fill(packed, nmask, buf, start)
            jax.block_until_ready(buf)
        busy_s, kernels = device_time(trace)
        nbytes = packed_h.nbytes + nmask_h.nbytes + R * W * L * 4
        out[f"k={k}"] = {
            "device_ms": round(busy_s / reps * 1e3, 4),
            "bytes": nbytes,
            "gb_per_s": round(nbytes / (busy_s / reps) / 1e9, 1),
            "kernels_us": {n: round(v / reps * 1e6, 1) for n, v in kernels.items()},
        }
        del buf
    say(f"[extract] equal to the numpy reference at {list(EXTRACT_BATCH)}, "
        f"k=21,31,41; fill step per call (device time, profiler trace of 20 "
        f"calls after warm-up): {json.dumps(out)}")
    return out


def phase_oracle() -> None:
    from tpu_euler.config import AssemblyConfig
    from tpu_euler.io.encode import encode_reads
    from tpu_euler.pipeline.assemble import assemble_codes
    from tpu_euler.reference_impl.oracle import assemble_oracle
    from tpu_euler.reference_impl.simulate import random_genome, simulate_reads
    from tpu_euler.verify.compare import canonical_contig_set

    genome = random_genome(60_000, seed=1234)
    errored = simulate_reads(
        genome, read_len=100, coverage=20, seed=5678, error_rate=0.003, circular=True
    )
    rep = random_genome(300, seed=61)
    rgenome = (
        random_genome(800, seed=62) + rep + random_genome(700, seed=63) + rep
        + random_genome(600, seed=64)
    )
    repeat = [rgenome[i : i + 100] for i in range(0, len(rgenome) - 100 + 1, 3)]
    repeat.append(rgenome[-100:])
    cases = [
        ("errored+cutoff+tips+bubbles", errored, AssemblyConfig(
            k=31, read_batch=2048, read_len=100, spectrum_capacity=1 << 18,
            min_count=3, tip_rounds=3, bubble_rounds=2)),
        ("k41", simulate_reads(random_genome(3_000, seed=4321), read_len=120,
                               coverage=15, seed=8765, circular=True),
         AssemblyConfig(k=41, read_batch=64, read_len=120, spectrum_capacity=1 << 13)),
        ("repeat_k31", repeat, AssemblyConfig(
            k=31, read_batch=512, read_len=100, spectrum_capacity=1 << 14)),
    ]
    for name, reads, cfg in cases:
        t0 = time.perf_counter()
        res = assemble_codes(encode_reads(reads, cfg.read_len), cfg)
        wall = time.perf_counter() - t0
        got = canonical_contig_set(res.contig_strings)
        expected = assemble_oracle(
            reads, cfg.k, min_count=cfg.min_count, tip_rounds=cfg.tip_rounds,
            bubble_rounds=cfg.bubble_rounds,
        )
        check(got == expected, f"oracle {name}: {len(got)} contigs vs {len(expected)}")
        say(f"[oracle] {name}: {len(got)} contigs equal to the oracle "
            f"({res.n_reads} reads, {wall:.3f} s incl. compile)")


def write_fastq(codes: np.ndarray, path: str) -> None:
    """Error-free codes -> FASTQ, all records built in one numpy array."""
    R, Lr = codes.shape
    rec = np.empty((R, 3 + Lr + 3 + Lr + 1), np.uint8)
    rec[:, 0:3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3 : 3 + Lr] = np.frombuffer(b"ACGT", np.uint8)[codes]
    rec[:, 3 + Lr : 6 + Lr] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + Lr : 6 + 2 * Lr] = ord("I")
    rec[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def config2_fastq(tmp: str) -> tuple[str, str]:
    from tpu_euler.reference_impl.simulate import random_genome, simulate_read_codes

    genome = random_genome(CLI_GENOME_BP, seed=SEED)
    codes = simulate_read_codes(
        genome, read_len=READ_LEN, coverage=CLI_COVERAGE, seed=SEED + 1, circular=True
    )
    path = os.path.join(tmp, "config2.fq")
    write_fastq(codes, path)
    return path, genome


def run_cli(fq: str, tmp: str, tag: str, genome: str, extra=()) -> set[str]:
    """Assemble through the CLI in this process; check the single rotation."""
    from tpu_euler import cli
    from tpu_euler.euler import extract
    from tpu_euler.io.fastx import read_fasta

    out_fa = os.path.join(tmp, f"{tag}.fa")
    metrics = os.path.join(tmp, f"{tag}.json")
    fallbacks = extract.HOST_FALLBACKS
    rc = cli.main(["assemble", fq, "-k", "31", "-o", out_fa, "--metrics-json", metrics,
                   *extra])
    check(rc == 0, f"cli {tag}: exit {rc}")
    contigs = [s for _, s in read_fasta(out_fa)]
    check(len(contigs) == 1, f"cli {tag}: {len(contigs)} contigs, want 1")
    check(is_genome_rotation(contigs[0], genome, 31),
          f"cli {tag}: contig of {len(contigs[0])} bp is not a rotation of the genome")
    check(extract.HOST_FALLBACKS == fallbacks, f"cli {tag}: emission fell back to the host")
    with open(metrics) as f:
        m = json.load(f)
    say(f"[cli] {tag}: 1 contig of {len(contigs[0])} bp, wall {m['wall_s']} s, "
        f"parse {m['parse_s']} s, stages_s {json.dumps(m['stages_s'])}")
    return set(contigs)


def phase_cli(fq: str, genome: str, tmp: str, meter: CompileMeter) -> None:
    sets = []
    for run in ("run1", "run2"):
        snap = meter.snapshot()
        sets.append(run_cli(fq, tmp, run, genome))
        say(f"[cli] {run} compile: {json.dumps(meter.since(snap))}")
    check(sets[0] == sets[1], "cli: the two runs gave different contig sets")
    say("[cli] both runs gave identical contig sets")


def phase_large() -> None:
    from tpu_euler.config import AssemblyConfig
    from tpu_euler.pipeline.assemble import _n_batches, assemble_codes
    from tpu_euler.reference_impl.simulate import random_genome, simulate_read_codes

    t0 = time.perf_counter()
    genome = random_genome(LARGE_GENOME_BP, seed=SEED + 10)
    codes = simulate_read_codes(
        genome, read_len=READ_LEN, coverage=LARGE_COVERAGE, seed=SEED + 11, circular=True
    )
    t_sim = time.perf_counter() - t0
    cfg = AssemblyConfig(
        k=31, read_batch=1 << 18, read_len=READ_LEN, spectrum_capacity=1 << 26
    )
    Wb = cfg.read_batch * cfg.windows_per_read
    n_groups = -(-_n_batches(codes, cfg) // max(1, cfg.oneshot_rows // Wb))
    check(n_groups >= 2, f"large: {n_groups} counting group(s), want >= 2")
    runs = []
    for _ in range(2):  # cold (compiles) then warm; must agree exactly
        t0 = time.perf_counter()
        res = assemble_codes(codes, cfg)
        runs.append((time.perf_counter() - t0, res))
    (wall1, res1), (wall, res) = runs
    check(res1.contigs == res.contigs, "large: the two runs gave different contigs")
    # E = 2 x the right-sized capacity >= 2 x the live k-mers
    check(2 * res.n_distinct_kmers > 1 << 26,
          f"large: {res.n_distinct_kmers} k-mers do not reach the big path")
    contigs = list(res.contig_strings)
    check(len(contigs) == 1, f"large: {len(contigs)} contigs, want 1")
    check(is_genome_rotation(contigs[0], genome, cfg.k),
          "large: the contig is not a rotation of the genome")
    say(f"[large] {LARGE_GENOME_BP} bp x{LARGE_COVERAGE}: {res.n_reads} reads, "
        f"{res.n_kmers_counted} windows in {n_groups} groups, "
        f"{res.n_distinct_kmers} k-mers, 1 contig, identical in both runs; "
        f"simulate {t_sim:.3f} s; run1 {wall1:.3f} s (incl. compile), "
        f"run2 {wall:.3f} s, stages_s "
        f"{json.dumps({s: round(v, 3) for s, v in res.stage_seconds.items()})}")


def phase_multi_gpu(tmp: str) -> None:
    import jax

    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    say(f"[multi-gpu] dryrun_multichip(4) equal to the oracle "
        f"({time.perf_counter() - t0:.3f} s)")
    fq, genome = config2_fastq(tmp)
    run_cli(fq, tmp, "mesh4", genome, ["--mesh", "4"])
    run_cli(fq, tmp, "mesh4_sharded", genome, ["--mesh", "4", "--shard-traversal"])
    peaks = peak_gib()[:4]
    say(f"[multi-gpu] peak GiB per device: {peaks}")
    check(len(jax.devices()) >= 4 and min(peaks) > 0.1 * max(peaks),
          f"multi-gpu: work not spread over 4 devices (peak GiB {peaks})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the sharded paths, over four GPUs")
    args = ap.parse_args(argv)

    import jax

    from tpu_euler.utils.runtime import card_info, setup_compilation_cache

    phase_device(4 if args.multi_gpu else None)
    cache = setup_compilation_cache()
    meter = CompileMeter()
    say(f"[device] compile cache: {cache}")
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if args.multi_gpu:
            phases = [("multi-gpu", lambda: phase_multi_gpu(tmp))]
        else:
            fq, genome = config2_fastq(tmp)
            phases = [
                ("extract", lambda: phase_extract(tmp)),
                ("oracle", phase_oracle),
                ("cli", lambda: phase_cli(fq, genome, tmp, meter)),
                ("large", phase_large),
            ]
        for name, fn in phases:
            snap = meter.snapshot()
            t0 = time.perf_counter()
            fn()
            say(f"[{name}] ok in {time.perf_counter() - t0:.3f} s; "
                f"{json.dumps(meter.since(snap))}; peak GiB {peak_gib()}")
    say(f"[total] {time.perf_counter() - t_all:.3f} s; compile "
        f"{json.dumps(meter.since((0.0, 0, 0)))}")
    dev = jax.devices()[0]
    say(card_info())  # nvidia-smi's own "name, power.limit" line(s)
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
