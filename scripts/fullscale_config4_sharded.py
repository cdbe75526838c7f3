"""SPEC config 4 at FULL scale through the REAL sharded mode.

BASELINE.json writes config 4 as "12 Mbp, 60x paired-end, k=31, graph sharded
across 2 hosts". Every prior full-scale artifact ran the replicated
single-chip path; this script runs the full 12 Mbp through
``assemble_reads_distributed(shard_traversal=True, local_input=True)`` with
TWO jax.distributed processes on the CPU mesh — byte-range FASTQ file shards
(O(file/2) parsed per process), hash-owner all_to_all counting (grouped
one-shot drains), prefix-partitioned sharded traversal at ~24M doubled edges
(6x the largest sharded instance ever run), O(E/n) fragment emission.

Gate: every process's contig set spells the genome exactly (one circular
contig, rotation-equal); per-process emission D2H stays O(E/n); slab retries
and stage timings are written to the --out record.

A CPU tool: every worker forces the CPU platform, so the two processes never
contend for a GPU.

Usage: python scripts/fullscale_config4_sharded.py [--bp 12000000] [--out F]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_PROCS = 2
N_LOCAL_DEV = 1  # one mesh device per process: "sharded across 2 hosts"

_BASES = b"ACGT"


def write_fastq_from_codes(codes, path: str) -> None:
    import numpy as np

    lut = np.frombuffer(_BASES, dtype=np.uint8)
    with open(path, "wb") as f:
        chunk = 1 << 17
        for lo in range(0, codes.shape[0], chunk):
            c = codes[lo : lo + chunk]
            seqs = lut[np.asarray(c) % 4]  # codes are 0..3 (error-free sim)
            lines = []
            for i in range(c.shape[0]):
                lines.append(b"@r%d\n" % (lo + i))
                lines.append(seqs[i].tobytes())
                lines.append(b"\n+\n")
                lines.append(b"I" * c.shape[1])
                lines.append(b"\n")
            f.write(b"".join(lines))


def worker(pid: int, n_procs: int, port: int, args) -> int:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={N_LOCAL_DEV}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n_procs,
        process_id=pid,
    )
    from tpu_euler.utils.runtime import setup_compilation_cache

    setup_compilation_cache()  # after distributed init (touches the backend)
    import logging

    import numpy as np

    from tpu_euler.config import AssemblyConfig
    from tpu_euler.dist.pipeline import assemble_reads_distributed
    from tpu_euler.io.fastx import read_shard

    # count slab-retry warnings (the artifact records them)
    retries = {"n": 0}

    class _RetryCounter(logging.Handler):
        def emit(self, record):
            if "retrying with a bigger slab" in record.getMessage():
                retries["n"] += 1

    logging.getLogger("tpu_euler").addHandler(_RetryCounter())
    logging.getLogger("tpu_euler").setLevel(logging.INFO)

    t0 = time.perf_counter()
    my_reads = [s for _, s in read_shard(args.fastq, pid, n_procs)]
    t_parse = time.perf_counter() - t0

    # spy on fragment emission D2H (O(E/n) bound, same as multiprocess_test)
    import tpu_euler.dist.traverse_dist as td

    captured = {}
    orig_lcf = td.local_chain_fragments

    def spy(sc, k):
        f = orig_lcf(sc, k)
        captured["d2h"] = f["d2h_bytes"]
        captured["rows_global"] = int(sc.valid.shape[0])
        captured["nlimbs"] = int(sc.edge_limbs.shape[1])
        return f

    td.local_chain_fragments = spy

    cfg = AssemblyConfig(
        k=31,
        read_batch=args.read_batch,
        read_len=100,
        spectrum_capacity=1 << 24,
    )
    t0 = time.perf_counter()
    res = assemble_reads_distributed(
        my_reads, cfg, shard_traversal=True, local_input=True
    )
    wall = time.perf_counter() - t0

    genome = open(args.genome_file).read()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from run_full_configs import spells_rotation

    contigs = list(res.contig_strings)
    ok = len(contigs) == 1 and spells_rotation(contigs[0], genome)
    bytes_global = captured.get("rows_global", 0) * (
        10 + 4 * captured.get("nlimbs", 1)
    )
    rec = {
        "proc": pid,
        "n_procs": n_procs,
        "reads_local_shard": len(my_reads),
        "reads_global": res.n_reads,
        "kmers_counted": res.n_kmers_counted,
        "distinct_kmers": res.n_distinct_kmers,
        "contigs": len(contigs),
        "genome_spelled_exactly": bool(ok),
        "wall_s": round(wall, 2),
        "parse_shard_s": round(t_parse, 2),
        "stages_s": {k2: round(v, 3) for k2, v in res.stage_seconds.items()},
        "slab_retries": retries["n"],
        "emission_d2h_bytes": captured.get("d2h"),
        "emission_d2h_bound_bytes": bytes_global // n_procs + 4096,
        "emission_d2h_within_bound": bool(
            captured.get("d2h", 1 << 62) <= bytes_global // n_procs + 4096
        ),
    }
    with open(f"{args.out}.proc{pid}", "w") as f:
        json.dump(rec, f, indent=1)
    print(f"proc {pid}: {'OK' if ok else 'FAIL'} wall={wall:.1f}s", flush=True)
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bp", type=int, default=12_000_000)
    ap.add_argument("--coverage", type=int, default=60)
    ap.add_argument("--read-batch", type=int, default=1 << 16)
    ap.add_argument("--out", default="scripts/c4_sharded.json")
    ap.add_argument("--cache-dir", default="scratch")
    ap.add_argument("--fastq", default="")
    ap.add_argument("--genome-file", default="")
    ap.add_argument("--worker", type=int, default=-1)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args()

    if args.worker >= 0:
        return worker(args.worker, N_PROCS, args.port, args)

    import numpy as np

    from tpu_euler.reference_impl.simulate import (
        random_genome,
        simulate_paired_read_codes,
    )

    os.makedirs(args.cache_dir, exist_ok=True)
    fq = os.path.join(args.cache_dir, f"c4_{args.bp}.fastq")
    gpath = os.path.join(args.cache_dir, f"c4_genome_{args.bp}.txt")
    t0 = time.perf_counter()
    if not (os.path.exists(fq) and os.path.exists(gpath)):
        genome = random_genome(args.bp, seed=404)
        codes = simulate_paired_read_codes(
            genome, read_len=100, coverage=args.coverage, seed=405,
            insert_size=300,
        )
        write_fastq_from_codes(codes, fq)
        with open(gpath, "w") as f:
            f.write(genome)
        del codes
    t_sim = time.perf_counter() - t0

    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(N_PROCS):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    os.path.abspath(__file__),
                    "--worker", str(pid),
                    "--port", str(port),
                    "--bp", str(args.bp),
                    "--read-batch", str(args.read_batch),
                    "--out", args.out,
                    "--fastq", fq,
                    "--genome-file", gpath,
                ]
            )
        )
    rc = 0
    for p in procs:
        rc |= p.wait()
    recs = []
    for pid in range(N_PROCS):
        try:
            recs.append(json.load(open(f"{args.out}.proc{pid}")))
        except Exception as e:
            recs.append({"proc": pid, "error": str(e)})
    payload = {
        "config": "4 yeast-scale FULL 12 Mbp 60x paired k=31 — SHARDED "
        "(2 jax.distributed processes, shard_traversal, byte-range file shards)",
        "genome_bp": args.bp,
        "sim_s": round(t_sim, 2),
        "pass": rc == 0,
        "procs": recs,
    }
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps({"pass": rc == 0, "out": args.out}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
