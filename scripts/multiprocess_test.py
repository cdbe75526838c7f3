"""True multi-process distributed assembly test (SURVEY.md section 4: spawn N
processes with jax.distributed.initialize for real cross-process collectives —
the single-host stand-in for a multi-host run).

A CPU tool: every worker forces the CPU platform with virtual devices, so it
runs the same on a machine with or without a GPU.

Usage: python scripts/multiprocess_test.py [n_procs]   (parent mode)
Exit 0 iff every process assembles the shared dataset to the oracle contig set
through the sharded-traversal pipeline over the global mesh.
"""

from __future__ import annotations

import os
import subprocess
import sys

N_LOCAL_DEV = 2  # virtual CPU devices per process


def worker(n_procs: int, pid: int, port: int) -> int:
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
    assert len(jax.devices()) == n_procs * N_LOCAL_DEV

    from tpu_euler.config import AssemblyConfig
    from tpu_euler.dist.pipeline import assemble_reads_distributed
    from tpu_euler.io.fastx import read_shard
    from tpu_euler.reference_impl.oracle import assemble_oracle
    from tpu_euler.reference_impl.simulate import random_genome, simulate_reads
    from tpu_euler.verify.compare import canonical_contig_set

    genome = random_genome(1500, seed=901)
    reads = simulate_reads(genome, read_len=80, coverage=15, seed=902, circular=True)
    cfg = AssemblyConfig(k=21, read_batch=32, read_len=80, spectrum_capacity=1 << 13)

    # True D2: this process parses ONLY its byte-range shard of the shared
    # FASTQ (O(file/n) per host) and feeds it process-locally into the mesh.
    fq = os.environ["TPU_EULER_MP_FASTQ"]
    my_reads = [s for _, s in read_shard(fq, pid, n_procs)]
    assert 0 < len(my_reads) < len(reads), "shard should be a proper subset"

    # Spy on fragment emission: per-process D2H must stay O(E/n_procs) —
    # the old path allgathered the FULL edge arrays to every host.
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
    result = assemble_reads_distributed(
        my_reads, cfg, shard_traversal=True, local_input=True
    )
    assert result.n_reads == len(reads), "allgathered read count != global"
    # valid(1) + is_start(1) + chain(4) + pos(4) + limbs(4L) bytes per row
    bytes_global = captured["rows_global"] * (10 + 4 * captured["nlimbs"])
    assert captured["d2h"] <= bytes_global // n_procs + 4096, (
        f"proc {pid} fetched {captured['d2h']} B from device; "
        f"O(E/n) bound is {bytes_global // n_procs} B"
    )
    got = canonical_contig_set(result.contig_strings)
    expected = assemble_oracle(reads, 21)
    assert got == expected, f"proc {pid}: contig mismatch"
    print(
        f"proc {pid}: OK ({len(got)} contigs over {len(jax.devices())} devices "
        f"from a {len(my_reads)}/{len(reads)}-read file shard)"
    )
    return 0


def main() -> int:
    if "TPU_EULER_MP_WORKER" in os.environ:
        return worker(
            int(os.environ["TPU_EULER_MP_NPROCS"]),
            int(os.environ["TPU_EULER_MP_WORKER"]),
            int(os.environ["TPU_EULER_MP_PORT"]),
        )
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # parent writes the shared FASTQ once; workers each parse only their
    # byte-range shard of it
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tpu_euler.reference_impl.simulate import random_genome, simulate_reads

    genome = random_genome(1500, seed=901)
    reads = simulate_reads(genome, read_len=80, coverage=15, seed=902, circular=True)
    fq = os.path.join(tempfile.mkdtemp(prefix="tpu_euler_mp_"), "reads.fq")
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["TPU_EULER_MP_NPROCS"] = str(n)
    env["TPU_EULER_MP_PORT"] = str(port)
    env["TPU_EULER_MP_FASTQ"] = fq
    procs = []
    for pid in range(n):
        e = dict(env, TPU_EULER_MP_WORKER=str(pid))
        procs.append(
            subprocess.Popen([sys.executable, os.path.abspath(__file__)], env=e)
        )
    rc = 0
    for p in procs:
        rc |= p.wait(timeout=600)
    print("multiprocess test:", "PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    sys.exit(main())
