"""Regenerate golden contig sets (SURVEY.md section 4: golden files change only
via this explicit script, never implicitly in tests).

Writes tests/golden/golden.json: sha256 of the sorted canonical contig set for
fixed (genome seed, read seed, k, min_count) configurations, computed with the
CPU oracle (the ground truth — independent of the device pipeline under test).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_euler.reference_impl.oracle import assemble_oracle  # noqa: E402
from tpu_euler.reference_impl.simulate import (  # noqa: E402
    PHIX174,
    random_genome,
    simulate_reads,
)

CASES = {
    "phix_k21": dict(genome=PHIX174, cov=30, seed=42, k=21, min_count=1, err=0.0),
    "bac10k_k31": dict(
        genome=random_genome(10_000, seed=77), cov=25, seed=43, k=31, min_count=1,
        err=0.0,
    ),
    "errored_k21_mc4": dict(
        genome=random_genome(6_000, seed=78), cov=40, seed=44, k=21, min_count=4,
        err=0.005,
    ),
    "k41_3limb": dict(
        genome=random_genome(5_000, seed=79), cov=25, seed=45, k=41, min_count=1,
        err=0.0,
    ),
}


def contig_digest(contigs) -> str:
    h = hashlib.sha256()
    for c in sorted(contigs):
        h.update(c.encode() if isinstance(c, str) else c)
        h.update(b"\n")
    return h.hexdigest()


def reads_for(case):
    return simulate_reads(
        case["genome"],
        read_len=100,
        coverage=case["cov"],
        seed=case["seed"],
        error_rate=case["err"],
        circular=True,
    )


def main() -> int:
    golden = {}
    for name, case in CASES.items():
        contigs = assemble_oracle(reads_for(case), case["k"], case["min_count"])
        golden[name] = {
            "digest": contig_digest(contigs),
            "n_contigs": len(contigs),
            "total_bp": sum(len(c) for c in contigs),
        }
        print(name, golden[name])
    out = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests",
        "golden",
        "golden.json",
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(golden, f, indent=2, sort_keys=True)
    print("wrote", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
