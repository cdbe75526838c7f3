"""Golden-file tests (SURVEY.md section 4): the device pipeline must reproduce the
checked-in contig-set digests exactly. Regenerate ONLY via
scripts/regen_golden.py."""

import json
import os

import pytest

from tpu_euler.config import AssemblyConfig
from tpu_euler.pipeline.assemble import assemble_reads
from tpu_euler.verify.compare import canonical_contig_set

import sys

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "scripts")
)
from regen_golden import CASES, contig_digest, reads_for  # noqa: E402

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)), "golden", "golden.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_contig_sets(golden, name):
    case = CASES[name]
    reads = reads_for(case)
    cfg = AssemblyConfig(
        k=case["k"],
        min_count=case["min_count"],
        read_batch=1024,
        read_len=100,
        spectrum_capacity=1 << 16,
    )
    result = assemble_reads(reads, cfg)
    digest = contig_digest(sorted(canonical_contig_set(result.contig_strings)))
    assert digest == golden[name]["digest"], (
        f"{name}: contig set drifted from golden "
        f"({len(result.contigs)} vs {golden[name]['n_contigs']} contigs)"
    )
