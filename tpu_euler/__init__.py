"""tpu-euler: an Eulerian-path / de Bruijn graph de novo genome assembler in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
``zenlc2000/pycuda-euler`` (PyCUDA Eulerian assembler, EULER / GPU-Euler lineage;
see SURVEY.md — the reference mount was empty, so parity targets come from
SURVEY.md sections 1-2 and BASELINE.json rather than file:line citations).

Layer map (SURVEY.md section 1b):
  io/        FASTA/FASTQ parsing, 2-bit base encoding            (ref R1, R2)
  kmer/      multi-limb k-mer keys, extraction, sort-based count (ref R3-R5)
  graph/     de Bruijn CSR construction                          (ref R6)
  euler/     successor assignment, circuit labeling/merge,
             list-ranking, contig extraction                     (ref R7-R10)
  dist/      mesh + shard_map collectives (all_to_all spectrum
             exchange, prefix partitioning)                      (new, SPEC D1-D6)
  pipeline/  end-to-end assemble()                               (ref R12)
  verify/    canonicalized contig-set comparison                 (SPEC correctness bar)
  reference_impl/  pure-CPU oracle assembler (ground truth)
"""

__version__ = "0.1.0"

from tpu_euler.config import AssemblyConfig  # noqa: F401
