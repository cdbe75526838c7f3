"""Assembly configuration.

Reference counterpart: the argparse flags of the pycuda-euler driver (SURVEY.md
section 2a R12 — reconstruction; the mount at /root/reference was empty). Here the
config is a frozen dataclass so it can be closed over by jit'd stages: every field
that shapes a traced array (k, capacities, batch sizes) is static by construction.
"""

from __future__ import annotations

import dataclasses
import math


def _ceil_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class AssemblyConfig:
    """Static configuration for one assembly run.

    Attributes:
      k: k-mer length (edge length). Must be odd so that no k-mer equals its own
         reverse complement (standard canonical-k-mer trick).
      min_count: k-mer frequency cutoff; k-mers with canonical multiplicity below
         this are treated as sequencing errors and dropped (SPEC config 3).
      read_batch: number of reads per device batch (static shape for jit).
      read_len: padded read length (bases); shorter reads are padded with N.
      spectrum_capacity: max number of distinct canonical k-mers held in the
         accumulated spectrum (static). Overflow is detected and raised on host.
      kmer_batch_capacity: max distinct canonical k-mers produced by a single
         read batch.
      bucket_bits: log2 of the number of ownership buckets used for the
         distributed all-to-all spectrum exchange (SPEC D3/D4). Ownership is by
         prefix of the *scrambled* key (hash-bucketed for balance, contiguous in
         scrambled key space for prefix partitioning).
      mesh_shape: device mesh shape for distributed runs; () means single device.
    """

    k: int = 31
    min_count: int = 1
    read_batch: int = 4096
    read_len: int = 100
    spectrum_capacity: int = 1 << 20
    kmer_batch_capacity: int = 0  # 0 -> derived from read_batch * windows
    bucket_bits: int = 6
    mesh_shape: tuple = ()
    scramble: bool = True  # hash-scramble keys before prefix bucketing
    tip_rounds: int = 0  # iterative tip-clipping rounds (0 = off)
    tip_len: int = 0  # tip threshold in edges (0 = 2k)
    bubble_rounds: int = 0  # iterative simple-bubble popping rounds (0 = off)
    bubble_len: int = 0  # bubble branch threshold in edges (0 = 2k)
    # one-shot counting: if the whole run's windows fit this many rows, buffer
    # all canonical keys and sort ONCE instead of merging per batch (0 = off).
    oneshot_rows: int = 192_000_000
    # Node-array capacity as a fraction of edge capacity E. 2.0 = the exact
    # worst case 2E (every edge endpoint distinct — isolated k-mers). In a
    # connected assembly graph n_nodes ~~ E, so memory-bound runs (SPEC
    # config 5: 100 Mbp on one device) set ~1.15 to halve the four
    # per-node int32 arrays; the pipeline verifies n_nodes fits and raises
    # with guidance if not.
    node_cap_factor: float = 2.0

    def __post_init__(self):
        if self.k < 3 or self.k % 2 == 0:
            raise ValueError(f"k must be odd and >= 3, got {self.k}")
        if self.read_len < self.k:
            raise ValueError("read_len must be >= k")
        if self.kmer_batch_capacity == 0:
            # distinct keys in one batch are a subset of the global distinct
            # set, so the spectrum capacity is always a safe upper bound
            object.__setattr__(
                self,
                "kmer_batch_capacity",
                min(
                    _ceil_pow2(self.read_batch * self.windows_per_read),
                    self.spectrum_capacity,
                ),
            )

    @property
    def windows_per_read(self) -> int:
        return self.read_len - self.k + 1

    @property
    def nlimbs(self) -> int:
        """uint32 limbs per k-mer key: ceil(k/16) (2 bits per base)."""
        return math.ceil(self.k / 16)

    @property
    def edge_capacity(self) -> int:
        """Capacity of the doubled (both-strand) edge array: 2 per canonical k-mer."""
        return 2 * self.spectrum_capacity
