"""Device mesh construction (SPEC D1).

The reference is single-GPU/single-process (SURVEY.md section 2a); all distributed
components are new, SPEC-mandated. On several hosts the caller runs
``jax.distributed.initialize()`` first (one process per host); on a single host
(or the 8-virtual-device CPU test mesh) this just wraps local devices.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "d"  # the single data/ownership mesh axis used by the assembler


def maybe_initialize_distributed(coordinator: str | None = None, **kw) -> None:
    """Multi-host init (jax.distributed); no-op when single-process."""
    if coordinator:
        jax.distributed.initialize(coordinator_address=coordinator, **kw)


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the first n_devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return jax.make_mesh((len(devs),), (AXIS,), devices=devs)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(AXIS))


def fetch_global(x):
    """Bring a (possibly cross-process sharded) array fully to this host.

    Single-process: plain device_get. Multi-process (true multi-host runs):
    process_allgather over the non-addressable shards.
    """
    import numpy as np

    import jax

    try:
        return np.asarray(jax.device_get(x))
    except RuntimeError:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
