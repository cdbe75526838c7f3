"""Test configuration: run all tests on CPU JAX with 8 virtual devices.

SURVEY.md section 4: distributed logic is mesh-size-parameterized and validated on a
virtual 8-device CPU mesh (xla_force_host_platform_device_count); the same code
paths run on several GPUs.

The platform is forced through jax.config *after* import, so the suite stays on
the CPU even where a GPU is present (backends initialize lazily, so this and the
XLA_FLAGS append are still in time).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
