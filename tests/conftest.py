"""Test configuration: force a deterministic 8-device CPU mesh for JAX.

The tier-1 suite runs on the CPU (``JAX_PLATFORMS=cpu``); the platform is
also pinned through jax.config before any backend is initialized, so the
suite never touches a GPU even where one is visible.  Multi-device
sharding is validated on this virtual 8-device CPU mesh.  The device path
on a real GPU is checked by ``chip_smoke.py`` (one card) and
``chip_smoke.py --multi`` (four cards), not by this suite.
"""

import os

# Debug-build invariant checks (the analog of the reference's
# debug_assert!, off in production) always run under the test suite.
os.environ.setdefault("MATCHTIGS_DEBUG_CHECKS", "1")

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")
