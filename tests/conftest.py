"""Test harness: force an 8-virtual-device CPU platform.

Sharding correctness is checked against a fake multi-device CPU mesh
(xla_force_host_platform_device_count), so no GPU is needed.  Platform
selection goes through jax.config before any backend is initialized
(backends init lazily on first use).

With PSGSDF_TEST_GPU=1 the tests run on the default accelerator instead;
the GPU goldens (`-m gpu`, tests/test_goldens.py) need this, and
everything that wants the 8-device CPU mesh then skips or runs on one
device.
"""

import os

if os.environ.get("PSGSDF_TEST_GPU", "") == "1":
    import jax
else:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)

    assert jax.default_backend() == "cpu", jax.default_backend()
    assert jax.device_count() >= 8, jax.devices()
