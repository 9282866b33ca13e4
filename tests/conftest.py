"""Test configuration: run JAX on a virtual 8-device CPU mesh, so sharding
tests exercise real multi-device layouts on any host. Nothing here needs an
accelerator; ``python chip_smoke.py`` checks the device path on a GPU."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

REFERENCE_TEST_DATA = "/root/reference/test_data"
