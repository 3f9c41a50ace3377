"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set env vars before jax initializes, so this conftest is imported first.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# Pin tests to the virtual CPU mesh even where an accelerator plug-in is
# installed (tests that need the card are marked `gpu` and skip here;
# chip_smoke.py runs the same checks on the card).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

# The full suite compiles hundreds of XLA:CPU executables whose live
# mappings push the process past the kernel's default vm.max_map_count
# (65530) around the ~130th test — mmap then fails inside XLA and the
# process segfaults.  Raise the limit when we can (container root) ...
try:
    with open("/proc/sys/vm/max_map_count", "r+") as f:
        if int(f.read()) < 262144:
            f.seek(0)
            f.write("262144")
except (OSError, PermissionError):
    pass


# ... and bound live executables regardless: drop each module's jit
# caches once its tests are done (recompiles hit the persistent on-disk
# cache, so cross-module reuse stays cheap).
@pytest.fixture(autouse=True, scope="module")
def _clear_jit_caches_per_module():
    yield
    jax.clear_caches()
