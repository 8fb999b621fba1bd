"""Test harness: force an 8-virtual-device CPU platform.

Sharding tests run on a virtual 8-device CPU mesh, like
``__graft_entry__.dryrun_multichip``. Code that runs only on a GPU is
checked by ``chip_smoke.py``, not by these tests.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_backend_optimization_level" not in flags:
    # XLA CPU fuses whole merge chains into single ~1450-op kernels on the
    # scene-object path and LLVM -O3 takes >25 min PER KERNEL; -O1 compiles
    # the same module in under a minute (runtime cost is irrelevant at test
    # shapes). See ops/objects.py::_planes_to_hb NOTE.
    flags = (flags + " --xla_backend_optimization_level=1").strip()
os.environ["XLA_FLAGS"] = flags
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
