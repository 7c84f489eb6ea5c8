"""Test configuration: run on the CPU with 8 virtual devices.

SURVEY.md §4: jax runs the same code on CPU — this is the "fake backend"
the reference never had.  Multi-device sharding logic is tested on a
virtual 8-device CPU mesh via --xla_force_host_platform_device_count.
The GPU is checked by chip_smoke.py, run on the card.
"""

import os
import re
import sys

# chip_smoke.py and bench.py live at the root of the checkout
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# The suite assumes an 8-device virtual mesh: REPLACE any pre-existing
# count (a substring check would silently keep e.g. =4 from an
# unrelated job and run the sharding tests on the wrong mesh size)
_flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                os.environ.get("XLA_FLAGS", "")).strip()
os.environ["XLA_FLAGS"] = (
    _flags + " --xla_force_host_platform_device_count=8").strip()

