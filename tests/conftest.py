"""Test configuration: force the CPU backend with 8 virtual devices
(multi-host sharding is tested on a CPU mesh per SURVEY.md section 4
"Multi-node without a cluster") and enable x64 so parity tests can run in
float64/complex128 against the numpy oracle.

Tests marked ``gpu`` need the card: run them on a GPU host with
``RADAR_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu``, which leaves the
platform to JAX. Each such test decides in its ``gpu_device`` fixture
(tests/test_gpu.py) whether a card is present, and skips if not.
"""

import os

if os.environ.get("RADAR_TESTS_ON_GPU") != "1":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
