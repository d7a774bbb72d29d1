"""Tests that need the card. They skip without one; on a GPU host run them
with ``RADAR_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu`` (see
tests/conftest.py)."""

import os
import sys

import jax
import numpy as np
import pytest

from radar_tpu.config.params import perf_config, small_test_config

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


def test_f32_matmul_is_not_tf32_on_the_card(gpu_device):
    """A float32 contraction at Precision.HIGHEST keeps float32 accuracy;
    the pipeline's float32 sites all ask for it."""
    from radar_tpu.ops.mtd import make_mtd_matrix, mtd_matmul

    rng = np.random.default_rng(0)
    pc = (rng.normal(size=(332, 256, 4))
          + 1j * rng.normal(size=(332, 256, 4))).astype(np.complex64)
    m = make_mtd_matrix(np.hanning(332), 332)
    want = np.einsum("vp,pgb->vgb", m, pc.astype(np.complex128))
    got = np.asarray(mtd_matmul(jax.device_put(pc, gpu_device), m, "f32"))
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5


def test_exact_path_matches_oracle_on_the_card(gpu_device):
    import chip_smoke

    out = chip_smoke.phase_parity_exact(
        small_test_config(), truth=([3000.0], [20.0], [10.0], [15.0]))
    assert out["rdm_err"] <= chip_smoke.EXACT_RDM_TOL


def test_perf_frame_finds_targets_on_the_card(gpu_device):
    import chip_smoke

    chip_smoke.phase_flagship(perf_config(), n_frames=3)
