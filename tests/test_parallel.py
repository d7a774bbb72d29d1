"""Multi-device tests on the 8-virtual-CPU mesh (SURVEY.md section 4
"Multi-node without a cluster"): explicit shard_map collectives and the
GSPMD-annotated pipeline must match the single-device results."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radar_tpu.config.params import small_test_config
from radar_tpu.ops.dbf import dbf
from radar_tpu.ops.mtd import mtd
from radar_tpu.parallel.collectives import (covariance_snapshot_sharded,
                                            dbf_channel_sharded,
                                            mtd_cpi_sharded,
                                            pulse_compress_range_sharded)
from radar_tpu.parallel.mesh import make_mesh
from radar_tpu.parallel.sharded import make_sharded_frame_processor
from radar_tpu.pipeline.frame import make_frame_processor
from radar_tpu.sim.scenario import TargetBatch
from radar_tpu.waveform.precompute import precompute


def _rand_c(rng, shape):
    return jnp.asarray(rng.normal(size=shape) + 1j * rng.normal(size=shape))


def test_dbf_channel_sharded_psum():
    mesh = make_mesh(ch=4)
    rng = np.random.default_rng(0)
    iq = _rand_c(rng, (3, 64, 16))
    w = _rand_c(rng, (13, 16))
    got = np.asarray(dbf_channel_sharded(mesh, "ch")(iq, w))
    want = np.asarray(dbf(iq, w, "v8"))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_overlap_save_halo_exchange():
    """Range-sharded causal convolution with ppermute halos == unsharded."""
    mesh = make_mesh(cpi=4)
    rng = np.random.default_rng(1)
    x = _rand_c(rng, (5, 256))
    h = rng.normal(size=33)
    f = pulse_compress_range_sharded(mesh, h, nfft=128, axis="cpi")
    got = np.asarray(f(x))
    # causal linear convolution truncated to len(x)
    want = np.stack([np.convolve(np.asarray(x)[i], h)[:256]
                     for i in range(5)])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_overlap_save_halo_ppermute_shards(n_shards):
    """The ppermute halo ring at every shard count the CPU mesh offers:
    complex taps (the transmit pulse's head) against np.convolve."""
    pre = precompute(small_test_config())
    h = np.asarray(pre.tx_pulse, np.complex64)[:33]
    s = 64 * n_shards
    rng = np.random.default_rng(n_shards)
    x = _rand_c(rng, (3, s)).astype(jnp.complex64)
    f = pulse_compress_range_sharded(make_mesh(cpi=n_shards), h, nfft=256,
                                     axis="cpi")
    got = np.asarray(f(x))
    want = np.stack([np.convolve(np.asarray(x)[i], h)[:s] for i in range(3)])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_mtd_cpi_sharded_all_to_all():
    mesh = make_mesh(cpi=4)
    cfg = small_test_config(pulses=32)
    pre = precompute(cfg)
    rng = np.random.default_rng(2)
    pc = _rand_c(rng, (32, 64, 3))
    got = np.asarray(mtd_cpi_sharded(mesh, jnp.asarray(pre.mtd_win))(pc))
    want = np.asarray(mtd(pc, jnp.asarray(pre.mtd_win)))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_covariance_snapshot_sharded():
    mesh = make_mesh(cpi=8)
    rng = np.random.default_rng(3)
    x = _rand_c(rng, (16, 256))
    got = np.asarray(covariance_snapshot_sharded(mesh)(x))
    want = np.asarray(x) @ np.asarray(x).conj().T / 256
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dp,ch,cpi", [(1, 2, 4), (2, 2, 2), (1, 1, 8)])
def test_sharded_pipeline_matches_single_device(dp, ch, cpi):
    cfg = small_test_config(channels=8, pulses=32)
    pre = precompute(cfg)
    mesh = make_mesh(dp=dp, ch=ch, cpi=cpi)
    tb = TargetBatch.make([3000.0, 9000.0], [10.0, 20.0], [10.0, 5.0],
                          [18.0, 15.0])
    key = jax.random.PRNGKey(0)
    single = make_frame_processor(cfg, pre, dtype=jnp.complex64)(key, tb)
    sharded = make_sharded_frame_processor(cfg, mesh, pre,
                                           dtype=jnp.complex64)(key, tb)
    assert int(single.num_raw_detections) == int(sharded.num_raw_detections)
    assert int(single.num_final) == int(sharded.num_final)
    sv = np.asarray(single.targets.valid)
    hv = np.asarray(sharded.targets.valid)
    np.testing.assert_array_equal(sv, hv)
    np.testing.assert_allclose(np.asarray(single.targets.range_m)[sv],
                               np.asarray(sharded.targets.range_m)[hv],
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(single.targets.angle_deg)[sv],
                               np.asarray(sharded.targets.angle_deg)[hv],
                               rtol=1e-3, atol=1e-3)


def test_sharded_monopulse_refined_matches_single_device():
    """The refined-index monopulse's extra 2D beam-stencil gathers and
    separable-spline evaluation shard like the rest of the tail: the
    (dp=2, ch=2, cpi=2)-sharded run matches the single-device run with
    cfg.monopulse_refined=True."""
    cfg = small_test_config(channels=8, pulses=32).replace(
        monopulse_refined=True)
    pre = precompute(cfg)
    mesh = make_mesh(dp=2, ch=2, cpi=2)
    tb = TargetBatch.make([3000.0, 9000.0], [10.0, 20.0], [10.0, 5.0],
                          [18.0, 15.0])
    key = jax.random.PRNGKey(0)
    single = make_frame_processor(cfg, pre, dtype=jnp.complex64)(key, tb)
    sharded = make_sharded_frame_processor(cfg, mesh, pre,
                                           dtype=jnp.complex64)(key, tb)
    assert int(single.num_final) == int(sharded.num_final)
    sv = np.asarray(single.targets.valid)
    np.testing.assert_array_equal(sv, np.asarray(sharded.targets.valid))
    np.testing.assert_allclose(np.asarray(single.targets.angle_deg)[sv],
                               np.asarray(sharded.targets.angle_deg)[sv],
                               rtol=1e-3, atol=1e-3)


def test_multihost_helpers_single_process():
    from radar_tpu.parallel import multihost

    # no coordinator configured -> single-process no-op
    assert multihost.initialize() is False
    mesh = multihost.make_multihost_mesh(ch=2)  # dp inferred = 4 on 8 devs
    assert mesh.shape["dp"] == 4 and mesh.shape["ch"] == 2
    # one process owns the whole dp batch
    assert multihost.local_batch_slice(8, mesh) == slice(0, 8)


@pytest.mark.parametrize("dp,ch,cpi", [(1, 1, 8), (2, 1, 4)])
def test_sharded_lowrank_matches_single_device(dp, ch, cpi):
    """The lowrank perf path sharded over the mesh (no channel cube; pulse-
    sharded noise, all_to_all into MTD) matches the single-device lowrank
    pipeline exactly (same draws)."""
    cfg = small_test_config(channels=8, pulses=32).replace(
        fused_synth_dbf=True, lowrank_rdm=True)
    pre = precompute(cfg)
    mesh = make_mesh(dp=dp, ch=ch, cpi=cpi)
    tb = TargetBatch.make([3000.0, 9000.0], [10.0, 20.0], [10.0, 5.0],
                          [18.0, 15.0])
    key = jax.random.PRNGKey(0)
    single = make_frame_processor(cfg, pre, dtype=jnp.complex64)(key, tb)
    sharded = make_sharded_frame_processor(cfg, mesh, pre,
                                           dtype=jnp.complex64)(key, tb)
    assert int(single.num_raw_detections) == int(sharded.num_raw_detections)
    assert int(single.num_final) == int(sharded.num_final)
    sv = np.asarray(single.targets.valid)
    np.testing.assert_array_equal(sv, np.asarray(sharded.targets.valid))
    np.testing.assert_allclose(np.asarray(single.targets.range_m)[sv],
                               np.asarray(sharded.targets.range_m)[sv],
                               rtol=1e-4)
