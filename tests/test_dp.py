"""Data-parallel perf-path execution (parallel/dp.py) on the 8-virtual-CPU
mesh: shard_map over the dp axis must reproduce the single-device perf
pipeline bit-for-bit (the reference's parfor trial boundary,
main_plot_snr_vs_angle_error.m:167)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radar_tpu.config.params import perf_config, small_test_config
from radar_tpu.parallel.dp import (make_dp_frame_processor,
                                   make_dp_sharded_frame_processor,
                                   make_dp_trial_fn)
from radar_tpu.parallel.mesh import make_mesh
from radar_tpu.pipeline.frame import make_frame_processor
from radar_tpu.pipeline.montecarlo import _first_valid_angle
from radar_tpu.sim.scenario import TargetBatch
from radar_tpu.waveform.precompute import precompute


def _batched_targets(n):
    """n distinct single-target scenes stacked on a leading batch axis."""
    r = 3000.0 + 500.0 * np.arange(n)
    return TargetBatch(
        range_m=jnp.asarray(r[:, None], jnp.float32),
        velocity_ms=jnp.asarray(np.full((n, 1), 12.0), jnp.float32),
        elevation_deg=jnp.asarray(np.full((n, 1), 9.0), jnp.float32),
        snr_db=jnp.asarray(np.full((n, 1), 20.0), jnp.float32),
    )


def _keys(n, seed=0):
    return np.asarray(jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(seed), jnp.arange(n)))


def test_dp_frame_batch_matches_single_device():
    """Each dp shard's frames == the single-device perf pipeline."""
    cfg = perf_config(small_test_config())
    pre = precompute(cfg)
    n, dp = 8, 4
    mesh = make_mesh(dp=dp, ch=2)   # extra non-dp axis must be inert
    proc_dp = make_dp_frame_processor(cfg, mesh, pre)
    keys = _keys(n)
    tb = _batched_targets(n)
    out = jax.block_until_ready(proc_dp(jnp.asarray(keys), tb))

    proc_1 = make_frame_processor(cfg, pre)
    for i in range(n):
        ref = proc_1(keys[i], jax.tree.map(lambda x: x[i], tb))
        assert int(out.num_raw_detections[i]) == int(ref.num_raw_detections)
        assert int(out.num_final[i]) == int(ref.num_final)
        np.testing.assert_array_equal(np.asarray(out.targets.valid[i]),
                                      np.asarray(ref.targets.valid))
        for field in ("range_m", "velocity_ms", "angle_deg", "power"):
            np.testing.assert_array_equal(
                np.asarray(getattr(out.targets, field)[i]),
                np.asarray(getattr(ref.targets, field)))


@pytest.mark.parametrize("lowrank", [False, True])
def test_dp_model_parallel_composition(lowrank):
    """dp x model-parallel: batch sharded over dp=2, EACH frame GSPMD-
    sharded over (ch=2, cpi=2) — for both the stream path and the XLA lowrank perf
    chain. The parity reference is the VMAPPED single-device pipeline
    (identical program minus the sharding annotations): sharding may only
    change WHERE values are computed, so counts must match exactly and
    fields to fp-reassociation level. (vmap itself re-batches the lowrank
    chain's dots, which flips a couple of near-threshold CFAR cells vs
    the per-frame run — measured 46-48 raw on the trivial dp=1 mesh too,
    an orthogonal, pre-existing property of every vmapped trial path.)"""
    cfg = small_test_config(channels=8, pulses=32)
    if lowrank:
        # f32 matmuls: the CPU DotThunk has no batched bf16 dot (the vmap
        # adds the batch dim); bf16 is a per-dot precision knob orthogonal
        # to the sharding composition under test here
        cfg = perf_config(cfg).replace(
            matmul_precision="f32")
    pre = precompute(cfg)
    mesh = make_mesh(dp=2, ch=2, cpi=2)
    proc = make_dp_sharded_frame_processor(cfg, mesh, pre)
    n = 4
    keys = _keys(n, seed=7)
    tb = _batched_targets(n)
    out = jax.block_until_ready(proc(jnp.asarray(keys), tb))

    vref = jax.jit(jax.vmap(make_frame_processor(cfg, pre, jit=False)))
    ref = jax.block_until_ready(vref(jnp.asarray(keys), tb))
    np.testing.assert_array_equal(np.asarray(out.num_raw_detections),
                                  np.asarray(ref.num_raw_detections))
    np.testing.assert_array_equal(np.asarray(out.num_final),
                                  np.asarray(ref.num_final))
    np.testing.assert_array_equal(np.asarray(out.targets.valid),
                                  np.asarray(ref.targets.valid))
    gv = np.asarray(ref.targets.valid, bool)
    for field in ("range_m", "velocity_ms", "angle_deg", "power"):
        np.testing.assert_allclose(
            np.asarray(getattr(out.targets, field))[gv],
            np.asarray(getattr(ref.targets, field))[gv],
            rtol=1e-5, atol=1e-5)
    assert int(out.num_final.sum()) == n  # every scene's target detected
    with pytest.raises(ValueError, match="not divisible"):
        proc(jnp.asarray(_keys(3)), _batched_targets(3))


def test_dp_frame_batch_rejects_indivisible():
    cfg = perf_config(small_test_config())
    mesh = make_mesh(dp=4)
    proc = make_dp_frame_processor(cfg, mesh, precompute(cfg))
    with pytest.raises(ValueError, match="not divisible"):
        proc(jnp.asarray(_keys(6)), _batched_targets(6))


@pytest.mark.slow
def test_dp_trials_match_single_device():
    """dp-sharded Monte-Carlo trials on the perf path == mapping the
    single-device processor over the same keys."""
    cfg = perf_config(small_test_config())
    pre = precompute(cfg)
    mesh = make_mesh(dp=4)
    trials = make_dp_trial_fn(cfg, mesh, pre)
    tb = TargetBatch.make([3000.0], [10.0], [9.0], [20.0])
    keys = _keys(4, seed=3)
    angles, hits = jax.block_until_ready(
        trials(tb, jnp.asarray(keys)))

    proc_1 = make_frame_processor(cfg, pre)
    tb_j = jax.tree.map(jnp.asarray, tb)
    for i in range(4):
        a_ref, h_ref = _first_valid_angle(proc_1(keys[i], tb_j))
        assert bool(hits[i]) == bool(h_ref)
        if bool(h_ref):
            np.testing.assert_array_equal(np.asarray(angles[i]),
                                          np.asarray(a_ref))
        else:
            assert np.isnan(float(angles[i]))


@pytest.mark.slow
def test_snr_sweep_dp_mesh_matches_pd_ladder():
    """snr_sweep(mesh=...) shards each trial batch over the dp axis and
    reproduces the single-device Pd ladder (the reference's parfor sweep,
    main_plot_snr_vs_angle_error.m:167, on the device mesh)."""
    from radar_tpu.pipeline.montecarlo import snr_sweep

    cfg = perf_config(small_test_config(channels=8, pulses=32))
    tb = TargetBatch.make([3000.0], [10.0], [10.0], [0.0])
    kw = dict(snr_db_vector=[-42.0, 25.0], num_trials=8, truth=tb,
              seed=11, batch_size=4)
    res_dp = snr_sweep(cfg, mesh=make_mesh(dp=4), **kw)
    res_1 = snr_sweep(cfg, **kw)
    for res in (res_dp, res_1):
        assert res.detection_probability[0] <= 0.3
        assert res.detection_probability[-1] >= 0.9
    # bad divisibility is rejected loudly
    with pytest.raises(ValueError, match="multiples of the dp"):
        snr_sweep(cfg, mesh=make_mesh(dp=4), snr_db_vector=[25.0],
                  num_trials=6, truth=tb, batch_size=3)
