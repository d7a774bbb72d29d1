"""Streaming Monte-Carlo (BASELINE config 5) and profiling utilities."""

import pytest

import jax.numpy as jnp
import numpy as np

from radar_tpu.config.params import small_test_config
from radar_tpu.parallel.mesh import make_mesh
from radar_tpu.pipeline.streaming import random_scene, run_streaming_mc
from radar_tpu.waveform.precompute import precompute


def test_random_scene_in_valid_region():
    cfg = small_test_config(channels=8, pulses=32)
    rng = np.random.default_rng(0)
    tb = random_scene(rng, 50, cfg)
    sig = cfg.sig
    delta_r = sig.c / (2 * sig.fs)
    assert np.all(tb.range_m > 15 * delta_r)
    assert np.all(tb.range_m < sig.n_total_gate * delta_r)
    # velocities inside the valid (border-excluded) Doppler region
    bins = sig.prt_num / 2 + sig.prt_num * tb.velocity_ms / sig.v_max
    border = cfg.cfar.ref_cells_v + cfg.cfar.guard_cells_v
    assert np.all(bins >= border) and np.all(bins < sig.prt_num - border)


def test_streaming_mc_single_device():
    cfg = small_test_config(channels=8, pulses=32)
    pre = precompute(cfg)
    stats = run_streaming_mc(cfg, num_scenes=3, targets_per_scene=4,
                             trials_per_scene=2, seed=0, precomp=pre,
                             snr_range=(12.0, 20.0))
    assert stats.total_targets == 3 * 4 * 2
    # high-SNR targets: nearly all detected
    assert stats.detection_rate > 0.7, stats
    assert stats.range_rmse_m < 20.0
    assert stats.velocity_rmse_ms < 3.0


@pytest.mark.slow
def test_streaming_mc_sharded_matches_single():
    cfg = small_test_config(channels=8, pulses=32)
    pre = precompute(cfg)
    kw = dict(num_scenes=2, targets_per_scene=3, trials_per_scene=2, seed=1,
              precomp=pre, snr_range=(12.0, 20.0))
    single = run_streaming_mc(cfg, **kw)
    mesh = make_mesh(dp=2, ch=2, cpi=2)
    sharded = run_streaming_mc(cfg, mesh=mesh, **kw)
    assert single.total_targets == sharded.total_targets
    assert single.total_detected == sharded.total_detected
    np.testing.assert_allclose(single.range_rmse_m, sharded.range_rmse_m,
                               rtol=1e-3)


def test_streaming_dp_trials_matches_single():
    """dp-sharded trial batches (the parfor boundary on the mesh) produce
    the same detection statistics as the single-device run at identical
    seeds — shard_map only moves WHERE each trial computes."""
    cfg = small_test_config(channels=8, pulses=32)
    pre = precompute(cfg)
    kw = dict(num_scenes=2, targets_per_scene=3, trials_per_scene=4, seed=1,
              precomp=pre, snr_range=(12.0, 20.0))
    single = run_streaming_mc(cfg, **kw)
    dp = run_streaming_mc(cfg, mesh=make_mesh(dp=4), dp_trials=True, **kw)
    assert single.total_targets == dp.total_targets
    assert single.total_detected == dp.total_detected
    # the single path vmaps trials, the dp path lax.maps them: fp
    # reassociation can flip the truth-matching argmin between two
    # detections inside the same gate, discretely swapping which dv a
    # target records — counts stay exact, RMSE moves a few percent
    np.testing.assert_allclose(dp.range_rmse_m, single.range_rmse_m,
                               rtol=0.05)
    np.testing.assert_allclose(dp.velocity_rmse_ms, single.velocity_rmse_ms,
                               rtol=0.05)


@pytest.mark.slow
def test_streaming_orbax_elastic_resume(tmp_path):
    """ELASTIC recovery end-to-end (VERDICT r3 #3): a dp=4 streaming run
    checkpoints each scene's SHARDED trial results shard-local, is
    "killed" after 2 of 4 scenes, and resumes onto a DIFFERENT mesh shape
    (dp=2) — replayed scenes restore with explicit dp=2 shardings via
    ``like=``, new scenes compute on the new mesh, and the final
    statistics are field-exact vs an uninterrupted dp run (each trial's
    frame is an independent program — bit-identical wherever it runs)."""
    from radar_tpu.io.orbax_store import OrbaxFrameStore

    cfg = small_test_config(channels=8, pulses=32)
    pre = precompute(cfg)
    kw = dict(targets_per_scene=3, trials_per_scene=4, seed=5,
              precomp=pre, snr_range=(12.0, 20.0))

    # ground truth: uninterrupted dp=4 run over all 4 scenes
    full = run_streaming_mc(cfg, num_scenes=4, mesh=make_mesh(dp=4),
                            dp_trials=True, **kw)

    # "crashed" run: dp=4, dies after scene 2
    store = OrbaxFrameStore(str(tmp_path / "ck"))
    run_streaming_mc(cfg, num_scenes=2, mesh=make_mesh(dp=4),
                     dp_trials=True, store=store, **kw)
    assert store.frames_done() == [1, 2]

    # resumed run on the SMALLER mesh (dp=4 -> dp=2): scenes 1-2 restore
    # from disk onto dp=2 shardings, scenes 3-4 compute on dp=2
    store2 = OrbaxFrameStore(str(tmp_path / "ck"))
    res = run_streaming_mc(cfg, num_scenes=4, mesh=make_mesh(dp=2),
                           dp_trials=True, store=store2, **kw)
    assert store2.frames_done() == [1, 2, 3, 4]

    # a mismatched-seed resume against the same store must be REFUSED
    # (scenes would replay against different truths)
    with pytest.raises(ValueError, match="different run"):
        run_streaming_mc(cfg, num_scenes=4, mesh=make_mesh(dp=2),
                         dp_trials=True, store=OrbaxFrameStore(
                             str(tmp_path / "ck")),
                         **{**kw, "seed": 6})

    assert res.total_targets == full.total_targets
    assert res.total_detected == full.total_detected
    np.testing.assert_array_equal(res.range_rmse_m, full.range_rmse_m)
    np.testing.assert_array_equal(res.velocity_rmse_ms,
                                  full.velocity_rmse_ms)
    np.testing.assert_array_equal(res.snr_bin_counts, full.snr_bin_counts)
    np.testing.assert_array_equal(res.snr_bin_rate, full.snr_bin_rate)


def test_stage_timer_and_metrics_log(tmp_path):
    import time

    from radar_tpu.utils.profiling import (FrameMetrics, MetricsLog,
                                           StageTimer)

    t = StageTimer()
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("a"):
        time.sleep(0.01)
    rep = t.report()
    assert rep["a"]["calls"] == 2
    assert rep["a"]["mean_ms"] >= 9.0
    assert t.samples_per_second("a", 1000) > 0

    log = MetricsLog()
    for i in range(3):
        log.record(FrameMetrics(i, 10.0 * i, 5, 2, 1.5))
    p = tmp_path / "metrics.jsonl"
    log.save(str(p))
    assert len(p.read_text().splitlines()) == 3
    s = log.summary()
    assert s["frames"] == 3 and s["total_final_targets"] == 6
