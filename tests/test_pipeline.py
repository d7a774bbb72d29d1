"""Multi-frame driver, kinematics, track association and Monte-Carlo
behavior (SURVEY.md sections 3.1/3.3, 4.3)."""

import pytest

import jax.numpy as jnp
import numpy as np

from radar_tpu.config.params import small_test_config
from radar_tpu.pipeline.driver import (DetectionLog, associate_tracks,
                                       run_multiframe,
                                       tracks_without_association)
from radar_tpu.pipeline.montecarlo import snr_sweep
from radar_tpu.sim.scenario import Scenario, TargetBatch
from radar_tpu.waveform.precompute import precompute


def test_kinematics_constant_altitude():
    cfg = small_test_config()
    tb = TargetBatch.make([3000.0], [20.0], [10.0], [10.0])
    scen = Scenario.from_initial(tb, cfg)
    h0 = scen.const_h.copy()
    states = [scen.step(cfg) for _ in range(30)]
    # altitude invariant: R*sin(El) == const_H at every step
    for st in states:
        np.testing.assert_allclose(
            st.range_m * np.sin(np.deg2rad(st.elevation_deg)), h0,
            rtol=1e-12)
    # inbound target: range decreases, elevation increases
    rs = np.array([s.range_m[0] for s in states])
    els = np.array([s.elevation_deg[0] for s in states])
    assert np.all(np.diff(rs) < 0)
    assert np.all(np.diff(els) > 0)
    # radial velocity = V_ground*cos(El) stays below ground speed
    vs = np.array([s.velocity_ms[0] for s in states])
    assert np.all(vs < scen.const_v_ground[0])
    # azimuth advances rpm*6*T_frame deg/frame
    expected = cfg.scan.deg_per_frame(cfg.sig)
    assert expected > 0


def test_multiframe_run_and_tracks():
    cfg = small_test_config(channels=8, pulses=32)
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [18.0])
    log, tracks, scen = run_multiframe(cfg, tb, num_frames=6, seed=0)
    assert len(log) >= 5  # detected in (almost) every frame
    assert len(tracks) >= 1
    main = max(tracks, key=lambda t: t.num_points)
    assert main.num_points >= 5
    assert main.last_frame - main.first_frame >= 4
    # winner range within gate of the truth trajectory (range decreases
    # from 3000 by ~15 m/s * ~7.4 ms/frame * 6 frames -> barely moves)
    assert abs(main.range_m - 3000.0) < 60.0
    assert abs(main.velocity_ms - 15.0) < 3.0


def test_track_association_splits_far_targets():
    log = DetectionLog(
        range_m=np.array([1000.0, 1010.0, 5000.0, 5005.0]),
        velocity_ms=np.array([10.0, 10.1, -5.0, -5.1]),
        elevation_deg=np.array([10.0, 10.2, 20.0, 20.1]),
        power=np.array([1.0, 2.0, 3.0, 4.0]),
        frame=np.array([1, 2, 1, 2]),
        azimuth_deg=np.array([0.0, 0.3, 0.0, 0.3]),
    )
    cfg = small_test_config()
    tracks = associate_tracks(log, cfg)
    assert len(tracks) == 2
    t = sorted(tracks, key=lambda t: t.range_m)
    # winner-take-all by power: ranges from the higher-power member
    np.testing.assert_allclose(t[0].range_m, 1010.0)
    np.testing.assert_allclose(t[1].range_m, 5005.0)
    # azimuth = power-weighted mean
    np.testing.assert_allclose(t[0].azimuth_deg, (0.0 * 1 + 0.3 * 2) / 3)
    assert t[0].num_points == 2 and t[1].num_points == 2
    # frame-gap gate: same target reappearing 5 frames later is a new track
    log.frame = np.array([1, 7, 1, 2])
    tracks2 = associate_tracks(log, cfg)
    assert len(tracks2) == 3
    # passthrough mode
    assert len(tracks_without_association(log)) == 4


def test_track_association_azimuth_wrap_variant():
    """The reference gates azimuth with plain |d| on mod-360 values and
    merges with a linear weighted mean (v8_3.m:288,323): a physical
    track crossing north splits and a straddling cluster lands near
    180 deg. Default preserves that; wrap_azimuth=True uses the
    circular metric + circular mean."""
    import dataclasses

    log = DetectionLog(
        range_m=np.array([2000.0, 2001.0]),
        velocity_ms=np.array([5.0, 5.0]),
        elevation_deg=np.array([10.0, 10.0]),
        power=np.array([1.0, 1.0]),
        frame=np.array([1, 2]),
        azimuth_deg=np.array([359.5, 0.5]),   # 1 deg apart across north
    )
    cfg = small_test_config()
    # reference behavior: |359.5 - 0.5| = 359 > gate -> two tracks
    assert len(associate_tracks(log, cfg)) == 2
    cfg_w = cfg.replace(inter_frame=dataclasses.replace(
        cfg.inter_frame, wrap_azimuth=True))
    tracks = associate_tracks(log, cfg_w)
    assert len(tracks) == 1
    # circular power-weighted mean of 359.5/0.5 is 0 (mod 360), not 180
    az = tracks[0].azimuth_deg
    assert min(az, 360.0 - az) < 1e-6
    # far-apart azimuths still split under the wrap metric
    log.azimuth_deg = np.array([90.0, 270.0])
    assert len(associate_tracks(log, cfg_w)) == 2


@pytest.mark.slow
def test_monte_carlo_sweep_small():
    cfg = small_test_config(channels=8, pulses=32)
    pre = precompute(cfg)
    truth = TargetBatch.make([3000.0], [10.0], [10.0], [0.0])
    # the chain's integration gain (~47 dB here: 200-sample matched filter +
    # 32-pulse MTD + 8-channel DBF) puts the Pd transition near -28 dB raw
    # SNR; sample below, at, and far above it
    res = snr_sweep(cfg, snr_db_vector=[-42.0, -28.0, 25.0], num_trials=12,
                    truth=truth, seed=1, batch_size=6, precomp=pre)
    # Pd monotone from ~0 to 1 across the SNR ladder
    assert res.detection_probability[0] <= 0.3
    assert res.detection_probability[-1] >= 0.9
    assert res.detection_probability[-1] >= res.detection_probability[0]
    # detected-trial angle errors shrink with SNR
    assert np.isnan(res.angle_error_std[0]) or (
        res.angle_error_std[0] >= res.angle_error_std[-1])
    # high-SNR angle error is small (within a degree for pair-center target)
    assert res.angle_error_std[-1] < 1.5
    # theory bound array matches |k|sqrt(2)/sqrt(snr)
    assert res.theory_bound.shape == (3,)
    assert np.all(np.diff(res.theory_bound) < 0)


@pytest.mark.slow
def test_monte_carlo_sweep_64ch_scaled():
    """BASELINE config 3 statistical sweep (64 ch x 256 pulses) — the CPU
    twin of the full-scale run in results/snr_sweep_64ch.json. Truth sits at an
    in-bank pair crossover (-0.8 deg, pair 9 of the synthesized Hamming
    bank, which spans -16..+3.2 deg — the harness-default 10 deg is
    OUTSIDE this bank and measures sidelobe estimates). Pd transitions
    between -47 and -44 dB raw SNR (the 16-ch transition at ~-40 dB
    shifted by +6 dB array gain - 1.1 dB fewer pulses); sigma shrinks
    with SNR and at high SNR sits far inside the sweep-bound class.
    Uses the synthesized Hamming bank + self-calibrated K slopes
    (config/assets.py).
    Ref: main_plot_snr_vs_angle_error.m:303-317 at the scaled array."""
    from radar_tpu.config.params import scaled_config

    cfg = scaled_config(channels=64, pulses=256).replace(
        fused_synth_dbf=True, lowrank_rdm=True)
    truth = TargetBatch.make([10000.0], [20.0], [-0.8], [0.0])
    res = snr_sweep(cfg, snr_db_vector=[-58.0, -44.0, 25.0], num_trials=8,
                    truth=truth, seed=5, batch_size=4)
    # Pd: ~0 far below the transition, 1 at and far above it, monotone
    assert res.detection_probability[0] <= 0.3
    assert res.detection_probability[1] >= 0.9
    assert res.detection_probability[-1] >= 0.9
    # sigma shrinks with SNR: measurable just above the transition,
    # near-floor at high SNR (probe run: 0.074 deg -> 8e-5 deg)
    assert res.angle_error_std[1] >= res.angle_error_std[-1]
    assert res.angle_error_std[-1] < 0.5
    # the analytic |k|*sqrt(2)/sqrt(SNR) bound is monotone decreasing
    assert np.all(np.diff(res.theory_bound) < 0)


def test_device_multiframe_matches_host_loop():
    """The on-device lax.scan multi-frame runner reproduces the host-loop
    driver (same per-frame PRNG keys; kinematics in f32 vs the host's f64
    explain only sub-cell differences)."""
    from radar_tpu.pipeline.driver import run_multiframe_device

    cfg = small_test_config(channels=8, pulses=32)
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [18.0])
    log_h, tracks_h, _ = run_multiframe(cfg, tb, num_frames=5, seed=0)
    log_d, tracks_d = run_multiframe_device(cfg, tb, num_frames=5, seed=0)
    assert len(log_d) == len(log_h)
    np.testing.assert_array_equal(log_d.frame, log_h.frame)
    np.testing.assert_allclose(log_d.range_m, log_h.range_m, atol=1.0)
    np.testing.assert_allclose(log_d.velocity_ms, log_h.velocity_ms,
                               atol=0.5)
    np.testing.assert_allclose(log_d.azimuth_deg, log_h.azimuth_deg,
                               atol=1e-3)
    assert len(tracks_d) == len(tracks_h)


@pytest.mark.slow
def test_monte_carlo_sweep_lowrank_matches_default():
    """Perf-config trial fn (lowrank + compact noise) reproduces the default
    path's Pd ladder on the same scene (different random streams, same
    distribution)."""
    truth = TargetBatch.make([3000.0], [10.0], [10.0], [0.0])
    pds = {}
    for name, kw in (("default", {}),
                     ("perf", dict(fused_synth_dbf=True, lowrank_rdm=True))):
        cfg = small_test_config(channels=8, pulses=32).replace(**kw)
        res = snr_sweep(cfg, snr_db_vector=[-42.0, 25.0], num_trials=12,
                        truth=truth, seed=3, batch_size=6)
        pds[name] = res.detection_probability
    for name in pds:
        assert pds[name][0] <= 0.3, name      # below the transition
        assert pds[name][-1] >= 0.9, name     # far above it


def test_multiframe_resume_after_crash(tmp_path):
    """Restart-on-failure (SURVEY 5.3): a run that dies mid-loop resumes
    from its per-frame measurement checkpoints and produces the IDENTICAL
    cumulative log and tracks as an uninterrupted run — replayed frames
    come from disk, only the missing ones recompute."""
    from radar_tpu.io.checkpoint import CheckpointStore, SaveOptions
    from radar_tpu.pipeline.frame import make_frame_processor
    from radar_tpu.waveform.precompute import precompute as _pre

    cfg = small_test_config(channels=8, pulses=32)
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [18.0])
    pre = _pre(cfg)
    proc = make_frame_processor(cfg, pre)

    # ground truth: uninterrupted 6-frame run
    log_full, tracks_full, _ = run_multiframe(cfg, tb, num_frames=6,
                                              seed=4, processor=proc)

    # "crashed" run: dies after frame 3 (simulated by only running 3)
    store = CheckpointStore(str(tmp_path / "ck"),
                            SaveOptions(measurements=True))
    run_multiframe(cfg, tb, num_frames=3, seed=4, processor=proc,
                   store=store)
    assert store.frames_done("measurements") == [1, 2, 3]

    # resumed run over the full horizon: frames 1-3 replay from disk
    log_res, tracks_res, _ = run_multiframe(cfg, tb, num_frames=6,
                                            seed=4, processor=proc,
                                            store=store)
    assert store.frames_done("measurements") == [1, 2, 3, 4, 5, 6]
    np.testing.assert_array_equal(log_res.frame, log_full.frame)
    for field in ("range_m", "velocity_ms", "elevation_deg", "power",
                  "azimuth_deg"):
        np.testing.assert_array_equal(getattr(log_res, field),
                                      getattr(log_full, field), err_msg=field)
    assert len(tracks_res) == len(tracks_full)

    # a resumed run with different (seed | config | scene) must be REFUSED
    # (run_manifest guard): splicing stale rows from another run's store
    # would produce a self-consistent-looking but wrong log
    with pytest.raises(ValueError, match="different run"):
        run_multiframe(cfg, tb, num_frames=6, seed=5, processor=proc,
                       store=store)
    tb2 = TargetBatch.make([4000.0], [15.0], [10.0], [18.0])
    with pytest.raises(ValueError, match="different run"):
        run_multiframe(cfg, tb2, num_frames=6, seed=4, processor=proc,
                       store=store)


def test_device_scan_chunked_resume(tmp_path):
    """Restart-on-failure for the DEVICE-SCAN runner: the chunked scan
    (kinematic carry threaded across chunks, absolute-frame PRNG keys)
    is bit-identical to the unchunked lax.scan run, a 'crashed' run's
    completed chunks replay from the orbax store, and the resumed run
    reproduces the uninterrupted log exactly."""
    from radar_tpu.io.orbax_store import OrbaxFrameStore
    from radar_tpu.pipeline.driver import run_multiframe_device

    cfg = small_test_config(channels=8, pulses=32)
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [18.0])

    log_full, tracks_full = run_multiframe_device(cfg, tb, num_frames=6,
                                                  seed=4)

    # "crashed" chunked run: completes 2 of 3 chunks
    store = OrbaxFrameStore(str(tmp_path / "ck"))
    run_multiframe_device(cfg, tb, num_frames=4, seed=4, store=store,
                          chunk_frames=2)
    assert store.frames_done() == [2, 4]

    # resumed over the full horizon: chunks 1-2 replay, chunk 3 computes
    log_res, tracks_res = run_multiframe_device(
        cfg, tb, num_frames=6, seed=4,
        store=OrbaxFrameStore(str(tmp_path / "ck")), chunk_frames=2)
    assert store.frames_done() == [2, 4, 6]
    np.testing.assert_array_equal(log_res.frame, log_full.frame)
    for field in ("range_m", "velocity_ms", "elevation_deg", "power",
                  "azimuth_deg"):
        np.testing.assert_array_equal(getattr(log_res, field),
                                      getattr(log_full, field),
                                      err_msg=field)
    assert len(tracks_res) == len(tracks_full)

    # mismatched seed refused (shared run-manifest guard)
    with pytest.raises(ValueError, match="different run"):
        run_multiframe_device(cfg, tb, num_frames=6, seed=5,
                              store=OrbaxFrameStore(str(tmp_path / "ck")),
                              chunk_frames=2)
    # indivisible chunking refused
    with pytest.raises(ValueError, match="not divisible"):
        run_multiframe_device(cfg, tb, num_frames=5, seed=4,
                              store=OrbaxFrameStore(str(tmp_path / "ck2")),
                              chunk_frames=2)


def test_checkpoint_save_is_atomic(tmp_path, monkeypatch):
    """A crash mid-write must never leave a truncated frame_*.npz that
    frames_done would count as complete (the exact failure restart-on-
    failure exists to survive)."""
    from radar_tpu.io.checkpoint import CheckpointStore, SaveOptions

    store = CheckpointStore(str(tmp_path / "ck"),
                            SaveOptions(measurements=True))
    store.save("measurements", 1, range_m=np.arange(3.0))
    assert store.frames_done("measurements") == [1]

    # simulate a crash inside the compressed write of frame 2
    real_savez = np.savez_compressed

    def dying_savez(path, **kw):
        real_savez(path, **kw)  # file exists on disk at the temp name...
        raise KeyboardInterrupt  # ...but the process dies before replace

    monkeypatch.setattr(np, "savez_compressed", dying_savez)
    with pytest.raises(KeyboardInterrupt):
        store.save("measurements", 2, range_m=np.arange(3.0))
    monkeypatch.undo()
    # the torn frame is invisible: no stale temp counted, frame 2 not done
    assert store.frames_done("measurements") == [1]
    assert not store.has("measurements", 2)
    # and a rerun completes it normally
    store.save("measurements", 2, range_m=np.arange(3.0))
    assert store.frames_done("measurements") == [1, 2]
