"""Track-level scoring (pipeline/track_metrics.py) + the v8_2 five-target
headline scene (sim/scenario.py::five_target_scene, simple kinematics) —
unit tests of the scorer's outcome classes on synthetic logs, parity of
the simple kinematic model between host Scenario and the device scan, and
the e2e headline scene at small scale.

Reference anchors: the scene and its kinematics are
main_simulate_echoes_with_array_v8_2.m:28-51,200-205; the associator
under test is _v8_3.m:253-335 (identical gates in v8_2:70-81).
"""

import numpy as np
import pytest

from radar_tpu.config.params import small_test_config
from radar_tpu.pipeline.driver import DetectionLog, Track
from radar_tpu.pipeline.track_metrics import (score_tracks,
                                              truth_trajectories)
from radar_tpu.sim.scenario import Scenario, TargetBatch, five_target_scene


def _log_from_rows(rows):
    """rows: list of (r, v, el, power, frame)."""
    a = np.array(rows, float)
    return DetectionLog(a[:, 0], a[:, 1], a[:, 2], a[:, 3],
                        a[:, 4].astype(int), np.zeros(len(a)))


def _track(member_idx, first, last):
    return Track(0.0, 0.0, 0.0, 0.0, 1.0, first, last, len(member_idx),
                 np.asarray(member_idx))


def test_truth_trajectories_simple_matches_scenario_step():
    cfg = small_test_config()
    tb = five_target_scene()
    traj = truth_trajectories(tb, 5, cfg, kinematics="simple")
    scen = Scenario.from_initial(tb, cfg, kinematics="simple")
    for f in range(5):
        got = scen.step(cfg)
        np.testing.assert_allclose(traj["range_m"][:, f], got.range_m)
        np.testing.assert_allclose(traj["velocity_ms"][:, f],
                                   got.velocity_ms)
        np.testing.assert_allclose(traj["elevation_deg"][:, f],
                                   got.elevation_deg)


def test_truth_trajectories_altitude_matches_scenario_step():
    cfg = small_test_config()
    tb = TargetBatch.make([3000.0, 9000.0], [20.0, 25.0], [10.0, 30.0],
                          [10.0, 10.0])
    traj = truth_trajectories(tb, 4, cfg, kinematics="altitude")
    scen = Scenario.from_initial(tb, cfg)
    for f in range(4):
        got = scen.step(cfg)
        np.testing.assert_allclose(traj["range_m"][:, f], got.range_m)
        np.testing.assert_allclose(traj["velocity_ms"][:, f],
                                   got.velocity_ms)
        np.testing.assert_allclose(traj["elevation_deg"][:, f],
                                   got.elevation_deg)


def test_five_target_scene_matches_reference_values():
    """Verbatim v8_2.m:28-51 — targets (3000,15,10,-10), (5000,20,5,1),
    (6500,10,15,-20), (8000,5,20,5), (10000,8,8,15)."""
    tb = five_target_scene()
    np.testing.assert_array_equal(tb.range_m,
                                  [3000, 5000, 6500, 8000, 10000])
    np.testing.assert_array_equal(tb.velocity_ms, [15, 20, 10, 5, 8])
    np.testing.assert_array_equal(tb.elevation_deg, [10, 5, 15, 20, 8])
    np.testing.assert_array_equal(tb.snr_db, [-10, 1, -20, 5, 15])


def test_score_tracks_outcome_classes():
    """One clean track, one false track, one fragmented truth, one
    switched track — each lands in its metric."""
    cfg = small_test_config()
    t_frame = cfg.sig.frame_time
    truth = TargetBatch.make([3000.0, 8000.0], [20.0, 5.0], [10.0, 20.0],
                             [10.0, 10.0])
    rows = []
    # truth 0, frames 1..6 -> one clean track
    for f in range(1, 7):
        rows.append((3000.0 - 20.0 * f * t_frame, 20.0, 10.0, 1.0, f))
    # truth 1, frames 1..3 and 5..6 -> TWO tracks (fragmented)
    for f in (1, 2, 3, 5, 6):
        rows.append((8000.0 - 5.0 * f * t_frame, 5.0, 20.0, 1.0, f))
    # clutter rows far from both truths -> false track
    for f in (2, 3, 4):
        rows.append((15000.0, -10.0, 5.0, 1.0, f))
    # switched track: half truth-0, half truth-1 members
    log = _log_from_rows(rows)
    tracks = [
        _track(np.arange(0, 6), 1, 6),           # clean on truth 0
        _track(np.arange(6, 9), 1, 3),           # truth 1 part A
        _track(np.arange(9, 11), 5, 6),          # truth 1 part B
        _track(np.arange(11, 14), 2, 4),         # clutter -> false
        _track(np.array([0, 1, 6, 7]), 1, 2),    # 50/50 mix -> switched
    ]
    sc = score_tracks(log, tracks, truth, 6, cfg, kinematics="simple")
    assert sc.truth_detected.all()
    assert sc.false_tracks == 1
    assert sc.truth_n_tracks[0] >= 1 and sc.truth_n_tracks[1] == 2
    assert sc.switched_tracks >= 1
    np.testing.assert_allclose(sc.truth_coverage[0], 1.0)
    # truth 1 covered on 5 of 6 frames
    np.testing.assert_allclose(sc.truth_coverage[1], 5.0 / 6.0)


def test_score_tracks_ghost_classification():
    """A false track whose members match a truth in (R, V) but sit at a
    far-off elevation — a beam-sidelobe ghost — counts in ghost_tracks;
    a clutter track (matching nothing) does not."""
    cfg = small_test_config()
    t_frame = cfg.sig.frame_time
    truth = TargetBatch.make([6400.0], [22.0], [32.0], [10.0])
    rows = []
    for f in range(1, 5):
        rows.append((6400.0 - 22.0 * f * t_frame, 22.0, 32.0, 5.0, f))
    for f in range(1, 5):   # ghost: same R/V, elevation 15 deg
        rows.append((6400.0 - 22.0 * f * t_frame, 22.3, 15.0, 1.0, f))
    for f in range(1, 4):   # clutter: matches nothing
        rows.append((15000.0, -5.0, 5.0, 1.0, f))
    log = _log_from_rows(rows)
    tracks = [_track(np.arange(0, 4), 1, 4),
              _track(np.arange(4, 8), 1, 4),
              _track(np.arange(8, 11), 1, 3)]
    sc = score_tracks(log, tracks, truth, 4, cfg, kinematics="simple")
    assert sc.truth_detected.all()
    assert sc.false_tracks == 2
    assert sc.ghost_tracks == 1


def test_score_tracks_empty_log():
    cfg = small_test_config()
    truth = TargetBatch.make([3000.0], [20.0], [10.0], [10.0])
    sc = score_tracks(DetectionLog.empty(), [], truth, 5, cfg)
    assert sc.track_pd == 0.0 and sc.false_tracks == 0
    assert np.isnan(sc.fragmentation)


def test_simple_kinematics_device_scan_matches_host():
    """The device-scan runner's simple model reproduces the host
    Scenario.step sequence (R -= V*T, El/V constant, v8_2:200-205)."""
    import jax

    from radar_tpu.pipeline.driver import make_device_multiframe

    cfg = small_test_config(channels=8, pulses=32)
    tb = TargetBatch.make([3000.0, 5000.0], [15.0, -10.0], [10.0, 5.0],
                          [20.0, 20.0])
    runner = make_device_multiframe(cfg, kinematics="simple")
    _, azimuths, carry = jax.block_until_ready(
        runner(jax.random.PRNGKey(0), tb, 4))
    scen = Scenario.from_initial(tb, cfg, kinematics="simple")
    for _ in range(4):
        last = scen.step(cfg)
    np.testing.assert_allclose(np.asarray(carry[1]), last.range_m,
                               rtol=1e-6)
    assert abs(float(azimuths[-1]) - scen.azimuth_deg) < 1e-4


@pytest.mark.slow
def test_five_target_headline_small_e2e():
    """The v8_2 five-target scene end-to-end at small scale: every truth
    (including the -20 dB target, which the small config's processing
    gain still lifts above threshold) acquires at least one majority-
    pure track with high coverage. The FULL-scale run is
    in git history (git show dc6ffd7:results/headline_5target.json: 5/5
    clean tracks)."""
    import jax

    from radar_tpu.pipeline.driver import (associate_tracks,
                                           device_results_to_log,
                                           make_device_multiframe)

    cfg = small_test_config()
    tb = five_target_scene()
    n_frames = 8
    runner = make_device_multiframe(cfg, kinematics="simple")
    results, azimuths, _ = jax.block_until_ready(
        runner(jax.random.PRNGKey(0), tb, n_frames))
    log = device_results_to_log(results, azimuths)
    tracks = associate_tracks(log, cfg)
    sc = score_tracks(log, tracks, tb, n_frames, cfg, kinematics="simple")
    assert sc.track_pd == 1.0, sc
    assert (sc.truth_coverage >= 0.75).all(), sc.truth_coverage
    assert sc.false_tracks <= 1, sc.false_tracks
