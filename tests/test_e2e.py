"""Ground-truth-injection integration tests (SURVEY.md section 4.1): run the
full jitted frame pipeline on known targets and assert the detected
(R, V, El) fall within gate tolerances of the injected truth.

Covers BASELINE.json config 1 (8-element, 32-pulse minimum slice) and a
16-channel run through the measured DBF/angle/K assets.
"""

import jax
import jax.numpy as jnp
import numpy as np

from radar_tpu.config.params import (RadarConfig, SigConfig,
                                     small_test_config)
from radar_tpu.pipeline.frame import make_frame_processor
from radar_tpu.sim.scenario import TargetBatch
from radar_tpu.waveform.precompute import precompute


def _final_list(result):
    t = result.targets
    valid = np.asarray(t.valid)
    return (np.asarray(t.range_m)[valid], np.asarray(t.velocity_ms)[valid],
            np.asarray(t.angle_deg)[valid], np.asarray(t.power)[valid])


def test_minimum_slice_single_target():
    cfg = small_test_config(channels=8, pulses=32)
    pre = precompute(cfg)
    process = make_frame_processor(cfg, pre, dtype=jnp.complex64)
    truth = dict(r=3000.0, v=10.0, el=10.0)
    tb = TargetBatch.make([truth["r"]], [truth["v"]], [truth["el"]], [20.0])
    result = jax.block_until_ready(process(jax.random.PRNGKey(0), tb))

    assert int(result.num_raw_detections) > 0
    r, v, a, p = _final_list(result)
    assert len(r) >= 1
    # strongest target within gates of truth
    i = int(np.argmax(p))
    assert abs(r[i] - truth["r"]) <= 2 * pre.delta_r + 3.0
    # velocity tolerance: axis fencepost quirk scales ~v*N/(N-1) + cell width
    assert abs(v[i] - truth["v"]) <= 3.0
    assert abs(a[i] - truth["el"]) <= 3.0


def test_16ch_measured_assets_two_targets():
    sig = SigConfig(prt_num=64, channel_num=16, beam_num=13)
    # at 64 pulses the full-size Doppler border (ref 5 + guard 10) would
    # exclude half the velocity span; shrink the Doppler guard band
    from radar_tpu.config.params import CfarParams

    cfg = RadarConfig(sig=sig, cfar=CfarParams(ref_cells_v=5, guard_cells_v=4,
                                               ref_cells_r=5,
                                               guard_cells_r=10))
    pre = precompute(cfg)
    # measured DBF bank + calibrated angle/K LUTs in play
    assert pre.dbf_w.shape == (13, 16)
    process = make_frame_processor(cfg, pre, dtype=jnp.complex64)
    tb = TargetBatch.make([3000.0, 10000.0], [20.0, 25.0], [10.0, 10.0],
                          [15.0, 18.0])
    result = jax.block_until_ready(process(jax.random.PRNGKey(1), tb))

    r, v, a, p = _final_list(result)
    assert len(r) >= 2, (r, v, a)
    for r_true, v_true in ((3000.0, 20.0), (10000.0, 25.0)):
        j = int(np.argmin(np.abs(r - r_true)))
        assert abs(r[j] - r_true) <= 2 * pre.delta_r + 3.0, (r_true, r[j])
        assert abs(v[j] - v_true) <= 3.0, (v_true, v[j])
        # elevation via monopulse with the measured K LUT
        assert abs(a[j] - 10.0) <= 3.0, (r_true, a[j])


def test_frame_processor_is_deterministic():
    cfg = small_test_config(channels=8, pulses=32)
    process = make_frame_processor(cfg, dtype=jnp.complex64)
    tb = TargetBatch.make([5000.0], [15.0], [5.0], [15.0])
    r1 = process(jax.random.PRNGKey(42), tb)
    r2 = process(jax.random.PRNGKey(42), tb)
    np.testing.assert_array_equal(np.asarray(r1.targets.range_m),
                                  np.asarray(r2.targets.range_m))
    assert int(r1.num_raw_detections) == int(r2.num_raw_detections)


def test_no_target_no_detections():
    """Pure noise at Pfa set by T_CFAR=8 on means of 5 cells: expect a
    (near-)empty detection list."""
    cfg = small_test_config(channels=8, pulses=32)
    process = make_frame_processor(cfg, dtype=jnp.complex64)
    tb = TargetBatch.make([1.0], [0.0], [0.0], [-100.0])  # buried target
    result = process(jax.random.PRNGKey(3), tb)
    # threshold factor 8 on a 5-cell mean is a ~1e-7 Pfa for Rayleigh noise;
    # 32x3404x4 cells -> expect ~0, allow a few strays
    assert int(result.num_raw_detections) <= 5


def test_high_snr_near_bound_accuracy():
    """High-SNR truth injection binds the e2e chain tightly (VERDICT weak
    item): at 30 dB the monopulse angle error must sit in the sweep-bound
    class (sigma 0.03-0.09 deg at full scale, git show
    dc6ffd7:results/snr_sweep_full.json)
    — orders tighter than the +-3 deg gate tests — and the range/velocity
    estimates must be sub-cell AND seed-stable (their small constant
    offsets are preserved reference axis conventions, not noise)."""
    sig = SigConfig(prt_num=64, channel_num=16, beam_num=13)
    from radar_tpu.config.params import CfarParams

    cfg = RadarConfig(sig=sig, cfar=CfarParams(ref_cells_v=5,
                                               guard_cells_v=4,
                                               ref_cells_r=5,
                                               guard_cells_r=10))
    pre = precompute(cfg)
    process = make_frame_processor(cfg, pre, dtype=jnp.complex64)
    tb = TargetBatch.make([10000.0], [20.0], [10.0], [30.0])
    rs, vs, angs = [], [], []
    for seed in range(4):
        res = process(jax.random.PRNGKey(seed), tb)
        r, v, a, p = _final_list(res)
        i = int(np.argmax(p))
        rs.append(r[i])
        vs.append(v[i])
        angs.append(a[i])
    rs, vs, angs = np.asarray(rs), np.asarray(vs), np.asarray(angs)
    # angle: within 0.1 deg of truth, noise-level spread
    assert np.max(np.abs(angs - 10.0)) < 0.1, angs
    assert np.ptp(angs) < 0.05, angs
    # range/velocity: sub-cell absolute error, noise-free spread
    assert np.max(np.abs(rs - 10000.0)) < pre.delta_r, rs
    assert np.ptp(rs) < 0.1, rs
    delta_v_64 = pre.delta_v * 332.0 / 64.0
    assert np.max(np.abs(vs - 20.0)) < delta_v_64, vs
    assert np.ptp(vs) < 0.01, vs
