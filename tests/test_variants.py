"""Reference-variant coverage: v7_7 DBF/MTD/monopulse variants,
measurement sub-cell precision (SURVEY.md section 7.4
"Reference ambiguity": the framework exposes variants explicitly)."""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from radar_tpu.config.params import small_test_config
from radar_tpu.pipeline.frame import make_frame_processor
from radar_tpu.sim.scenario import TargetBatch
from radar_tpu.waveform.precompute import precompute


def _run(cfg, pre, r=3000.0, v=10.0, el=10.0, snr=20.0, seed=0):
    proc = make_frame_processor(cfg, pre, dtype=jnp.complex64)
    tb = TargetBatch.make([r], [v], [el], [snr])
    res = jax.block_until_ready(proc(jax.random.PRNGKey(seed), tb))
    valid = np.asarray(res.targets.valid)
    return (np.asarray(res.targets.range_m)[valid],
            np.asarray(res.targets.velocity_ms)[valid],
            np.asarray(res.targets.angle_deg)[valid],
            np.asarray(res.targets.power)[valid])


def test_mtd_512_pad_variant_e2e():
    cfg = small_test_config(channels=8, pulses=32)
    pre = precompute(cfg)
    cfg512 = cfg.replace(mtd_fft_len=64)
    r, v, a, p = _run(cfg512, pre)
    assert len(r) >= 1
    i = int(np.argmax(p))
    assert abs(r[i] - 3000.0) < 20.0
    # finer Doppler bins with the zero-padded FFT: velocity still recovered
    assert abs(v[i] - 10.0) < 3.0


@pytest.mark.slow
def test_monopulse_complex_variant_e2e():
    """v7_6 complex-ratio monopulse (main_plot_snr_vs_angle_error.m:455-458)
    needs phase-aligned beams — run it on the measured 16-channel bank, the
    geometry it was written for. (On a synthetic Hamming steering bank the
    adjacent beams carry a large inter-beam phase offset and the real part
    of the complex ratio is not an amplitude ratio — faithful to the
    reference formula, documented here.)"""
    from radar_tpu.config.params import CfarParams, RadarConfig, SigConfig

    cfg = RadarConfig(
        sig=SigConfig(prt_num=64, channel_num=16, beam_num=13),
        cfar=CfarParams(ref_cells_v=5, guard_cells_v=4, ref_cells_r=5,
                        guard_cells_r=10))
    pre = precompute(cfg)
    r1, v1, a1, p1 = _run(cfg, pre, v=10.0)
    r2, v2, a2, p2 = _run(cfg.replace(monopulse_complex=True), pre, v=10.0)
    # same detections; both angle estimates near truth for measured beams
    assert len(r1) == len(r2)
    assert abs(a1[int(np.argmax(p1))] - 10.0) < 3.0
    assert abs(a2[int(np.argmax(p2))] - 10.0) < 3.0


def test_monopulse_refined_variant_e2e():
    """The refined-index monopulse (cfg.monopulse_refined: ratio at the
    spline-refined subcell peak, the fix for the reference's documented
    integer-index flaw, fun_process_single_frame.m:280-281) produces the
    same detections with an angle estimate that stays near truth; with
    truth ON the cell centers both variants agree closely."""
    cfg = small_test_config(channels=8, pulses=32)
    pre = precompute(cfg)
    r1, v1, a1, p1 = _run(cfg, pre, snr=25.0)
    r2, v2, a2, p2 = _run(cfg.replace(monopulse_refined=True), pre,
                          snr=25.0)
    assert len(r1) == len(r2) >= 1
    # range/velocity refinement identical (the refined flag touches only
    # the monopulse ratio)
    np.testing.assert_allclose(r2, r1, rtol=1e-6)
    np.testing.assert_allclose(v2, v1, rtol=1e-5, atol=1e-5)
    i1, i2 = int(np.argmax(p1)), int(np.argmax(p2))
    assert abs(a1[i1] - 10.0) < 3.0
    assert abs(a2[i2] - 10.0) < 3.0
    # both evaluate the same surface; at high SNR the refined ratio sits
    # within the inter-variant spread of a fraction of the pair width
    assert abs(a2[i2] - a1[i1]) < 1.5


def test_monopulse_refined_integer_peak_matches_flawed():
    """When the spline peak lands EXACTLY on the integer cell (symmetric
    stencil), the refined evaluation reads the same RDM cell as the
    integer-index flaw — the variants must agree to float tolerance."""
    from radar_tpu.measure.estimate import estimate_parameters
    from radar_tpu.ops.cfar import Detections
    from radar_tpu.pipeline.frame import measure_consts

    cfg = small_test_config(channels=8, pulses=32)
    pre = precompute(cfg)
    mc = measure_consts(cfg, pre, np.float32)
    nv, ng, nb = cfg.sig.prt_num, pre.n_total_gate, cfg.sig.beam_num
    rng = np.random.default_rng(0)
    # a symmetric bump centered on (v0, r0) in every beam -> spline peak
    # exactly at the integer cell
    v0, r0 = nv // 2, ng // 2
    rdm = np.full((nv, ng, nb), 0.01, np.complex64)
    for db in (-2, -1, 0, 1, 2):
        for dg in (-2, -1, 0, 1, 2):
            rdm[v0 + db, r0 + dg, :] = 5.0 * np.exp(
                -(db**2 + dg**2)) + 0.0j
    rdm = jnp.asarray(rdm + 0.001 * rng.standard_normal(rdm.shape))
    maps = jnp.abs(rdm[:, :, :-1]) + jnp.abs(rdm[:, :, 1:])
    cap = 4
    dets = Detections(
        v_idx=jnp.asarray([v0, 0, 0, 0]),
        r_idx=jnp.asarray([r0, 0, 0, 0]),
        pair_idx=jnp.asarray([3, 0, 0, 0]),
        amp=jnp.ones(cap, jnp.float32),
        valid=jnp.asarray([True, False, False, False]),
        count=jnp.asarray(1, jnp.int32))
    ip = cfg.interp
    kw = dict(extra_dots=ip.extra_dots, r_times=ip.r_interp_times,
              v_times=ip.v_interp_times)
    p_int = estimate_parameters(dets, maps, rdm, mc, **kw)
    p_ref = estimate_parameters(dets, maps, rdm, mc,
                                monopulse_refined=True, **kw)
    np.testing.assert_allclose(np.asarray(p_ref.angle_deg)[0],
                               np.asarray(p_int.angle_deg)[0], atol=5e-3)


def test_dbf_v7_7_variant_runs():
    """v7_7 convention (fliplr, no conj) with a synthetic bank: the flipped
    non-conjugated weights steer differently — the pipeline must still run
    and produce a detection list (possibly at another beam mapping)."""
    cfg = small_test_config(channels=8, pulses=32).replace(
        dbf_variant="v7_7")
    pre = precompute(cfg)
    proc = make_frame_processor(cfg, pre, dtype=jnp.complex64)
    tb = TargetBatch.make([3000.0], [10.0], [10.0], [20.0])
    res = jax.block_until_ready(proc(jax.random.PRNGKey(0), tb))
    assert int(res.num_raw_detections) >= 0  # runs without error


def test_measurement_subcell_precision():
    """Sub-cell spline refinement: sweep true range across a cell; the
    refined estimate must track the truth better than cell quantization."""
    cfg = small_test_config(channels=8, pulses=32)
    pre = precompute(cfg)
    proc = make_frame_processor(cfg, pre, dtype=jnp.complex64)
    errors = []
    for frac in (0.0, 0.25, 0.5, 0.75):
        r_true = (500 + frac) * pre.delta_r
        tb = TargetBatch.make([r_true], [10.0], [10.0], [25.0])
        res = proc(jax.random.PRNGKey(7), tb)
        valid = np.asarray(res.targets.valid)
        p = np.asarray(res.targets.power)[valid]
        r_est = np.asarray(res.targets.range_m)[valid][int(np.argmax(p))]
        errors.append(r_est - r_true)
    # delay rounding puts truth within +-0.5 cell; the spline refinement
    # should keep mean |error| under ~1 cell and well under 2 cells max
    errors = np.abs(np.asarray(errors))
    assert errors.max() < 2 * pre.delta_r, errors
    assert errors.mean() < pre.delta_r, errors


def test_beam_pattern_fc_quirk_override():
    from radar_tpu.config.params import full_config
    from radar_tpu.doa.calibrate import beam_patterns

    cfg = full_config()
    pre = precompute(cfg)
    wl_9500 = cfg.sig.c / 9500e6
    _, _, peaks_sys = beam_patterns(pre.dbf_w, cfg.array.element_spacing,
                                    cfg.sig.wavelength)
    _, _, peaks_quirk = beam_patterns(pre.dbf_w, cfg.array.element_spacing,
                                      cfg.sig.wavelength,
                                      wavelength_override=wl_9500)
    # shorter wavelength squeezes the beam fan slightly toward broadside
    assert np.all(np.abs(peaks_quirk[1:-1]) <= np.abs(peaks_sys[1:-1]) + 0.2)
    assert not np.allclose(peaks_quirk, peaks_sys)
