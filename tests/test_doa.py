"""DoA subsystem tests: MUSIC 1D/2D resolution, radar-geometry comparison,
sigma/delta monopulse demo, sharded covariance at 128 elements
(SURVEY.md section 2.2; BASELINE.json config 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radar_tpu.config.params import full_config
from radar_tpu.doa.monopulse import (estimate_angle, make_sum_diff_beams,
                                     sum_diff_patterns)
from radar_tpu.doa.music import (conventional_beam_spectrum, covariance,
                                 music_1d, music_2d, simulate_snapshots,
                                 steering_ura)
from radar_tpu.doa.steering import steering_vector


WAVELENGTH = 2.99792458e8 / 9450e6


def test_music_1d_three_sources_halfwave():
    """MUSIC_1D.m setup: 10-element lambda/2 ULA, 3 sources."""
    d = WAVELENGTH / 2
    key = jax.random.PRNGKey(0)
    truth = [-20.0, 0.0, 15.0]
    x = simulate_snapshots(key, truth, 10, d, WAVELENGTH, 512, snr_db=10.0,
                           dtype=jnp.complex128)
    res = music_1d(x, 3, d, WAVELENGTH)
    np.testing.assert_allclose(res.peaks_deg, truth, atol=0.5)


def test_music_radar_geometry_resolves_close_sources():
    """run_music_algorithm.m: 16 channels, d=13.8mm, two sources 2.0 / -1.5
    deg, 256 snapshots — MUSIC resolves them, conventional DBF cannot."""
    cfg = full_config()
    d = cfg.array.element_spacing
    key = jax.random.PRNGKey(1)
    truth = [-1.5, 2.0]
    x = simulate_snapshots(key, truth, 16, d, WAVELENGTH, 256, snr_db=20.0,
                           dtype=jnp.complex128)
    scan = np.arange(-20.0, 20.0 + 1e-9, 0.1)
    res = music_1d(x, 2, d, WAVELENGTH, scan)
    np.testing.assert_allclose(res.peaks_deg, truth, atol=0.4)
    # conventional Hamming DBF: single merged lobe (beamwidth ~10 deg at
    # this small aperture) -> cannot show two peaks 3.5 deg apart
    conv = np.asarray(conventional_beam_spectrum(x, scan, d, WAVELENGTH))
    interior = (conv[1:-1] > conv[:-2]) & (conv[1:-1] > conv[2:])
    strong = conv[1:-1] > 0.5 * conv.max()
    assert np.sum(interior & strong) <= 1


def test_music_128_elements_sharded_covariance():
    """BASELINE config 4: 128-element MUSIC with the covariance accumulated
    across snapshot shards on the device mesh."""
    from radar_tpu.parallel.collectives import covariance_snapshot_sharded
    from radar_tpu.parallel.mesh import make_mesh

    d = WAVELENGTH / 2
    key = jax.random.PRNGKey(2)
    truth = [-5.0, -4.0, 10.0]  # 1-degree separation needs the big aperture
    x = simulate_snapshots(key, truth, 128, d, WAVELENGTH, 512, snr_db=5.0,
                           dtype=jnp.complex128)
    mesh = make_mesh(cpi=8)
    r_sharded = covariance_snapshot_sharded(mesh)(x)
    np.testing.assert_allclose(np.asarray(r_sharded),
                               np.asarray(covariance(x)), rtol=1e-9,
                               atol=1e-9)
    from radar_tpu.doa.music import (find_peaks_1d, music_spectrum_1d)

    scan = np.arange(-20.0, 20.0 + 1e-9, 0.05)
    spec = music_spectrum_1d(r_sharded, 3, scan, d, WAVELENGTH)
    peaks = find_peaks_1d(scan, np.asarray(spec), 3)
    np.testing.assert_allclose(peaks, truth, atol=0.2)


def test_music_2d_ura():
    """MUSIC_2D.m: 8x8 URA, 2 sources on the (az, el) grid."""
    nx = ny = 8
    truth = np.array([[20.0, 30.0], [-30.0, 60.0]])  # (az, el)
    a = steering_ura(truth[:, 0], truth[:, 1], nx, ny, 0.5)
    cols = [a[:, i * len(truth[:, 1]) + i] for i in range(2)]
    a_src = np.stack(cols, axis=1)  # diagonal picks (az_i, el_i)
    rng = np.random.default_rng(0)
    k = 256
    s = (rng.normal(size=(2, k)) + 1j * rng.normal(size=(2, k))) / np.sqrt(2)
    n = (rng.normal(size=(nx * ny, k)) + 1j * rng.normal(size=(nx * ny, k))
         ) * np.sqrt(0.5) * 0.1
    x = jnp.asarray(a_src @ s + n)
    res = music_2d(x, 2, nx, ny, 0.5)
    got = res.peaks_deg[np.argsort(res.peaks_deg[:, 0])]
    want = truth[np.argsort(truth[:, 0])]
    np.testing.assert_allclose(got, want, atol=1.5)


def test_regional_max_picker_marks_missing_peaks():
    """When the spectrum has FEWER regional maxima than requested, the
    device picker's masked top_k tail is -inf pointing at arbitrary
    cells; the -inf values are the contract music_2d uses to DROP those
    entries instead of reporting fabricated corners."""
    from radar_tpu.doa.music import regional_max_peaks_2d

    spec = jnp.asarray(np.arange(12.0).reshape(3, 4) + 1.0)  # monotone
    idx, vals = regional_max_peaks_2d(spec, 3)
    finite = np.isfinite(np.asarray(vals))
    assert finite.tolist() == [True, False, False]
    assert int(np.asarray(idx)[0]) == 11      # the single true maximum


def test_music_2d_device_peaks_match_host():
    """The device-side regional-max picker (stencil + top_k) returns the
    same peaks as the host numpy picker on the reference 8x8 problem."""
    nx = ny = 8
    truth = np.array([[20.0, 30.0], [-30.0, 60.0]])
    a = steering_ura(truth[:, 0], truth[:, 1], nx, ny, 0.5)
    cols = [a[:, i * len(truth[:, 1]) + i] for i in range(2)]
    a_src = np.stack(cols, axis=1)
    rng = np.random.default_rng(0)
    k = 256
    s = (rng.normal(size=(2, k)) + 1j * rng.normal(size=(2, k))) / np.sqrt(2)
    n = (rng.normal(size=(nx * ny, k)) + 1j * rng.normal(size=(nx * ny, k))
         ) * np.sqrt(0.5) * 0.1
    x = jnp.asarray(a_src @ s + n)
    res_dev = music_2d(x, 2, nx, ny, 0.5, peak_impl="device")
    res_host = music_2d(x, 2, nx, ny, 0.5, peak_impl="host")
    np.testing.assert_array_equal(res_dev.peaks_deg, res_host.peaks_deg)


def test_music_2d_128el_scaled():
    """BASELINE.json config 4: MUSIC 2D at the 128-element aperture — a
    16x8 URA, covariance accumulated via the snapshot-sharded psum path on
    the 8-device mesh, a 0.25-degree grid, and device-side regional-max
    peak picking (MUSIC_2D.m:32-93,119-144 scaled 2x in elements and 4x in
    grid density)."""
    from radar_tpu.parallel.mesh import make_mesh

    nx, ny = 16, 8
    truth = np.array([[12.0, 25.0], [15.0, 25.0], [-40.0, 55.0]])
    a = steering_ura(truth[:, 0], truth[:, 1], nx, ny, 0.5)
    g_el = len(truth[:, 1])
    a_src = np.stack([a[:, i * g_el + i] for i in range(len(truth))], axis=1)
    rng = np.random.default_rng(3)
    k = 512
    m = len(truth)
    s = (rng.normal(size=(m, k)) + 1j * rng.normal(size=(m, k))) / np.sqrt(2)
    n = (rng.normal(size=(nx * ny, k))
         + 1j * rng.normal(size=(nx * ny, k))) * np.sqrt(0.5) * 0.3
    x = jnp.asarray(a_src @ s + n, jnp.complex64)
    az = np.arange(-60.0, 60.0 + 1e-9, 0.25)
    el = np.arange(10.0, 80.0 + 1e-9, 0.25)
    res = music_2d(x, m, nx, ny, 0.5, az_deg=az, el_deg=el,
                   peak_impl="device", mesh=make_mesh(cpi=8))
    got = res.peaks_deg[np.argsort(res.peaks_deg[:, 0])]
    want = truth[np.argsort(truth[:, 0])]
    # 3-degree az separation resolved; 0.25-deg grid quantization bound
    np.testing.assert_allclose(got, want, atol=0.5)


def test_music_2d_subgrid_refinement():
    """refine=True (log-parabola vertex around each device-picked peak)
    recovers OFF-GRID truths well under the grid step — beyond the
    reference's grid-quantized imregionalmax picker."""
    nx, ny = 16, 8
    truth = np.array([[12.3, 25.7], [-40.6, 55.4]])   # off the 1-deg grid
    a = steering_ura(truth[:, 0], truth[:, 1], nx, ny, 0.5)
    g_el = len(truth[:, 1])
    a_src = np.stack([a[:, i * g_el + i] for i in range(len(truth))],
                     axis=1)
    rng = np.random.default_rng(4)
    k = 512
    m = len(truth)
    s = (rng.normal(size=(m, k)) + 1j * rng.normal(size=(m, k))) / np.sqrt(2)
    n = (rng.normal(size=(nx * ny, k))
         + 1j * rng.normal(size=(nx * ny, k))) * np.sqrt(0.5) * 0.1
    x = jnp.asarray(a_src @ s + n, jnp.complex64)
    az = np.arange(-60.0, 60.0 + 1e-9, 1.0)
    el = np.arange(10.0, 80.0 + 1e-9, 1.0)
    coarse = music_2d(x, m, nx, ny, 0.5, az_deg=az, el_deg=el)
    fine = music_2d(x, m, nx, ny, 0.5, az_deg=az, el_deg=el, refine=True)
    want = truth[np.argsort(truth[:, 0])]
    gc = coarse.peaks_deg[np.argsort(coarse.peaks_deg[:, 0])]
    gf = fine.peaks_deg[np.argsort(fine.peaks_deg[:, 0])]
    err_c = np.abs(gc - want).max()
    err_f = np.abs(gf - want).max()
    assert err_c <= 0.5 + 1e-6          # grid-quantization bound
    assert err_f < 0.15                 # well under the 1-deg step
    assert err_f < err_c                # refinement strictly helps here


def test_sigma_delta_monopulse_demo():
    """singlepulse_angle.m: self-calibrated slope recovers a 2-degree
    off-boresight target."""
    cfg = full_config()
    d, wl = cfg.array.element_spacing, cfg.sig.wavelength
    beams = make_sum_diff_beams(16, d, wl, corrected=True)
    sig = steering_vector(np.array([2.0]), 16, d, wl)[:, 0]
    est = estimate_angle(beams, sig)
    assert abs(est - 2.0) < 0.3
    # boresight gives ~0
    sig0 = steering_vector(np.array([0.0]), 16, d, wl)[:, 0]
    assert abs(estimate_angle(beams, sig0)) < 1e-6
    # reference-faithful (uncorrected) variant reproduces the reference
    # script's biased output (~0.12 deg for a 2-deg target: the diff beam
    # has no boresight null, see doa/monopulse.py docstring)
    ref = make_sum_diff_beams(16, d, wl, corrected=False)
    est_ref = estimate_angle(ref, sig)
    assert abs(est_ref - 0.12) < 0.01
    # sum pattern peaks at boresight
    scan, p_sum, p_diff = sum_diff_patterns(beams, d, wl)
    i0 = np.argmin(np.abs(scan))
    assert p_sum[i0] > -1.0


def test_reference_calibration_procedure_pinned():
    """Running the committed reference calibration procedure
    (calibrate_all_monopulse_slopes.m: fliplr'd weights, complex field
    ratio, +/-separation scan, +/-5-point fit) on the measured DBF bank
    yields these values — which do NOT equal the LUT pasted into
    _v8_3.m:179 (a documented reference inconsistency; the framework ships
    the pasted LUT as the operating constant)."""
    from radar_tpu.config import assets
    from radar_tpu.config.params import small_test_config
    from radar_tpu.doa.calibrate import calibrate_k_slopes

    w = np.fliplr(assets.dbf_coeffs())
    angles = np.asarray(assets.BEAM_ANGLES_DEG_16CH)
    cfg = small_test_config(channels=16, pulses=4, beams=13)
    ks = calibrate_k_slopes(w, angles, cfg.array.element_spacing,
                            cfg.sig.wavelength, ratio="complex",
                            span_factor=1.0)
    np.testing.assert_allclose(
        ks[:4], [-2.5448, -2.3314, -2.2636, -2.3314], atol=2e-3)
    # ... and differs from the shipped (pasted) LUT
    assert np.max(np.abs(ks - np.asarray(assets.K_SLOPES_LUT_16CH))) > 1.0


def test_beam_patterns_reference_quirks_reproduce_lut():
    """The quirk-faithful plot_beam_patterns.m procedure (fliplr'd
    weights, fc=9500 MHz instead of the system's 9450, 1-based element
    indices, no conjugation — plot_beam_patterns.m:20,40,52,64) reproduces
    the pasted beam_angles_deg LUT (v8_3:178) EXACTLY on the measured DBF
    CSV, while the same procedure at the true carrier drifts up to 0.8 deg
    — proving the LUT is a product of the quirky script."""
    from radar_tpu.config import assets
    from radar_tpu.doa.calibrate import beam_patterns, \
        beam_patterns_reference
    from radar_tpu.doa.steering import steering_vector

    w = assets.dbf_coeffs()
    _, resp, peaks = beam_patterns_reference(w)
    np.testing.assert_allclose(peaks, assets.BEAM_ANGLES_DEG_16CH,
                               atol=1e-9)
    # at the system carrier the steepest beams land elsewhere
    lam = 2.99792458e8 / 9450e6
    _, _, peaks_sys = beam_patterns(np.fliplr(w).conj(), 0.0138, lam)
    assert np.max(np.abs(peaks_sys - assets.BEAM_ANGLES_DEG_16CH)) > 0.5
    # the 1-based index quirk is a pure per-angle global phase: magnitude
    # patterns identical, complex responses differ by exactly that phase
    scan = np.arange(-10.0, 10.0, 0.5)
    s0 = steering_vector(scan, 16, 0.0138, lam, index_base=0)
    s1 = steering_vector(scan, 16, 0.0138, lam, index_base=1)
    np.testing.assert_allclose(np.abs(w @ s0), np.abs(w @ s1), rtol=1e-12)
    phase = s1[0] / s0[0]
    np.testing.assert_allclose(s1, s0 * phase[None, :], rtol=1e-12)


def test_root_music_matches_truth_beyond_grid_resolution():
    """Root-MUSIC (beyond-reference, doa/superres.py): same subspace as
    grid MUSIC but closed-form rooting — recovers off-grid truths to
    better than the 0.1-deg scan step of the grid implementation."""
    from radar_tpu.doa.superres import root_music_1d

    cfg = full_config()
    d = cfg.array.element_spacing
    key = jax.random.PRNGKey(7)
    truth = [-1.53, 2.07]     # deliberately off the 0.1-deg grid
    x = simulate_snapshots(key, truth, 16, d, WAVELENGTH, 256,
                           snr_db=20.0, dtype=jnp.complex128)
    est = root_music_1d(x, 2, d, WAVELENGTH)
    np.testing.assert_allclose(est, truth, atol=0.05)


def test_esprit_2d_ura_paired_offgrid():
    """2D TLS-ESPRIT on the 16x8 URA (beyond-reference): search-free,
    automatically PAIRED (az, el) — recovers off-grid truths including two
    sources sharing (nearly) one azimuth, where a naive per-axis pairing
    would scramble."""
    from radar_tpu.doa.superres import esprit_2d

    nx, ny = 16, 8
    truth = np.array([[12.34, 25.71], [12.9, 55.43], [-40.62, 40.2]])
    a = steering_ura(truth[:, 0], truth[:, 1], nx, ny, 0.5)
    g_el = len(truth[:, 1])
    a_src = np.stack([a[:, i * g_el + i] for i in range(len(truth))],
                     axis=1)
    rng = np.random.default_rng(6)
    k, m = 512, len(truth)
    s = (rng.normal(size=(m, k)) + 1j * rng.normal(size=(m, k))) / np.sqrt(2)
    n = (rng.normal(size=(nx * ny, k))
         + 1j * rng.normal(size=(nx * ny, k))) * np.sqrt(0.5) * 0.1
    x = jnp.asarray(a_src @ s + n, jnp.complex128)
    for tls in (True, False):
        got = esprit_2d(x, m, nx, ny, 0.5, tls=tls)
        want = truth[np.argsort(truth[:, 0])]
        np.testing.assert_allclose(got, want, atol=0.15,
                                   err_msg=f"tls={tls}")


def test_esprit_2d_swapped_projection_degeneracy():
    """Two sources with SWAPPED (u, v) projections — az 31/59 deg at one
    elevation, so u1=v2 and v1=u2 — make the eigenvalues of the real sum
    Psi_x + Psi_y coincide (e^{jku}+e^{jkv} is symmetric in u<->v); a
    pairing that diagonalizes only that sum silently mispairs both
    sources by ~10 deg. The complex-combination diagonalizer with a
    residual check must recover both exactly (advisor round-4 finding)."""
    from radar_tpu.doa.superres import esprit_2d

    nx, ny = 16, 8
    truth = np.array([[31.0, 54.3], [59.0, 54.3]])
    a = steering_ura(truth[:, 0], truth[:, 1], nx, ny, 0.5)
    g_el = len(truth[:, 1])
    a_src = np.stack([a[:, i * g_el + i] for i in range(len(truth))],
                     axis=1)
    rng = np.random.default_rng(5)
    k, m = 512, len(truth)
    s = (rng.normal(size=(m, k)) + 1j * rng.normal(size=(m, k))) / np.sqrt(2)
    n = (rng.normal(size=(nx * ny, k))
         + 1j * rng.normal(size=(nx * ny, k))) * np.sqrt(0.5) * 0.1
    x = jnp.asarray(a_src @ s + n, jnp.complex128)
    for tls in (True, False):
        got = esprit_2d(x, m, nx, ny, 0.5, tls=tls)
        np.testing.assert_allclose(got, truth, atol=0.1,
                                   err_msg=f"tls={tls}")


def test_esprit_2d_coherent_sources_with_2d_smoothing():
    """Two COHERENT sources (multipath: the second is a scaled copy of
    the first waveform) rank-collapse the raw URA covariance; 2D
    forward-backward spatial smoothing restores the subspace and
    esprit_2d(smooth=(12, 6)) recovers both (az, el) pairs."""
    from radar_tpu.doa.superres import esprit_2d

    nx, ny = 16, 8
    truth = np.array([[10.5, 30.2], [-25.4, 52.8]])
    a = steering_ura(truth[:, 0], truth[:, 1], nx, ny, 0.5)
    g_el = len(truth[:, 1])
    a_src = np.stack([a[:, i * g_el + i] for i in range(len(truth))],
                     axis=1)
    rng = np.random.default_rng(8)
    k = 512
    s0 = (rng.normal(size=k) + 1j * rng.normal(size=k)) / np.sqrt(2)
    s = np.stack([s0, (0.8 * np.exp(1j * 2.1)) * s0])   # fully coherent
    n = (rng.normal(size=(nx * ny, k))
         + 1j * rng.normal(size=(nx * ny, k))) * np.sqrt(0.5) * 0.05
    x = jnp.asarray(a_src @ s + n, jnp.complex128)

    want = truth[np.argsort(truth[:, 0])]
    raw = esprit_2d(x, 2, nx, ny, 0.5)
    raw_err = np.abs(raw - want).max()
    assert raw_err > 1.0, raw_err   # rank-collapsed: raw estimate breaks

    sm = esprit_2d(x, 2, nx, ny, 0.5, smooth=(12, 6))
    np.testing.assert_allclose(sm, want, atol=0.3)


def test_esprit_2d_rejects_bad_args():
    from radar_tpu.doa.superres import esprit_2d

    x = jnp.asarray(np.random.default_rng(0).normal(size=(128, 32))
                    + 0j)
    with pytest.raises(ValueError, match="bad num_sources"):
        esprit_2d(x, 0, 16, 8)
    with pytest.raises(ValueError, match="URA needs"):
        esprit_2d(x, 2, 8, 8)


def test_superres_robust_at_complex64():
    """Device-resident snapshots are complex64. The
    search-free estimators must stay reliable there: the [C, C] subspace
    tail promotes to host float64 (superres._host_eigvecs_f64) — an f32
    subspace flipped ~2/3 of 128-element smoothed coherent trials
    (duplicated roots). 10/10 trials must land."""
    from radar_tpu.doa.steering import steering_vector
    from radar_tpu.doa.superres import esprit_1d, root_music_1d

    cfg = full_config()
    d, wl = cfg.array.element_spacing, cfg.sig.wavelength
    truth = np.array([-8.3, 4.6])
    a = steering_vector(truth, 128, d, wl)
    rng = np.random.default_rng(1)
    snap = 512
    for t in range(10):
        s0 = rng.normal(size=snap) + 1j * rng.normal(size=snap)
        s = np.stack([s0, 0.7 * np.exp(1j * 1.3) * s0])  # coherent pair
        n = (rng.normal(size=(128, snap))
             + 1j * rng.normal(size=(128, snap))) * np.sqrt(0.5) * 0.3
        x = jnp.asarray(a @ s / np.sqrt(2) + n, jnp.complex64)  # f32!
        np.testing.assert_allclose(
            root_music_1d(x, 2, d, wl, smooth=64), truth, atol=0.1,
            err_msg=f"trial {t}")
        np.testing.assert_allclose(
            esprit_1d(x, 2, d, wl, smooth=64), truth, atol=0.1,
            err_msg=f"trial {t}")


def test_root_music_degenerate_noiseless_covariance():
    """A NOISELESS (rank-deficient) covariance pushes signal roots
    numerically onto/past the unit circle; root selection over conjugate-
    reciprocal pairs by |1-|z|| must still return exactly num_sources
    angles at the truth (an inside-only filter silently returned fewer —
    ADVICE r3)."""
    from radar_tpu.doa.steering import steering_vector
    from radar_tpu.doa.superres import root_music_1d

    cfg = full_config()
    d = cfg.array.element_spacing
    truth = [-10.0, 5.0]
    a = steering_vector(np.asarray(truth), 16, d, WAVELENGTH)
    rng = np.random.default_rng(1)
    k = 64
    s = (rng.normal(size=(2, k)) + 1j * rng.normal(size=(2, k)))
    x = jnp.asarray(a @ s, jnp.complex128)  # zero noise
    est = root_music_1d(x, 2, d, WAVELENGTH)
    assert len(est) == 2
    np.testing.assert_allclose(est, sorted(truth), atol=1e-3)


def test_esprit_matches_truth_and_agrees_with_root_music():
    """TLS- and LS-ESPRIT (beyond-reference, doa/superres.py) recover the
    run_music_algorithm.m close-source scene and agree with root-MUSIC."""
    from radar_tpu.doa.superres import esprit_1d, root_music_1d

    cfg = full_config()
    d = cfg.array.element_spacing
    key = jax.random.PRNGKey(8)
    truth = [-1.5, 2.0]
    x = simulate_snapshots(key, truth, 16, d, WAVELENGTH, 256,
                           snr_db=20.0, dtype=jnp.complex128)
    tls = esprit_1d(x, 2, d, WAVELENGTH, tls=True)
    ls = esprit_1d(x, 2, d, WAVELENGTH, tls=False)
    rm = root_music_1d(x, 2, d, WAVELENGTH)
    np.testing.assert_allclose(tls, truth, atol=0.1)
    np.testing.assert_allclose(ls, truth, atol=0.1)
    np.testing.assert_allclose(tls, rm, atol=0.1)


def test_superres_three_sources_ten_elements():
    """MUSIC_1D.m scene (10-element lambda/2 ULA, 3 sources) through both
    search-free methods."""
    from radar_tpu.doa.superres import esprit_1d, root_music_1d

    d = WAVELENGTH / 2
    key = jax.random.PRNGKey(9)
    truth = [-20.0, 0.0, 15.0]
    x = simulate_snapshots(key, truth, 10, d, WAVELENGTH, 512,
                           snr_db=10.0, dtype=jnp.complex128)
    np.testing.assert_allclose(root_music_1d(x, 3, d, WAVELENGTH), truth,
                               atol=0.3)
    np.testing.assert_allclose(esprit_1d(x, 3, d, WAVELENGTH), truth,
                               atol=0.3)


def test_superres_rejects_bad_source_count():
    from radar_tpu.doa.superres import esprit_1d, root_music_1d

    x = jnp.zeros((4, 8), jnp.complex64)
    for fn in (root_music_1d, esprit_1d):
        for m in (0, 4, 5):
            with pytest.raises(ValueError):
                fn(x, m, 0.0138, WAVELENGTH)


def test_spatial_smoothing_resolves_coherent_sources():
    """COHERENT sources (multipath: one waveform from two angles) rank-
    collapse the raw covariance and break subspace DoA; forward-backward
    spatial smoothing (doa/superres.py::spatial_smooth) restores the rank
    and both search-free methods recover the pair."""
    from radar_tpu.doa.superres import esprit_1d, root_music_1d

    d = WAVELENGTH / 2
    c, k = 16, 256
    truth = [-3.0, 3.0]
    rng = np.random.default_rng(0)
    s = (rng.standard_normal(k) + 1j * rng.standard_normal(k)) / np.sqrt(2)
    a = steering_vector(np.asarray(truth), c, d, WAVELENGTH)  # [C, 2]
    # fully coherent: the second path is the SAME waveform, near-
    # destructively phased (the hard multipath geometry)
    x_clean = np.outer(a[:, 0], s) + np.exp(1j * np.pi * 0.9) * np.outer(
        a[:, 1], s)
    noise = (rng.standard_normal((c, k)) + 1j
             * rng.standard_normal((c, k))) * np.sqrt(0.5) * 10 ** (-30 / 20)
    x = jnp.asarray(x_clean + noise, jnp.complex128)

    # raw covariance: rank-1 signal subspace -> completely wrong answers
    # (probe run: [-45.05, -0.14] deg for the [-3, 3] truth)
    est_raw = root_music_1d(x, 2, d, WAVELENGTH)
    assert np.max(np.abs(est_raw - truth)) > 5.0

    # smoothed: both methods recover the pair to millidegrees
    est_rm = root_music_1d(x, 2, d, WAVELENGTH, smooth=12)
    est_es = esprit_1d(x, 2, d, WAVELENGTH, smooth=12)
    np.testing.assert_allclose(est_rm, truth, atol=0.1)
    np.testing.assert_allclose(est_es, truth, atol=0.1)


def test_superres_128_elements_one_degree_separation():
    """BASELINE config 4 aperture through the search-free methods: at 128
    elements both resolve a 1-degree-separated triple at 5 dB SNR (the
    scene test_music_128_elements_sharded_covariance scans a 0.05-deg
    grid for; here with no grid at all)."""
    from radar_tpu.doa.superres import esprit_1d, root_music_1d

    d = WAVELENGTH / 2
    key = jax.random.PRNGKey(2)
    truth = [-5.0, -4.0, 10.0]
    x = simulate_snapshots(key, truth, 128, d, WAVELENGTH, 512, snr_db=5.0,
                           dtype=jnp.complex128)
    np.testing.assert_allclose(root_music_1d(x, 3, d, WAVELENGTH), truth,
                               atol=0.1)
    np.testing.assert_allclose(esprit_1d(x, 3, d, WAVELENGTH), truth,
                               atol=0.1)
