"""Vectorized NumPy/SciPy single-frame reference chain.

The reference publishes no benchmark numbers (BASELINE.md), so the bench's
``vs_baseline`` compares the device pipeline against this faithful CPU
implementation of the same processing chain (echo synthesis -> DBF -> PC ->
MTD -> CFAR -> measurement), vectorized the way a tuned MATLAB implementation
would be. Detection post-processing beyond the CFAR mask is excluded on both
sides of the ratio: both sides run the chain through CFAR detection extraction
(clustering/measurement costs are negligible at realistic detection counts).
"""

from __future__ import annotations

import numpy as np
import scipy.signal

from ..config.params import RadarConfig
from ..waveform.precompute import Precomputed


def frame_baseline_np(rng: np.random.Generator, targets, precomp: Precomputed,
                      cfg: RadarConfig) -> tuple[np.ndarray, int]:
    """One full frame in float64 numpy; returns (detection rows, count)."""
    sig = cfg.sig
    n_p, n_s, n_c = sig.prt_num, sig.point_prt, sig.channel_num

    # echo synthesis (vectorized over pulses/channels per target)
    cube = np.zeros((n_p, n_s, n_c), dtype=np.complex128)
    for k in range(targets.num_targets):
        delay = round(2 * targets.range_m[k] / sig.c * sig.fs)
        base = np.zeros(n_s, np.complex128)
        if 0 < delay < n_s:
            base[delay:] = precomp.tx_pulse[:n_s - delay]
        fd = 2 * targets.velocity_ms[k] / sig.wavelength
        dop = np.exp(1j * 2 * np.pi * fd * np.arange(n_p) * sig.prt)
        amp = np.sqrt(10 ** (targets.snr_db[k] / 10)
                      / precomp.p_signal_unscaled)
        dphi = (2 * np.pi * cfg.array.element_spacing
                * np.sin(np.deg2rad(targets.elevation_deg[k]))
                / sig.wavelength)
        steer = np.exp(1j * np.arange(n_c) * dphi)
        cube += amp * dop[:, None, None] * base[None, :, None] \
            * steer[None, None, :]
    cube += (rng.standard_normal(cube.shape)
             + 1j * rng.standard_normal(cube.shape)) * np.sqrt(0.5)

    # DBF
    beams = np.einsum("psc,bc->psb", cube, np.conj(precomp.dbf_w))

    # segmented PC (reference FFT sizes)
    g1, g2, _ = precomp.gate_splits
    n_total = precomp.n_total_gate
    pc = np.empty((n_p, n_total, beams.shape[2]), np.complex128)
    seg_n = beams[:, precomp.seg_start_narrow:, :]
    yn = scipy.signal.lfilter(precomp.mf_narrow, [1.0], seg_n, axis=1)
    pc[:, :g1] = np.roll(yn, -precomp.fir_delay, axis=1)[:, :g1]
    seg_m = beams[:, precomp.seg_start_medium:, :]
    ym = np.fft.ifft(np.fft.fft(seg_m, precomp.n_fft_med, axis=1)
                     * np.fft.fft(precomp.mf_medium_win,
                                  precomp.n_fft_med)[None, :, None], axis=1)
    pc[:, g1:g1 + g2] = ym[:, g1:g1 + g2]
    seg_l = beams[:, precomp.seg_start_long:, :]
    yl = np.fft.ifft(np.fft.fft(seg_l, precomp.n_fft_long, axis=1)
                     * np.fft.fft(precomp.mf_long_win,
                                  precomp.n_fft_long)[None, :, None], axis=1)
    pc[:, g1 + g2:] = yl[:, g1 + g2:n_total]

    # MTD
    rdm = np.fft.fftshift(
        np.fft.fft(pc * precomp.mtd_win[:, None, None], axis=0), axes=0)

    # CFAR (vectorized shifted-window means)
    mag = np.abs(rdm)
    maps = mag[:, :, :-1] + mag[:, :, 1:]
    p = cfg.cfar

    def shifted(x, k, axis):
        y = np.zeros_like(x)
        src = [slice(None)] * x.ndim
        dst = [slice(None)] * x.ndim
        if k > 0:
            src[axis] = slice(0, x.shape[axis] - k)
            dst[axis] = slice(k, None)
        else:
            src[axis] = slice(-k, None)
            dst[axis] = slice(0, x.shape[axis] + k)
        y[tuple(dst)] = x[tuple(src)]
        return y

    def lead_trail(x, guard, ref, axis):
        lead = np.zeros_like(x)
        trail = np.zeros_like(x)
        for k in range(guard + 1, guard + ref + 1):
            lead += shifted(x, k, axis)
            trail += shifted(x, -k, axis)
        return lead / ref, trail / ref

    lr, tr = lead_trail(maps, p.guard_cells_r, p.ref_cells_r, 1)
    lv, tv = lead_trail(maps, p.guard_cells_v, p.ref_cells_v, 0)
    noise = np.maximum(np.maximum(lr, tr), np.maximum(lv, tv))
    num_v, num_r = maps.shape[:2]
    br = p.ref_cells_r + p.guard_cells_r
    bv = p.ref_cells_v + p.guard_cells_v
    valid = np.zeros_like(maps, bool)
    valid[bv:num_v - bv, br:num_r - br, :] = True
    mask = (maps > p.threshold_factor * noise) & valid
    v_idx, r_idx, pair = np.nonzero(mask)
    rows = np.stack([v_idx, r_idx, pair, maps[v_idx, r_idx, pair]], axis=1)
    return rows, len(rows)
