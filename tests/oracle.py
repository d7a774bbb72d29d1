"""NumPy/SciPy float64 oracle for the radar chain.

An independent, loop/stride-based implementation of each stage's semantics
(as specified by the reference MATLAB, SURVEY.md section 2.1), used as the
golden model for the jitted ops — the formalization of the reference's
stage-by-stage debug-harness idiom (SURVEY.md section 4.2).
"""

from __future__ import annotations

import numpy as np
import scipy.signal

from radar_tpu.config.params import RadarConfig
from radar_tpu.waveform.precompute import Precomputed


def echo_oracle(r, v, el, snr_db, precomp: Precomputed, cfg: RadarConfig
                ) -> np.ndarray:
    """Raw IQ cube [P, S, C] for a list of targets, no noise."""
    sig = cfg.sig
    n_p, n_s, n_c = sig.prt_num, sig.point_prt, sig.channel_num
    out = np.zeros((n_p, n_s, n_c), dtype=np.complex128)
    for k in range(len(r)):
        delay_samples = round(2 * r[k] / sig.c * sig.fs)
        base = np.zeros(n_s, dtype=np.complex128)
        if 0 < delay_samples < n_s:
            ln = min(n_s, n_s - delay_samples)
            base[delay_samples:delay_samples + ln] = precomp.tx_pulse[:ln]
        fd = 2 * v[k] / sig.wavelength
        amp = np.sqrt(10 ** (snr_db[k] / 10) / precomp.p_signal_unscaled)
        dphi = 2 * np.pi * cfg.array.element_spacing * np.sin(
            np.deg2rad(el[k])) / sig.wavelength
        for m in range(n_p):
            dop = np.exp(1j * 2 * np.pi * fd * m * sig.prt)
            ch = np.exp(1j * np.arange(n_c) * dphi)
            out[m] += amp * np.outer(base * dop, ch)
    return out


def dbf_oracle(iq: np.ndarray, w: np.ndarray, variant: str = "v8"
               ) -> np.ndarray:
    n_p = iq.shape[0]
    n_b = w.shape[0]
    out = np.zeros((n_p, iq.shape[1], n_b), dtype=np.complex128)
    for p in range(n_p):
        if variant == "v8":
            out[p] = iq[p] @ w.conj().T
        else:
            out[p] = iq[p] @ np.fliplr(w).T
    return out


def pc_oracle(beams: np.ndarray, precomp: Precomputed) -> np.ndarray:
    """Segmented pulse compression with the reference's full-segment FFT
    sizes (v8_3:158-161, fun_process_single_frame.m:99-127)."""
    n_p, n_s, n_b = beams.shape
    g1, g2, g3 = precomp.gate_splits
    n_total = precomp.n_total_gate
    out = np.zeros((n_p, n_total, n_b), dtype=np.complex128)
    for b in range(n_b):
        x = beams[:, :, b]
        seg_n = x[:, precomp.seg_start_narrow:]
        seg_m = x[:, precomp.seg_start_medium:]
        seg_l = x[:, precomp.seg_start_long:]
        # narrow: causal FIR along fast time, then advance by group delay
        # (circshift wrap harmless: wrapped cells fall outside gates [0,g1))
        yn = scipy.signal.lfilter(precomp.mf_narrow, [1.0], seg_n, axis=1)
        yn = np.roll(yn, -precomp.fir_delay, axis=1)
        # medium/long: frequency-domain fast convolution
        ym = np.fft.ifft(np.fft.fft(seg_m, precomp.n_fft_med, axis=1)
                         * np.fft.fft(precomp.mf_medium_win,
                                      precomp.n_fft_med),
                         axis=1)
        yl = np.fft.ifft(np.fft.fft(seg_l, precomp.n_fft_long, axis=1)
                         * np.fft.fft(precomp.mf_long_win,
                                      precomp.n_fft_long),
                         axis=1)
        out[:, :g1, b] = yn[:, :g1]
        out[:, g1:g1 + g2, b] = ym[:, g1:g1 + g2]
        out[:, g1 + g2:n_total, b] = yl[:, g1 + g2:n_total]
    return out


def mtd_oracle(pc: np.ndarray, win: np.ndarray,
               fft_len: int | None = None) -> np.ndarray:
    x = pc * win[:, None, None]
    return np.fft.fftshift(np.fft.fft(x, n=fft_len, axis=0), axes=0)


def goca_cfar_oracle(maps: np.ndarray, ref_r, guard_r, ref_v, guard_v, t_cfar,
                     method: str = "GOCA") -> np.ndarray:
    """Per-cell loop CFAR (use only on small maps)."""
    comb = {"GOCA": max, "SOCA": min, "CA": lambda a, b: 0.5 * (a + b)}[method]
    num_v, num_r, n_pairs = maps.shape
    mask = np.zeros_like(maps, dtype=bool)
    for p in range(n_pairs):
        m = maps[:, :, p]
        for r in range(ref_r + guard_r, num_r - ref_r - guard_r):
            for v in range(ref_v + guard_v, num_v - ref_v - guard_v):
                lead_r = m[v, r - guard_r - ref_r: r - guard_r].mean()
                trail_r = m[v, r + guard_r + 1: r + guard_r + ref_r + 1].mean()
                lead_v = m[v - guard_v - ref_v: v - guard_v, r].mean()
                trail_v = m[v + guard_v + 1: v + guard_v + ref_v + 1, r].mean()
                noise = max(comb(lead_r, trail_r), comb(lead_v, trail_v))
                if m[v, r] > t_cfar * noise:
                    mask[v, r, p] = True
    return mask


def goca_cfar_ratio_oracle(maps: np.ndarray, ref_r, guard_r, ref_v, guard_v,
                           t_cfar, method: str = "GOCA"
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized :func:`goca_cfar_oracle` (same window sums in the same
    order, so the same mask) for full-size maps. Returns ``(mask, stat)``
    where ``stat = cell / (t_cfar * noise)`` on the interior cells (a cell
    is a detection iff stat > 1) and NaN on the border cells the reference
    never tests."""
    comb = {"GOCA": np.maximum, "SOCA": np.minimum,
            "CA": lambda a, b: 0.5 * (a + b)}[method]
    num_v, num_r, _ = maps.shape
    hr, hv = ref_r + guard_r, ref_v + guard_v
    iv, ir = slice(hv, num_v - hv), slice(hr, num_r - hr)
    cell = maps[iv, ir]

    def window_mean(offsets, axis):
        acc = 0.0
        for o in offsets:
            if axis == 1:
                acc = acc + maps[iv, hr + o:num_r - hr + o]
            else:
                acc = acc + maps[hv + o:num_v - hv + o, ir]
        return acc / len(offsets)

    lead_r = window_mean(range(-guard_r - ref_r, -guard_r), 1)
    trail_r = window_mean(range(guard_r + 1, guard_r + ref_r + 1), 1)
    lead_v = window_mean(range(-guard_v - ref_v, -guard_v), 0)
    trail_v = window_mean(range(guard_v + 1, guard_v + ref_v + 1), 0)
    noise = np.maximum(comb(lead_r, trail_r), comb(lead_v, trail_v))
    mask = np.zeros(maps.shape, bool)
    stat = np.full(maps.shape, np.nan)
    mask[iv, ir] = cell > t_cfar * noise
    with np.errstate(divide="ignore", invalid="ignore"):
        stat[iv, ir] = cell / (t_cfar * noise)
    return mask, stat


def spline_interp_oracle(y: np.ndarray, times: int) -> np.ndarray:
    """MATLAB interp1(0:n-1, y, 0:1/times:n-1, 'spline')."""
    from scipy.interpolate import CubicSpline

    n = len(y)
    cs = CubicSpline(np.arange(n), y, bc_type="not-a-knot")
    return cs(np.arange((n - 1) * times + 1) / times)


def cluster_bfs_oracle(fields_gates: list[tuple[np.ndarray, float]]
                       ) -> np.ndarray:
    """BFS connected components over gate adjacency; returns component ids."""
    n = len(fields_gates[0][0])
    adj = np.ones((n, n), dtype=bool)
    for f, g in fields_gates:
        adj &= np.abs(f[:, None] - f[None, :]) <= g
    comp = -np.ones(n, dtype=int)
    cid = 0
    for i in range(n):
        if comp[i] >= 0:
            continue
        stack = [i]
        comp[i] = cid
        while stack:
            u = stack.pop()
            for j in np.nonzero(adj[u] & (comp < 0))[0]:
                comp[j] = cid
                stack.append(j)
        cid += 1
    return comp
