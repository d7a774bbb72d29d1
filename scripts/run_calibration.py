"""Offline calibration CLI — the framework's equivalent of the reference's
L7 tool scripts (`plot_beam_patterns.m`, `calibrate_all_monopulse_slopes.m`):
evaluate the measured DBF bank's beam patterns, extract the pointing angles,
calibrate the monopulse K-slope LUT, and print both in paste-ready form (the
reference prints the LUT for manual paste into the drivers,
calibrate_all_monopulse_slopes.m:84-90 — here the same values feed
waveform/precompute automatically; this tool is for inspection/re-derivation).

Usage:
  python scripts/run_calibration.py [--cpu] [--fc-mhz 9450]
         [--out patterns.png] [--channels 16]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--fc-mhz", type=float, default=None,
                    help="evaluate patterns at this carrier (the reference "
                         "plot script's quirk uses 9500 vs the system's "
                         "9450 MHz, plot_beam_patterns.m:20)")
    ap.add_argument("--channels", type=int, default=16,
                    help="16 = measured CSV bank; other values synthesize "
                         "a bank (8/64/128-ch configs)")
    ap.add_argument("--out", default="beam_patterns.png")
    ap.add_argument("--reference-quirks", action="store_true",
                    help="quirk-faithful plot_beam_patterns.m procedure "
                         "(fliplr'd weights, fc=9500 MHz, 1-based element "
                         "indices, no conj) — reproduces the pasted "
                         "beam_angles_deg LUT exactly")
    ap.add_argument("--procedure", choices=("self-consistent", "reference"),
                    default="self-consistent",
                    help="'self-consistent' = magnitude-ratio calibration "
                         "matching how the pipeline applies K; 'reference' "
                         "= calibrate_all_monopulse_slopes.m procedure "
                         "(complex ratio, fliplr, +/-separation scan)")
    args = ap.parse_args()
    from radar_tpu.utils.device import setup_compile_cache

    setup_compile_cache()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from radar_tpu.config.params import RadarConfig, SigConfig, ArrayConfig
    from radar_tpu.doa.calibrate import (beam_patterns,
                                         beam_patterns_reference,
                                         calibrate_k_slopes)
    from radar_tpu.viz.plots import plot_beam_patterns_fig
    from radar_tpu.waveform.precompute import precompute

    sig = SigConfig(channel_num=args.channels,
                    beam_num=13 if args.channels >= 16
                    else args.channels - 3)
    cfg = RadarConfig(sig=sig, array=ArrayConfig(num_elements=args.channels))
    pre = precompute(cfg)
    wavelength = (sig.c / (args.fc_mhz * 1e6) if args.fc_mhz
                  else sig.wavelength)

    if args.reference_quirks:
        scan, resp, peaks = beam_patterns_reference(
            np.asarray(pre.dbf_w), cfg.array.element_spacing)
    else:
        scan, resp, peaks = beam_patterns(np.asarray(pre.dbf_w),
                                          cfg.array.element_spacing,
                                          sig.wavelength,
                                          wavelength_override=wavelength)
    if args.procedure == "reference":
        # calibrate_all_monopulse_slopes.m: fliplr'd weights, complex field
        # ratio, scan = crossover +/- separation (see calibrate.py NB on the
        # reference's own LUT not matching this procedure's output)
        w_cal = np.fliplr(np.asarray(pre.dbf_w))
        ks = calibrate_k_slopes(w_cal, np.asarray(pre.beam_angles_deg),
                                cfg.array.element_spacing, wavelength,
                                ratio="complex", span_factor=1.0)
    else:
        ks = calibrate_k_slopes(np.asarray(pre.dbf_w), peaks,
                                cfg.array.element_spacing, wavelength)

    print(f"beams: {len(peaks)}  channels: {args.channels}  "
          f"fc: {wavelength and sig.c / wavelength / 1e6:.0f} MHz")
    print("beam_angles_deg = ["
          + " ".join(f"{a:.1f}" for a in peaks) + "]")
    print("k_slopes_LUT   = ["
          + " ".join(f"{k:.4f}" for k in ks) + "]")
    # crossover depth check (adjacent-beam pattern intersection level)
    for p in range(len(peaks) - 1):
        mid = 0.5 * (peaks[p] + peaks[p + 1])
        i = int(np.argmin(np.abs(scan - mid)))
        lvl = 20 * np.log10(resp[p, i] / resp[p].max() + 1e-300)
        print(f"pair {p:2d}: crossover {mid:7.2f} deg  depth {lvl:6.2f} dB  "
              f"K={ks[p]:8.4f}")
    print("figure:", plot_beam_patterns_fig(
        pre.dbf_w, cfg.array.element_spacing, sig.wavelength, args.out))


if __name__ == "__main__":
    main()
