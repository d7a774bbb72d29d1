"""A/B accuracy measurement of the refined-index monopulse variant
(cfg.monopulse_refined) against the reference's integer-index evaluation —
the documented flaw kept as default ("known flaw",
fun_process_single_frame.m:280-281): the monopulse ratio reads the two
member-beam RDM values at the INTEGER (v_idx, r_idx) while the reported
range/velocity are refined to subcell positions. The variant (SURVEY.md
section 7.1, "optionally at refined indices") evaluates each beam's
spline surface at the refined peak instead.

Runs the Monte-Carlo sweep harness (the reference's own acceptance
machinery, main_plot_snr_vs_angle_error.m) at a few SNRs with IDENTICAL
seeds for both variants and reports the sigma(angle) delta.

Usage: python scripts/run_monopulse_ab.py [--cpu --small]
       [--snrs=-38,-32,-26] [--trials 200]
Artifact: results/monopulse_refined_ab.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--snrs", default="-38,-32,-26",
                    help="comma-separated SNR dB points (full-scale "
                         "detectable band is about -40 dB and up)")
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--batch", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from radar_tpu.utils.device import setup_compile_cache

    setup_compile_cache()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from radar_tpu.config.params import (full_config, perf_config,
                                         small_test_config)
    from radar_tpu.pipeline.montecarlo import snr_sweep
    from radar_tpu.waveform.precompute import precompute

    base = small_test_config(channels=8, pulses=32) if args.small \
        else full_config()
    cfg_int = perf_config(base)
    cfg_ref = cfg_int.replace(monopulse_refined=True)
    pre = precompute(cfg_int)
    snrs = np.asarray([float(s) for s in args.snrs.split(",")])

    rows = []
    for name, cfg in (("integer_flaw", cfg_int), ("refined", cfg_ref)):
        t0 = time.time()
        # precompute is independent of the monopulse flag — share one
        # (the full-config precompute costs minutes on this host)
        res = snr_sweep(cfg, snr_db_vector=snrs, num_trials=args.trials,
                        seed=7, batch_size=args.batch, precomp=pre)
        print(f"{name}: {time.time() - t0:.0f}s")
        for s, sd, pd in zip(res.snr_db, res.angle_error_std,
                             res.detection_probability):
            print(f"  SNR {s:+6.1f}: sigma={sd:.4f} deg Pd={pd:.2f}")
            rows.append({"variant": name, "snr_db": float(s),
                         "sigma_deg": float(sd), "pd": float(pd)})

    # pairwise deltas at each SNR
    deltas = []
    for s in snrs:
        si = next(r for r in rows if r["variant"] == "integer_flaw"
                  and r["snr_db"] == s)
        sr = next(r for r in rows if r["variant"] == "refined"
                  and r["snr_db"] == s)
        deltas.append({
            "snr_db": float(s),
            "sigma_integer_deg": si["sigma_deg"],
            "sigma_refined_deg": sr["sigma_deg"],
            "ratio_refined_over_integer":
                round(sr["sigma_deg"] / si["sigma_deg"], 4)
                if si["sigma_deg"] else None,
        })
        print(f"SNR {s:+.0f}: sigma integer {si['sigma_deg']:.4f} vs "
              f"refined {sr['sigma_deg']:.4f} "
              f"({deltas[-1]['ratio_refined_over_integer']}x)")

    out = args.out or (os.path.join("results", "monopulse_refined_ab.json")
                       if not (args.small or args.cpu)
                       else "/tmp/monopulse_refined_ab.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump({
            "what": ("A/B: monopulse ratio at integer indices (reference "
                     "flaw, fun_process_single_frame.m:280-281, shipped "
                     "default) vs at the spline-refined subcell peak "
                     "(cfg.monopulse_refined) — identical seeds, sweep "
                     "harness of main_plot_snr_vs_angle_error.m"),
            "device": jax.devices()[0].device_kind,
            "config": f"{cfg_int.sig.channel_num}ch x "
                      f"{cfg_int.sig.prt_num}p",
            "trials_per_point": args.trials,
            "rows": rows,
            "deltas": deltas,
        }, f, indent=1)
    print("wrote", out)


if __name__ == "__main__":
    main()
