"""Monte-Carlo SNR sweep driver — the framework's equivalent of the
reference's ``main_plot_snr_vs_angle_error.m``: monopulse angle-error sigma
and Pd vs SNR with the analytic |k|*sqrt(2)/sqrt(SNR) bound.

Usage:
  python scripts/run_snr_sweep.py [--trials 100] [--cpu] [--small]
         [--out sweep.png]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=100)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--channels", type=int, default=None,
                    help="use scaled_config(channels, pulses) — BASELINE "
                         "config 3 is --channels 64 --pulses 256 (the "
                         "synthesized Hamming bank + self-calibrated K "
                         "slopes, config/assets.py)")
    ap.add_argument("--pulses", type=int, default=256)
    ap.add_argument("--fused", action="store_true",
                    help="fused synth+DBF beam-space path "
                         "(cfg.fused_synth_dbf)")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 planes for the MTD/PC matmuls")
    ap.add_argument("--lowrank", action="store_true",
                    help="rank-K signal RDM + post-MTD noise mixing")
    ap.add_argument("--rbg", action="store_true",
                    help="rbg PRNG family for the noise draws")
    ap.add_argument("--dp", type=int, default=None,
                    help="shard each trial batch over a dp mesh of this "
                         "many devices (parallel/dp.py; trials and batch "
                         "must divide by it)")
    ap.add_argument("--batch", type=int, default=16,
                    help="trial batch size per sweep point")
    ap.add_argument("--truth-el", type=float, default=None,
                    help="truth elevation in deg (default: the harness "
                         "default 10 deg — only valid inside the beam "
                         "bank; the 64-ch synthesized bank spans "
                         "-16..+3.2 deg, so BASELINE config 3 should use "
                         "an in-bank pair crossover, e.g. -0.8)")
    ap.add_argument("--truth-range", type=float, default=10000.0,
                    help="truth range in m (reference: 10 km)")
    ap.add_argument("--out", default="snr_sweep.png")
    ap.add_argument("--json", default=None,
                    help="also write the sweep arrays to this JSON path")
    ap.add_argument("--snr", default="-10:2:30",
                    help="start:step:stop in dB (MATLAB colon syntax); "
                         "use --snr=-10:2:30 form for negative starts")
    args = ap.parse_args()
    from radar_tpu.utils.device import setup_compile_cache

    setup_compile_cache()

    if args.cpu:
        if args.dp and args.dp > 1:
            # virtual CPU devices for the dp mesh (must precede backend init)
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={args.dp}")
        import jax

        jax.config.update("jax_platforms", "cpu")

    from radar_tpu.config.params import full_config, small_test_config
    from radar_tpu.pipeline.montecarlo import snr_sweep
    from radar_tpu.viz.plots import plot_snr_sweep

    start, step, stop = (float(x) for x in args.snr.split(":"))
    snr_vec = np.arange(start, stop + 1e-9, step)
    from radar_tpu.config.params import scaled_config

    if args.channels is not None:
        cfg = scaled_config(channels=args.channels, pulses=args.pulses)
    else:
        cfg = small_test_config() if args.small else full_config()
    if args.fused:
        cfg = cfg.replace(fused_synth_dbf=True)
    if args.bf16:
        cfg = cfg.replace(matmul_precision="bf16")
    if args.lowrank:
        cfg = cfg.replace(fused_synth_dbf=True, lowrank_rdm=True)
    if args.rbg:
        cfg = cfg.replace(noise_prng="rbg")

    truth = None
    if args.truth_el is not None:
        from radar_tpu.sim.scenario import TargetBatch

        truth = TargetBatch.make([args.truth_range], [20.0],
                                 [args.truth_el], [0.0])
    mesh = None
    if args.dp is not None:
        from radar_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(dp=args.dp)
    t0 = time.time()
    res = snr_sweep(cfg, snr_db_vector=snr_vec, num_trials=args.trials,
                    truth=truth, progress=True, mesh=mesh,
                    batch_size=args.batch)
    print(f"\nsweep done in {time.time() - t0:.1f}s")
    for i, s in enumerate(res.snr_db):
        print(f"  SNR {s:+6.1f} dB: Pd={res.detection_probability[i]:5.2f} "
              f"sigma={res.angle_error_std[i]:8.4f} deg "
              f"(bound {res.theory_bound[i]:.4f})")
    if args.json:
        import json

        import jax

        # the reference bound |k|*sqrt(2)/sqrt(SNR_raw) (main_plot_snr_vs_
        # angle_error.m:303-309) is vacuous at the scaled geometries'
        # raw-SNR operating points (hundreds of degrees at -50 dB); for
        # those, ALSO quote the bound at the post-integration SNR the
        # monopulse ratio actually sees: raw SNR x DBF array gain x PC
        # pulse-compression gain x MTD coherent-integration gain, each
        # with its window's taper efficiency (sum w)^2 / (N sum w^2).
        bound_fields = {"theory_bound_deg": [float(x)
                                             for x in res.theory_bound]}
        if args.channels is not None:
            from radar_tpu.waveform.precompute import precompute

            pre = precompute(cfg)

            def eff(w):
                w = np.abs(np.asarray(w)).astype(float)
                return float(w.sum() ** 2 / (len(w) * (w * w).sum()))

            g_dbf = cfg.sig.channel_num * float(np.mean(
                [eff(row) for row in pre.dbf_w]))
            g_pc = len(pre.mf_long_win) * eff(pre.mf_long_win)
            g_mtd = cfg.sig.prt_num * eff(pre.mtd_win)
            gain = g_dbf * g_pc * g_mtd
            snr_lin = 10.0 ** (np.asarray(res.snr_db, float) / 10.0)
            kabs = float(res.theory_bound[0] * np.sqrt(snr_lin[0])
                         / np.sqrt(2.0))
            bound_fields = {
                "theory_bound_raw_snr_deg":
                    [float(x) for x in res.theory_bound],
                "theory_bound_post_gain_deg":
                    [float(kabs * np.sqrt(2.0) / np.sqrt(s * gain))
                     for s in snr_lin],
                "integration_gain_db": round(10 * np.log10(gain), 2),
                "bound_note": (
                    "raw-SNR bound is the reference's form and is "
                    "vacuous at these raw operating points; the post-"
                    "gain bound evaluates it at raw SNR + "
                    f"{10 * np.log10(gain):.1f} dB (DBF x long-pulse PC "
                    "x MTD, taper efficiencies included)"),
            }
        with open(args.json, "w") as fh:
            json.dump({
                "config": (f"scaled {args.channels}ch x {args.pulses}p"
                           if args.channels is not None
                           else "small" if args.small else "full"),
                "pipeline": {"fused": bool(cfg.fused_synth_dbf),
                             "lowrank": bool(cfg.lowrank_rdm),
                             "bf16": cfg.matmul_precision == "bf16",
                             "rbg": cfg.noise_prng == "rbg"},
                "snr_db": [float(x) for x in res.snr_db],
                "angle_error_std_deg": [float(x)
                                        for x in res.angle_error_std],
                "detection_probability": [float(x) for x in
                                          res.detection_probability],
                **bound_fields,
                "trials": args.trials,
                "truth": {"range_m": args.truth_range,
                          "elevation_deg": (args.truth_el
                                            if args.truth_el is not None
                                            else 10.0),
                          "velocity_ms": 20.0},
                "device": jax.devices()[0].device_kind,
            }, fh, indent=1)
        print("json:", args.json)
    print("figure:", plot_snr_sweep(res, args.out))


if __name__ == "__main__":
    main()
