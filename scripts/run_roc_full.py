"""FULL-SCALE CFAR operating curve on the accelerator: Pd(T) AND Pfa(T) through
the complete 16-channel pipeline in ONE artifact — the single defensible
number behind BASELINE's "CFAR Pd at fixed Pfa" metric.

The reference fixes T_CFAR=8 (fun_process_single_frame.m:178) and measures
Pd only implicitly through the SNR sweep (main_plot_snr_vs_angle_error.m:
284,319-325); it never measures Pfa at all. This script runs both halves at
the full 16ch x 332-pulse frame geometry on the device:

- Pd(T): Monte-Carlo trials of a near-threshold truth target through the
  COMPLETE perf pipeline. One compiled program covers the whole T sweep:
  the expensive T-independent front (rank-K signal RDM + the full noise
  chain + pair-sum maps + the GOCA noise map) runs once per trial, then a
  ``lax.map`` over the TRACED threshold vector runs the cheap tail
  (mask -> extraction -> estimation -> clustering) per T. A trial counts
  as detected only if a FINAL target lands within (gate_r, gate_v) of the
  truth — any-detection counting would inflate Pd with false alarms at
  low T.
- Pfa(T): pure-noise frames through the SAME noise-map machinery
  (the lowrank noise RDM is the complete white-noise -> PC -> MTD -> mix
  chain; the signal adds linearly on top, so noise-only maps are exactly
  the no-target frame), per-cell exceedance counts for all T in one jit
  (ops/cfar_analysis.count_exceedances_2d). Zero-hit thresholds report
  the 95%-confidence upper bound 3/cells (rule of three).

Writes results/roc_full.json (+ .png).

Usage: python scripts/run_roc_full.py [--cpu --small] [--trials 200]
       [--noise-frames 600] [--snr=-40]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

T_SWEEP = [3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 12.0]
T_REF = 8.0          # the reference operating point


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU (smoke runs; artifact runs on the GPU)")
    ap.add_argument("--small", action="store_true",
                    help="small 8ch x 32p config (smoke only)")
    ap.add_argument("--snr", type=float, default=-40.0,
                    help="raw truth SNR dB for the Pd arm (default sits "
                         "in the full-scale T=8 transition, Pd~0.7: "
                         "results/snr_sweep_uniform_lo.json)")
    ap.add_argument("--channels", type=int, default=None,
                    help="use scaled_config(channels, pulses) — the "
                         "BASELINE headline geometry is --channels 64 "
                         "--pulses 256 (synthesized Hamming bank; pair "
                         "with --truth-el=-0.8 --snr=-46, the T=8 "
                         "transition point of snr_sweep_64ch.json)")
    ap.add_argument("--pulses", type=int, default=256)
    ap.add_argument("--truth-el", type=float, default=10.0,
                    help="truth elevation deg (must sit inside the "
                         "config's beam fan; the 64-ch bank spans "
                         "-16..+3.2 deg)")
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--batch", type=int, default=50)
    ap.add_argument("--noise-frames", type=int, default=600)
    ap.add_argument("--noise-batch", type=int, default=100)
    ap.add_argument("--gate-r", type=float, default=60.0)
    ap.add_argument("--gate-v", type=float, default=3.0)
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "roc_full.json"))
    ap.add_argument("--png", default=os.path.join(REPO, "results",
                                                  "roc_full.png"))
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from radar_tpu.utils.device import setup_compile_cache

    setup_compile_cache()
    import jax.numpy as jnp

    from radar_tpu.cluster.stages import cluster_stage1, cluster_stage2
    from radar_tpu.config.params import (full_config, perf_config,
                                         scaled_config, small_test_config)
    from radar_tpu.measure.estimate import estimate_parameters
    from radar_tpu.ops.cfar import (extract_detections, goca_noise_and_valid,
                                    pair_sum_maps)
    from radar_tpu.ops.cfar_analysis import count_exceedances_2d
    from radar_tpu.pipeline.frame import measure_consts
    from radar_tpu.pipeline.lowrank import make_lowrank_stages
    from radar_tpu.sim.scenario import TargetBatch
    from radar_tpu.waveform.precompute import precompute

    if args.small:
        base = small_test_config(channels=8, pulses=32)
    elif args.channels is not None:
        base = scaled_config(channels=args.channels, pulses=args.pulses)
    else:
        base = full_config()
    cfg = perf_config(base)
    pre = precompute(cfg)
    dtype = jnp.complex64
    real_dtype = jnp.finfo(dtype).dtype

    mc = measure_consts(cfg, pre, real_dtype)
    ip = cfg.interp
    lr = make_lowrank_stages(cfg, pre, dtype)

    truth = TargetBatch.make([10000.0], [20.0], [args.truth_el],
                             [args.snr])
    r_true = float(truth.range_m[0])
    v_true = float(truth.velocity_ms[0])
    key = jax.random.PRNGKey(20260821)
    ts_np = np.asarray(T_SWEEP, np.float32)

    # the complete noise chain as one RDM: mix a zero signal (an
    # effectively -inf-dB target) with white noise -> PC -> MTD
    zero_tb = TargetBatch.make([truth.range_m[0]], [truth.velocity_ms[0]],
                               [truth.elevation_deg[0]], [-3000.0])
    zero_tb = jax.tree.map(jnp.asarray, zero_tb)

    def noise_rdm(k):
        return lr.mix_add(lr.signal_rdm(zero_tb),
                          lr.mtd(lr.pc(lr.gen_noise(k))))

    # ---- Pd(T): one compiled program, T traced ------------------------
    def one_trial(echo, k, ts):
        rdm = echo + noise_rdm(k)
        maps = pair_sum_maps(rdm)
        noise, valid = goca_noise_and_valid(maps, cfg.cfar)

        def tail(t):
            mask = (maps > t * noise) & valid
            dets = extract_detections(mask, maps, cfg.cfar.max_detections,
                                      native_scan=cfg.extract_native_scan,
                                      impl=cfg.extract_impl)
            params = estimate_parameters(
                dets, maps, rdm, mc, ip.extra_dots, ip.r_interp_times,
                ip.v_interp_times, monopulse_complex=cfg.monopulse_complex)
            s1 = cluster_stage1(params, cfg.cluster)
            final = cluster_stage2(s1, cfg.cluster)
            # detected = a FINAL target within the match gates of truth
            ok = (final.valid
                  & (jnp.abs(final.range_m - r_true) <= args.gate_r)
                  & (jnp.abs(final.velocity_ms - v_true) <= args.gate_v))
            return jnp.any(ok)

        return jax.lax.map(tail, ts)          # [nT] bool

    @jax.jit
    def pd_batch(targets, keys, ts):
        echo = lr.signal_rdm(targets)          # rank-K, once per batch
        hits = jax.lax.map(lambda k: one_trial(echo, k, ts), keys)
        return jnp.sum(hits.astype(jnp.int32), axis=0)   # [nT]

    print(f"== Pd arm: SNR {args.snr:+.0f} dB, {args.trials} trials x "
          f"{len(T_SWEEP)} thresholds, one compile ==", flush=True)
    tb = jax.tree.map(jnp.asarray, truth)
    t0 = time.time()
    pd_counts = np.zeros(len(T_SWEEP), np.int64)
    done = 0
    while done < args.trials:
        nb = min(args.batch, args.trials - done)
        keys = jax.random.split(jax.random.fold_in(key, done), nb)
        pd_counts += np.asarray(
            jax.block_until_ready(pd_batch(tb, keys, jnp.asarray(ts_np))))
        done += nb
        print(f"  {done}/{args.trials} trials "
              f"({time.time() - t0:.0f}s)", flush=True)
    pds = pd_counts / args.trials
    for t, p in zip(T_SWEEP, pds):
        print(f"  T={t:5.1f}: Pd={p:.3f}", flush=True)

    # ---- Pfa(T): noise-only frames, all T in one jit ------------------
    print(f"== Pfa arm: {args.noise_frames} pure-noise full frames ==",
          flush=True)

    @jax.jit
    def pfa_batch(keys, ts):
        def frame(k):
            maps = pair_sum_maps(noise_rdm(k))
            return count_exceedances_2d(maps, cfg.cfar, ts)

        c, n = jax.lax.map(frame, keys)
        # hit counts are small (int32 ample); the VALID-CELL count is
        # ~13M int32 PER FRAME and identical every frame — summing it
        # across a large batch would wrap int32, so return one frame's
        # value and let the host multiply in int64
        return jnp.sum(c, axis=0), n[0]

    t0 = time.time()
    counts = np.zeros(len(T_SWEEP), np.int64)
    cells = 0
    done = 0
    kn = jax.random.fold_in(key, 777_000)
    while done < args.noise_frames:
        nb = min(args.noise_batch, args.noise_frames - done)
        keys = jax.random.split(jax.random.fold_in(kn, done), nb)
        c, n = jax.tree.map(np.asarray, jax.block_until_ready(
            pfa_batch(keys, jnp.asarray(ts_np))))
        counts += c
        cells += int(n) * nb      # n = one frame's valid cells (constant)
        done += nb
        print(f"  {done}/{args.noise_frames} frames, "
              f"{cells / 1e6:.0f}M cells ({time.time() - t0:.0f}s)",
              flush=True)
    pfa = counts / cells
    # rule of three: 0 hits in N cells -> Pfa <= 3/N at 95% confidence
    pfa_bound = np.where(counts > 0, pfa, 3.0 / cells)
    for t, c, p, b in zip(T_SWEEP, counts, pfa, pfa_bound):
        tag = f"{p:.3e}" if c else f"<= {b:.1e} (0 hits, 95% bound)"
        print(f"  T={t:5.1f}: Pfa={tag}", flush=True)

    from radar_tpu.utils.stats import wilson_ci

    pd_ci = [wilson_ci(int(c), args.trials) for c in pd_counts]
    i8 = T_SWEEP.index(T_REF)
    lo8, hi8 = pd_ci[i8]
    headline = {
        "t": T_REF, "snr_db": args.snr,
        "pd": float(pds[i8]),
        "trials": args.trials,
        "pd_ci95": [lo8, hi8],
        "pfa": float(pfa[i8]) if counts[i8] else None,
        "pfa_95_upper_bound": float(pfa_bound[i8]),
        "statement": (
            f"Pd={pds[i8]:.2f} (95% CI {lo8:.2f}-{hi8:.2f}, "
            f"{args.trials} trials) at Pfa"
            + (f"={pfa[i8]:.2e}" if counts[i8]
               else f"<={pfa_bound[i8]:.1e}")
            + f" (T={T_REF:g}, SNR {args.snr:+.0f} dB, "
              f"{cfg.sig.channel_num}ch x {cfg.sig.prt_num}p, "
              f"{jax.devices()[0].device_kind})"),
    }
    print("HEADLINE:", headline["statement"], flush=True)

    report = {
        "device": jax.devices()[0].device_kind,
        "config": (f"{cfg.sig.channel_num}ch x {cfg.sig.prt_num}p "
                   + ("small" if args.small
                      else "scaled" if args.channels is not None
                      else "FULL")
                   + " perf(XLA lowrank)"),
        "truth_elevation_deg": args.truth_el,
        "pipeline": "complete: synthesis -> noise chain -> maps -> GOCA "
                    "CFAR -> extraction -> estimation -> clustering; "
                    "detection gated to truth "
                    f"(dR<={args.gate_r} m, dV<={args.gate_v} m/s)",
        "snr_db": args.snr, "trials_per_t": args.trials,
        "noise_frames": args.noise_frames, "noise_cells": int(cells),
        "t_factors": T_SWEEP,
        "pd": [float(p) for p in pds],
        "pd_hits": [int(c) for c in pd_counts],
        "pd_ci95": [[lo, hi] for lo, hi in pd_ci],
        "pfa": [float(p) for p in pfa],
        "pfa_hits": [int(c) for c in counts],
        "pfa_95_upper_bound": [float(b) for b in pfa_bound],
        "headline": headline,
        "method": "ONE compiled Pd program (T traced, lax.map tail per "
                  "threshold; expensive front runs once per trial); Pfa "
                  "via count_exceedances_2d on noise-only frames of the "
                  "same map machinery",
        "ref": "T_CFAR=8 operating point fun_process_single_frame.m:178; "
               "Pd machinery main_plot_snr_vs_angle_error.m:284,319-325",
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print("wrote", args.out, flush=True)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 9))
    ax1.semilogy(T_SWEEP, np.maximum(pfa, 0.5 / cells), "bo-",
                 label="measured Pfa")
    ax1.semilogy(T_SWEEP, pfa_bound, "c--", label="95% upper bound")
    ax1.axvline(T_REF, color="k", ls=":", label=f"reference T={T_REF:g}")
    ax1.set_xlabel("threshold factor T")
    ax1.set_ylabel("Pfa per cell")
    ax1.legend()
    ax1.grid(True)
    ax2.plot(T_SWEEP, np.asarray(pds) * 100, "ms-")
    ax2.axvline(T_REF, color="k", ls=":")
    ax2.set_xlabel("threshold factor T")
    ax2.set_ylabel(f"Pd (%) at SNR {args.snr:+.0f} dB (truth-gated)")
    ax2.set_ylim(-5, 105)
    ax2.grid(True)
    fig.suptitle(headline["statement"], fontsize=9)
    fig.tight_layout()
    fig.savefig(args.png, dpi=110)
    plt.close(fig)
    print("figure:", args.png, flush=True)


if __name__ == "__main__":
    main()
