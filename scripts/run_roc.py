"""CFAR operating curve: Pd AND Pfa vs the threshold factor T — the two
statistical halves of BASELINE's "CFAR Pd at fixed Pfa" on one axis.

The reference fixes T_CFAR=8 (fun_process_single_frame.m:178) and never
measures either quantity; this script sweeps T through the full e2e chain:

- Pd(T): Monte-Carlo trials of a truth target at a fixed raw SNR near the
  detection transition, through the COMPLETE pipeline (synthesis -> ... ->
  clustering) with cfar.threshold_factor=T — detection = any final target
  within the stage-1 cluster gates of the truth.
- Pfa(T): pure-noise frames through the stream pipeline, per-cell
  exceedance counts via ops/cfar_analysis.count_exceedances_2d (one jit,
  T enters as a broadcast vector) + the analytic GOCA expectation.

Writes results/roc.json and roc.png. CPU by default on the small config
(the statistics are config-relative; the full-scale Pfa halves already
live in results/pfa_calibration.json and the full-scale Pd transition in
results/snr_sweep_*_lo.json).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

T_SWEEP = [1.5, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0, 12.0]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--gpu", action="store_true",
                    help="run on the live backend instead of forcing CPU")
    ap.add_argument("--snr", type=float, default=-31.0,
                    help="raw truth SNR in dB for the Pd arm (default "
                         "sits just above the small-config T=8 "
                         "transition at ~-28 dB so lowering T shows the "
                         "Pd/Pfa trade visibly)")
    ap.add_argument("--trials", type=int, default=48)
    ap.add_argument("--noise-frames", type=int, default=24)
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "roc.json"))
    ap.add_argument("--png", default=os.path.join(REPO, "results",
                                                  "roc.png"))
    args = ap.parse_args()
    from radar_tpu.utils.device import setup_compile_cache

    setup_compile_cache()

    import jax
    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from radar_tpu.config.params import small_test_config
    from radar_tpu.ops.cfar import pair_sum_maps
    from radar_tpu.ops.cfar_analysis import (analytic_pfa_goca2d,
                                             count_exceedances_2d)
    from radar_tpu.ops.dbf import dbf
    from radar_tpu.ops.mtd import make_mtd_matrix, mtd_matmul
    from radar_tpu.ops.pulse_compression import (make_matmul_plan,
                                                 pulse_compress_matmul)
    from radar_tpu.pipeline.montecarlo import make_trial_fn
    from radar_tpu.sim.echo import P_NOISE_FLOOR
    from radar_tpu.sim.scenario import TargetBatch
    from radar_tpu.waveform.precompute import precompute

    base = small_test_config(channels=8, pulses=32)
    pre = precompute(base)
    truth = TargetBatch.make([3000.0], [10.0], [10.0], [args.snr])
    key = jax.random.PRNGKey(20260821)

    # ---- Pd(T): full chain per threshold (one compile per T) ----------
    print(f"== Pd at SNR {args.snr:+.0f} dB, {args.trials} trials/T ==",
          flush=True)
    pds = []
    for t in T_SWEEP:
        cfg = base.replace(cfar=dataclasses.replace(
            base.cfar, threshold_factor=float(t)))
        trials_fn = make_trial_fn(cfg, pre)
        keys = jax.random.split(jax.random.fold_in(key, int(10 * t)),
                                args.trials)
        t0 = time.time()
        _, hits = jax.block_until_ready(trials_fn(truth, keys))
        pd = float(np.mean(np.asarray(hits)))
        pds.append(pd)
        print(f"  T={t:5.1f}: Pd={pd:.3f}  ({time.time() - t0:.1f}s)",
              flush=True)

    # ---- Pfa(T): noise-only frames, all T in one jit ------------------
    print(f"== Pfa over {args.noise_frames} pure-noise frames ==",
          flush=True)
    sig = base.sig
    mplan = make_matmul_plan(pre)
    mtd_mat = make_mtd_matrix(pre.mtd_win, sig.prt_num, base.mtd_fft_len)
    dbf_w = np.asarray(pre.dbf_w)
    cube_shape = (sig.prt_num, sig.point_prt, sig.channel_num)
    scale = np.float32(np.sqrt(P_NOISE_FLOOR / 2.0))

    def one_frame(k):
        g = jax.random.normal(k, cube_shape + (2,), jnp.float32)
        noise = jax.lax.complex(g[..., 0], g[..., 1]) * scale
        maps = pair_sum_maps(mtd_matmul(
            pulse_compress_matmul(dbf(noise, dbf_w, base.dbf_variant),
                                  mplan), mtd_mat))
        return count_exceedances_2d(maps, base.cfar, T_SWEEP)

    @jax.jit
    def frames(keys):
        c, n = jax.lax.map(one_frame, keys)
        return jnp.sum(c, axis=0), jnp.sum(n)

    nkeys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.fold_in(key, 999), jnp.arange(args.noise_frames))
    counts, cells = jax.tree.map(np.asarray, frames(nkeys))
    pfas = counts / int(cells)
    for t, c, p in zip(T_SWEEP, counts, pfas):
        print(f"  T={t:5.1f}: Pfa={p:.3e} ({int(c)} hits, analytic "
              f"{analytic_pfa_goca2d(t, base.cfar):.3e})", flush=True)

    report = {
        "device": str(jax.devices()[0].platform),
        "config": "small (8ch x 32p)", "snr_db": args.snr,
        "trials_per_t": args.trials, "noise_cells": int(cells),
        "t_factors": T_SWEEP, "pd": pds,
        "pfa": [float(p) for p in pfas],
        "pfa_hits": [int(c) for c in counts],
        "pfa_analytic_exponential": [analytic_pfa_goca2d(t, base.cfar)
                                     for t in T_SWEEP],
        "note": "operational amplitude-domain cells: the measured Pfa "
                "transition sits at lower T than the square-law analytic "
                "curve (same effect as results/pfa_calibration.json "
                "section 2); reference operating point T=8 "
                "(fun_process_single_frame.m:178)",
    }
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print("wrote", args.out, flush=True)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 9))
    ax1.semilogy(T_SWEEP, np.maximum(pfas, 0.5 / int(cells)), "bo-",
                 label="measured Pfa (floor = 0.5/cells)")
    ax1.semilogy(T_SWEEP, report["pfa_analytic_exponential"], "r--",
                 label="analytic GOCA (square-law cells)")
    ax1.axvline(8.0, color="k", ls=":", label="reference T=8")
    ax1.set_xlabel("threshold factor T")
    ax1.set_ylabel("Pfa per cell")
    ax1.legend()
    ax1.grid(True)
    ax2.plot(T_SWEEP, np.asarray(pds) * 100, "ms-")
    ax2.axvline(8.0, color="k", ls=":")
    ax2.set_xlabel("threshold factor T")
    ax2.set_ylabel(f"Pd (%) at SNR {args.snr:+.0f} dB")
    ax2.set_ylim(-5, 105)
    ax2.grid(True)
    fig.tight_layout()
    fig.savefig(args.png, dpi=110)
    plt.close(fig)
    print("figure:", args.png, flush=True)


if __name__ == "__main__":
    main()
