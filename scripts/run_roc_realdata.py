"""Operating curve for the SECOND detector family: the real-data path's
segmented 1D CA-GO CFAR (ops/cfar1d.py) — Pd(T) and Pfa(T) through the
staged pipeline (DBF -> stage2 PC+MTD -> stage3 segmented CFAR) in one
artifact, the companion of results/roc_full.json for the sim path's 2D
GOCA detector.

The reference's real-data adapter fixes T_CFAR (Function_CFAR1D_sub,
debug_simulated_data_processing_v2.m:467-511 inline copy) and never
measures either quantity. Here:

- Pd(T): Monte-Carlo injections of a fixed target echo (gate 1500, long
  segment; 12 m/s; 12-deg physical elevation — the
  tests/test_realdata.py scene) into white gated IQ at a near-threshold
  amplitude, through DBF + stage2; ONE compiled program sweeps the
  traced threshold vector over the cheap CFAR tail. Detection = any
  CFAR flag inside a +-3-gate x +-2-bin window of the truth cell (the
  detector's own output, before extraction capacity).
- Pfa(T): noise-only frames, operational flag counts per T over the
  valid (non-clutter-band) cells, one jit.

Writes results/roc_realdata.json; --cpu for smoke.
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
T_REF = 8.0


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--amp", type=float, default=0.018,
                    help="per-sample echo amplitude vs unit-power channel "
                         "noise (default sits in the T=8 transition: "
                         "Pd 0.04/0.71/0.96 at amp 0.014/0.018/0.022 — "
                         "~60 dB of PC+MTD+DBF integration gain above it)")
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--batch", type=int, default=50)
    ap.add_argument("--noise-frames", type=int, default=400)
    ap.add_argument("--noise-batch", type=int, default=100)
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "roc_realdata.json"))
    ap.add_argument("--png", default=os.path.join(REPO, "results",
                                                  "roc_realdata.png"))
    args = ap.parse_args()
    from radar_tpu.utils.device import setup_compile_cache

    setup_compile_cache()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from radar_tpu.config import assets
    from radar_tpu.config.params import RadarConfig, SigConfig
    from radar_tpu.ops.cfar1d import segmented_cfar_1d
    from radar_tpu.ops.dbf import dbf
    from radar_tpu.pipeline.stages import (_delta_v_bin, _segment_pulses,
                                           stage2_mtd)

    sig = SigConfig(prt_num=64, channel_num=16, beam_num=13)
    cfg = RadarConfig(sig=sig)
    n_p, n_g, n_c = sig.prt_num, sig.n_total_gate, sig.channel_num
    dvb = _delta_v_bin(sig)
    splits = sig.point_prt_segments
    dbf_w = np.asarray(assets.dbf_coeffs())
    ts_np = np.asarray(T_SWEEP, np.float32)

    # fixed truth echo (tests/test_realdata.py scene): long-segment gate,
    # conjugate steering of the real-data DBF convention
    _, _, p3 = _segment_pulses(cfg)
    truth_gate, truth_v, el_physical = 1500, 12.0, 12.0
    dphi = (2 * np.pi * 0.0138 * np.sin(np.deg2rad(el_physical))
            / sig.wavelength)
    steer = np.exp(-1j * np.arange(n_c) * dphi)
    fd = 2 * truth_v / sig.wavelength
    dop = np.exp(1j * 2 * np.pi * fd * np.arange(n_p) * sig.prt)
    segv = np.zeros(n_g, complex)
    segv[truth_gate:truth_gate + len(p3)] = p3
    echo_np = (args.amp * dop[:, None, None] * segv[None, :, None]
               * steer[None, None, :]).astype(np.complex64)
    # (re, im) float planes as host-numpy closure constants, recombined
    # with lax.complex inside jit
    echo_re = np.ascontiguousarray(echo_np.real, np.float32)
    echo_im = np.ascontiguousarray(echo_np.imag, np.float32)

    def echo():
        return jax.lax.complex(jnp.asarray(echo_re), jnp.asarray(echo_im))

    def front(iq):
        """T-independent: gated IQ -> sum-beam amplitude maps."""
        beams = dbf(iq, jnp.asarray(dbf_w, iq.dtype), "realdata")
        rdm, _ = stage2_mtd(beams, cfg)
        mag = jnp.abs(rdm)
        return mag[:, :, :-1] + mag[:, :, 1:]

    # locate the truth cell from the noiseless echo — argmax on device,
    # scalar transfer only
    flat = int(jax.jit(lambda: jnp.argmax(front(echo())))())
    v0, g0, _ = np.unravel_index(flat, (n_p, n_g, sig.beam_num - 1))
    v0, g0 = int(v0), int(g0)
    print(f"truth cell: v_bin={v0} gate={g0} (injected gate {truth_gate})",
          flush=True)

    def noise_cube(k):
        g = jax.random.normal(k, (n_p, n_g, n_c, 2), jnp.float32)
        return jax.lax.complex(g[..., 0], g[..., 1]) * np.float32(
            np.sqrt(0.5))

    def one_trial(k, ts):
        maps = front(echo() + noise_cube(k))

        def tail(t):
            flags, _ = segmented_cfar_1d(maps, cfg.cfar1d, splits, dvb,
                                         threshold_factor=t)
            win = jax.lax.dynamic_slice(
                flags, (v0 - 2, g0 - 3, 0), (5, 7, flags.shape[2]))
            return jnp.any(win)

        return jax.lax.map(tail, ts)

    @jax.jit
    def pd_batch(keys, ts):
        hits = jax.lax.map(lambda k: one_trial(k, ts), keys)
        return jnp.sum(hits.astype(jnp.int32), axis=0)

    key = jax.random.PRNGKey(20260821)
    print(f"== Pd arm: amp={args.amp} ({20 * np.log10(args.amp):+.1f} dB "
          f"per-sample), {args.trials} trials ==", flush=True)
    t0 = time.time()
    pd_counts = np.zeros(len(T_SWEEP), np.int64)
    done = 0
    while done < args.trials:
        nb = min(args.batch, args.trials - done)
        keys = jax.random.split(jax.random.fold_in(key, done), nb)
        pd_counts += np.asarray(jax.block_until_ready(
            pd_batch(keys, jnp.asarray(ts_np))))
        done += nb
        print(f"  {done}/{args.trials} ({time.time() - t0:.0f}s)",
              flush=True)
    pds = pd_counts / args.trials
    for t, p in zip(T_SWEEP, pds):
        print(f"  T={t:5.1f}: Pd={p:.3f}", flush=True)

    # ---- Pfa arm: operational flag counts on noise-only frames --------
    # count_exceedances_realdata IS segmented_cfar_1d's semantics swept
    # over a threshold vector (one noise estimate per segment, broadcast
    # compare) with an exact STATIC tested-cell count — no per-T rerun
    from radar_tpu.ops.cfar_analysis import count_exceedances_realdata

    @jax.jit
    def pfa_batch(keys, ts):
        def frame(k):
            return count_exceedances_realdata(front(noise_cube(k)),
                                              cfg.cfar1d, splits, dvb, ts)

        c, n = jax.lax.map(frame, keys)
        # the per-frame tested-cell count is identical every frame —
        # return ONE frame's value (a large-batch int32 sum could wrap);
        # the host multiplies in int64
        return jnp.sum(c, axis=0), n[0]

    print(f"== Pfa arm: {args.noise_frames} noise frames ==", flush=True)
    t0 = time.time()
    counts = np.zeros(len(T_SWEEP), np.int64)
    cells = 0
    kn = jax.random.fold_in(key, 555_000)
    done = 0
    while done < args.noise_frames:
        nb = min(args.noise_batch, args.noise_frames - done)
        keys = jax.random.split(jax.random.fold_in(kn, done), nb)
        c, n = jax.tree.map(np.asarray, jax.block_until_ready(
            pfa_batch(keys, jnp.asarray(ts_np))))
        counts += c
        cells += int(n) * nb      # n = one frame's tested cells (static)
        done += nb
        print(f"  {done}/{args.noise_frames} frames, {cells / 1e6:.0f}M "
              f"cells ({time.time() - t0:.0f}s)", flush=True)
    pfa = counts / cells
    pfa_bound = np.where(counts > 0, pfa, 3.0 / cells)
    for t, c, p, b in zip(T_SWEEP, counts, pfa, pfa_bound):
        tag = f"{p:.3e}" if c else f"<= {b:.1e} (0 hits, 95% bound)"
        print(f"  T={t:5.1f}: Pfa={tag}", flush=True)

    from radar_tpu.utils.stats import wilson_ci

    pd_ci = [wilson_ci(int(c), args.trials) for c in pd_counts]
    i8 = T_SWEEP.index(T_REF)
    lo8, hi8 = pd_ci[i8]
    headline = (
        f"realdata 1D CA-GO: Pd={pds[i8]:.2f} (95% CI {lo8:.2f}-{hi8:.2f}"
        f", {args.trials} trials) at Pfa"
        + (f"={pfa[i8]:.2e}" if counts[i8] else f"<={pfa_bound[i8]:.1e}")
        + f" (T={T_REF:g}, amp {args.amp} = "
          f"{20 * np.log10(args.amp):+.1f} dB/sample, 64p x 3404g x "
          f"16ch, {jax.devices()[0].device_kind})")
    print("HEADLINE:", headline, flush=True)

    report = {
        "device": jax.devices()[0].device_kind,
        "config": "realdata staged path: DBF(realdata) -> stage2 PC+MTD "
                  "-> segmented 1D CA-GO CFAR (64 pulses x 3404 gates x "
                  "16 ch, 12 sum-beam pairs)",
        "amp": args.amp, "amp_db_per_sample": 20 * np.log10(args.amp),
        "truth_cell": [int(v0), int(g0)],
        "trials_per_t": args.trials, "noise_frames": args.noise_frames,
        "noise_cells": int(cells),
        "t_factors": T_SWEEP,
        "pd": [float(p) for p in pds],
        "pd_hits": [int(c) for c in pd_counts],
        "pd_ci95": [[lo, hi] for lo, hi in pd_ci],
        "pfa": [float(p) for p in pfa],
        "pfa_hits": [int(c) for c in counts],
        "pfa_95_upper_bound": [float(b) for b in pfa_bound],
        "headline": headline,
        "note": "Pd counts DETECTOR flags in the truth window (before "
                "extraction capacity); Pfa counts operational flags over "
                "valid (non-clutter-band, thr>0) cells — the >= compare "
                "and edge fallback of Function_CFAR1D_sub included",
        "ref": "Function_CFAR1D_sub debug_simulated_data_processing_v2.m:"
               "467-511; fixed-T adapter main_test_with_simulated_data.m",
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print("wrote", args.out, flush=True)

    if args.png:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 9))
        ax1.semilogy(T_SWEEP, np.maximum(pfa, 0.5 / cells), "bo-",
                     label="measured Pfa")
        ax1.semilogy(T_SWEEP, pfa_bound, "c--", label="95% upper bound")
        ax1.axvline(T_REF, color="k", ls=":",
                    label=f"reference T={T_REF:g}")
        ax1.set_xlabel("threshold factor T")
        ax1.set_ylabel("Pfa per valid cell (1D CA-GO)")
        ax1.legend()
        ax1.grid(True)
        ax2.plot(T_SWEEP, np.asarray(pds) * 100, "ms-")
        ax2.axvline(T_REF, color="k", ls=":")
        ax2.set_xlabel("threshold factor T")
        ax2.set_ylabel(f"Pd (%) at amp {args.amp} "
                       f"({20 * np.log10(args.amp):+.1f} dB/sample)")
        ax2.set_ylim(-5, 105)
        ax2.grid(True)
        fig.suptitle(headline, fontsize=8)
        fig.tight_layout()
        fig.savefig(args.png, dpi=110)
        plt.close(fig)
        print("figure:", args.png, flush=True)


if __name__ == "__main__":
    main()
