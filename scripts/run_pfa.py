"""Measure the CFAR false-alarm rate and calibrate it against analytic
expectation — the Pfa half of the BASELINE "CFAR Pd at fixed Pfa" metric.

The reference never measures Pfa: it fixes T_CFAR=8
(fun_process_single_frame.m:178, main_plot_snr_vs_angle_error.m:53-55) and
relies on the amplitude-domain threshold being deep in the tail. This
script produces results/pfa_calibration.json with three sections:

1. ``exponential_validation`` — both CFAR families fed iid unit-exponential
   (square-law) cells at T in {4,6,8,10,12}, measured rate vs the exact
   analytic Pfa (ops/cfar_analysis.py quadrature; closed-form CA/GO
   cross-checks included). Distribution-level proof that the shift-add
   detectors ARE the textbook detectors.

2. ``sim_path_operating`` — full-scale pure-noise frames through the real
   stream pipeline (per-channel AWGN -> DBF -> PC -> MTD -> adjacent-beam
   pair-sum maps, i.e. beam-correlated amplitude-domain cells) swept over
   threshold factors. The measurable transition sits at T ~ 1-2; at the
   reference operating point T=8 no false alarm is observable — the
   rule-of-three 95% upper bound on Pfa(T=8) is recorded.

3. ``realdata_path_operating`` — the same noise frames through the
   segmented 1D CA-GO CFAR (clutter band excluded), same treatment.

Run on the GPU (default) or ``--cpu``. ``--frames`` scales the cell count.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

T_VALIDATE = [4.0, 6.0, 8.0, 10.0, 12.0]
T_OPERATE = [1.0, 1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 4.0, 8.0]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="shrunk config (CPU smoke)")
    ap.add_argument("--frames", type=int, default=48,
                    help="pure-noise frames for the operating-point curves")
    ap.add_argument("--exp-frames", type=int, default=24,
                    help="exponential full-cube draws for the validation")
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "pfa_calibration.json"))
    args = ap.parse_args()
    from radar_tpu.utils.device import setup_compile_cache

    setup_compile_cache()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from radar_tpu.config.params import full_config, small_test_config
    from radar_tpu.ops.cfar_analysis import (analytic_pfa_ca_closed_form,
                                             analytic_pfa_exponential,
                                             analytic_pfa_go_closed_form,
                                             analytic_pfa_goca2d,
                                             count_exceedances_1d_interior,
                                             count_exceedances_2d,
                                             count_exceedances_realdata)
    from radar_tpu.ops.cfar import pair_sum_maps
    from radar_tpu.ops.dbf import dbf
    from radar_tpu.ops.mtd import make_mtd_matrix, mtd_matmul
    from radar_tpu.ops.pulse_compression import (make_matmul_plan,
                                                 pulse_compress_matmul)
    from radar_tpu.pipeline.stages import _delta_v_bin
    from radar_tpu.sim.echo import P_NOISE_FLOOR
    from radar_tpu.waveform.precompute import precompute

    cfg = small_test_config() if args.small else full_config()
    pre = precompute(cfg)
    sig = cfg.sig
    report = {"device": str(jax.devices()[0].platform),
              "config": "small" if args.small else "full",
              "cfar_2d": {"method": cfg.cfar.method,
                          "ref_r": cfg.cfar.ref_cells_r,
                          "guard_r": cfg.cfar.guard_cells_r,
                          "ref_v": cfg.cfar.ref_cells_v,
                          "guard_v": cfg.cfar.guard_cells_v},
              "cfar_1d": {"method": cfg.cfar1d.method,
                          "ref": cfg.cfar1d.ref_cells,
                          "guard": cfg.cfar1d.guard_cells}}

    # ---- 1. exponential-fed validation vs analytic --------------------
    print("== exponential validation ==", flush=True)
    shape = (sig.prt_num, pre.n_total_gate, sig.beam_num - 1)
    rng = np.random.default_rng(0)
    c2d = jax.jit(lambda m: count_exceedances_2d(m, cfg.cfar, T_VALIDATE))
    c1d = jax.jit(lambda m: count_exceedances_1d_interior(
        m, cfg.cfar1d, T_VALIDATE))
    tot2, tot1 = np.zeros(len(T_VALIDATE), np.int64), np.zeros(
        len(T_VALIDATE), np.int64)
    nv2 = nv1 = 0
    for _ in range(args.exp_frames):
        x = rng.exponential(size=shape).astype(np.float32)
        a, b = c2d(jnp.asarray(x))
        tot2 += np.asarray(a)
        nv2 += int(b)
        a, b = c1d(jnp.asarray(x))
        tot1 += np.asarray(a)
        nv1 += int(b)
    n1 = cfg.cfar1d.ref_cells
    val = {"t_factors": T_VALIDATE, "cells_2d": nv2, "cells_1d": nv1,
           "sim_2d": [], "realdata_1d": [],
           "closed_form_cross_checks": {
               "ca_2n": {f"T={t}": {
                   "closed": analytic_pfa_ca_closed_form(t, 2 * n1),
                   "quadrature": analytic_pfa_exponential(t, [n1, n1], "CA")}
                   for t in T_VALIDATE},
               "go_gandhi_kassam": {f"T={t}": {
                   "closed": analytic_pfa_go_closed_form(t, n1),
                   "quadrature": analytic_pfa_exponential(t, [n1, n1], "GO")}
                   for t in T_VALIDATE}}}
    for i, t in enumerate(T_VALIDATE):
        a2 = analytic_pfa_goca2d(t, cfg.cfar)
        a1 = analytic_pfa_exponential(t, [n1, n1], cfg.cfar1d.method)
        m2, m1 = tot2[i] / nv2, tot1[i] / nv1
        val["sim_2d"].append({"t": t, "hits": int(tot2[i]), "measured": m2,
                              "analytic": a2,
                              "ratio": m2 / a2 if a2 else None})
        val["realdata_1d"].append({"t": t, "hits": int(tot1[i]),
                                   "measured": m1, "analytic": a1,
                                   "ratio": m1 / a1 if a1 else None})
        print(f"  T={t:5.1f}: 2D {m2:.3e} vs {a2:.3e} "
              f"(x{m2 / a2:.3f})   1D {m1:.3e} vs {a1:.3e} "
              f"(x{m1 / a1:.3f})", flush=True)
    report["exponential_validation"] = val

    # ---- 2+3. operating-point curves on real pipeline noise -----------
    print("== operating-point measurement (pure-noise frames) ==",
          flush=True)
    mplan = make_matmul_plan(pre)
    mtd_mat = make_mtd_matrix(pre.mtd_win, sig.prt_num, cfg.mtd_fft_len)
    dbf_w = np.asarray(pre.dbf_w)
    splits = sig.point_prt_segments
    dvb = _delta_v_bin(sig)
    cube_shape = (sig.prt_num, sig.point_prt, sig.channel_num)
    scale = np.float32(np.sqrt(P_NOISE_FLOOR / 2.0))

    def one_frame(key):
        g = jax.random.normal(key, cube_shape + (2,), jnp.float32)
        noise = jax.lax.complex(g[..., 0], g[..., 1]) * scale
        beams = dbf(noise, dbf_w, cfg.dbf_variant)
        rdm = mtd_matmul(pulse_compress_matmul(beams, mplan), mtd_mat)
        maps = pair_sum_maps(rdm)
        c2, n2 = count_exceedances_2d(maps, cfg.cfar, T_OPERATE)
        cr, nr = count_exceedances_realdata(maps, cfg.cfar1d, splits, dvb,
                                            T_OPERATE)
        return c2, n2, cr, nr

    @jax.jit
    def frames(keys):
        # int32 accumulation is safe: worst case ~0.4 Pfa x 13M cells x
        # hundreds of frames stays under 2^31
        c2, n2, cr, nr = jax.lax.map(one_frame, keys)
        return (jnp.sum(c2, axis=0), jnp.sum(n2),
                jnp.sum(cr, axis=0), jnp.sum(nr))

    keys = np.asarray(
        jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.PRNGKey(20260820), jnp.arange(args.frames)))
    t0 = time.time()
    c2, n2, cr, nr = jax.tree.map(np.asarray, frames(jnp.asarray(keys)))
    dt = time.time() - t0
    print(f"  {args.frames} frames in {dt:.1f}s "
          f"({n2 / 1e6:.1f}M 2D cells, {nr / 1e6:.1f}M 1D cells)",
          flush=True)

    def curve(counts, n_cells):
        rows = []
        for t, c in zip(T_OPERATE, counts):
            c = int(c)
            rows.append({"t": t, "hits": c, "pfa": c / int(n_cells),
                         "pfa_ub95": ((c + 3) / int(n_cells)) if c < 10
                         else None})
        return rows

    i8 = T_OPERATE.index(8.0)
    report["sim_path_operating"] = {
        "t_factors": T_OPERATE, "frames": args.frames, "cells": int(n2),
        "curve": curve(c2, n2),
        "t8_hits": int(c2[i8]), "t8_pfa_ub95": (int(c2[i8]) + 3) / int(n2),
        "note": "amplitude-domain pair-sum cells; T=8 is ~10 sigma on a "
                "Rayleigh-sum cell, analytically ~1e-22 per cell"}
    report["realdata_path_operating"] = {
        "t_factors": T_OPERATE, "frames": args.frames, "cells": int(nr),
        "curve": curve(cr, nr),
        "t8_hits": int(cr[i8]), "t8_pfa_ub95": (int(cr[i8]) + 3) / int(nr)}
    for name, c, n in (("sim", c2, n2), ("realdata", cr, nr)):
        s = "  ".join(f"T={t}:{int(ci) / int(n):.2e}"
                      for t, ci in zip(T_OPERATE, c))
        print(f"  {name}: {s}", flush=True)
    print(f"  T=8: sim {int(c2[i8])} hits / {int(n2)} cells "
          f"(Pfa < {(int(c2[i8]) + 3) / int(n2):.2e} @95%), "
          f"realdata {int(cr[i8])} hits", flush=True)

    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
