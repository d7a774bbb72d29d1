"""Pfa delta check for CfarParams.means_impl="matmul" (the matmul
banded-stencil window means) vs the default shift-add formulation.

The two implementations differ only in f32 summation order inside each
reference window (lead_trail_means_matmul docstring, ops/cfar.py), so the
detector's false-alarm behavior must be statistically identical. This
script proves that the strong way: BOTH impls are fed the SAME draws and
their per-threshold exceedance counts are compared cell-for-cell.

1. exponential-fed validation (iid unit-exponential cells, the analytic
   regime of results/pfa_calibration.json section 1): per-T hit counts for
   shift vs matmul on identical cubes + the analytic GOCA Pfa.
2. operating point: pure-noise frames through the real stream pipeline
   (AWGN -> DBF -> PC -> MTD -> pair-sum maps) at the reference T=8 plus
   the measurable transition region, both impls on the same frames.

Writes results/pfa_matmul_recheck.json. CPU by default (~2 min at the
default sizes); the point is arithmetic equivalence, not throughput.
Reference semantics: fun_process_single_frame.m:172-223 (window means),
threshold T_CFAR=8 at :178.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

T_FACTORS = [1.0, 1.5, 2.0, 4.0, 6.0, 8.0, 10.0, 12.0]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--gpu", action="store_true",
                    help="run on the live backend instead of forcing CPU")
    ap.add_argument("--exp-frames", type=int, default=12)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "pfa_matmul_recheck.json"))
    args = ap.parse_args()
    from radar_tpu.utils.device import setup_compile_cache

    setup_compile_cache()

    import jax
    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from radar_tpu.config.params import full_config
    from radar_tpu.ops.cfar import pair_sum_maps
    from radar_tpu.ops.cfar_analysis import (analytic_pfa_goca2d,
                                             count_exceedances_2d)
    from radar_tpu.ops.dbf import dbf
    from radar_tpu.ops.mtd import make_mtd_matrix, mtd_matmul
    from radar_tpu.ops.pulse_compression import (make_matmul_plan,
                                                 pulse_compress_matmul)
    from radar_tpu.sim.echo import P_NOISE_FLOOR
    from radar_tpu.waveform.precompute import precompute

    cfg = full_config()
    params_shift = cfg.cfar
    params_matmul = dataclasses.replace(cfg.cfar, means_impl="matmul")
    assert params_shift.means_impl == "shift"
    pre = precompute(cfg)
    sig = cfg.sig

    count_shift = jax.jit(
        lambda m: count_exceedances_2d(m, params_shift, T_FACTORS))
    count_matmul = jax.jit(
        lambda m: count_exceedances_2d(m, params_matmul, T_FACTORS))

    # ---- 1. identical exponential draws through both impls ------------
    print("== exponential validation (same draws, both impls) ==",
          flush=True)
    shape = (sig.prt_num, pre.n_total_gate, sig.beam_num - 1)
    rng = np.random.default_rng(0)
    tot_s = np.zeros(len(T_FACTORS), np.int64)
    tot_m = np.zeros(len(T_FACTORS), np.int64)
    n_cells = 0
    for _ in range(args.exp_frames):
        x = jnp.asarray(rng.exponential(size=shape).astype(np.float32))
        cs, ns = count_shift(x)
        cm, _ = count_matmul(x)
        tot_s += np.asarray(cs)
        tot_m += np.asarray(cm)
        n_cells += int(ns)
    exp_rows = []
    for i, t in enumerate(T_FACTORS):
        a = analytic_pfa_goca2d(t, cfg.cfar)
        ms, mm = tot_s[i] / n_cells, tot_m[i] / n_cells
        exp_rows.append({
            "t": t, "hits_shift": int(tot_s[i]), "hits_matmul": int(tot_m[i]),
            "count_delta": int(tot_m[i] - tot_s[i]),
            "pfa_shift": ms, "pfa_matmul": mm, "analytic": a,
            "ratio_matmul_vs_analytic": mm / a if a > 0 else None})
        print(f"  T={t:5.1f}: shift {int(tot_s[i]):>9} matmul "
              f"{int(tot_m[i]):>9} (delta {int(tot_m[i] - tot_s[i]):+d}) "
              f"analytic {a:.3e}", flush=True)

    # ---- 2. operating point on real pipeline noise, same frames -------
    print("== operating point (pure-noise stream frames, both impls) ==",
          flush=True)
    mplan = make_matmul_plan(pre)
    mtd_mat = make_mtd_matrix(pre.mtd_win, sig.prt_num, cfg.mtd_fft_len)
    dbf_w = np.asarray(pre.dbf_w)
    cube_shape = (sig.prt_num, sig.point_prt, sig.channel_num)
    scale = np.float32(np.sqrt(P_NOISE_FLOOR / 2.0))

    def one_frame(key):
        g = jax.random.normal(key, cube_shape + (2,), jnp.float32)
        noise = jax.lax.complex(g[..., 0], g[..., 1]) * scale
        beams = dbf(noise, dbf_w, cfg.dbf_variant)
        maps = pair_sum_maps(
            mtd_matmul(pulse_compress_matmul(beams, mplan), mtd_mat))
        cs, ns = count_exceedances_2d(maps, params_shift, T_FACTORS)
        cm, _ = count_exceedances_2d(maps, params_matmul, T_FACTORS)
        return cs, cm, ns

    @jax.jit
    def frames(keys):
        cs, cm, ns = jax.lax.map(one_frame, keys)
        return jnp.sum(cs, axis=0), jnp.sum(cm, axis=0), jnp.sum(ns)

    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(20260821), jnp.arange(args.frames))
    t0 = time.time()
    cs, cm, ns = jax.tree.map(np.asarray, frames(keys))
    print(f"  {args.frames} frames in {time.time() - t0:.1f}s "
          f"({int(ns) / 1e6:.1f}M cells)", flush=True)
    op_rows = []
    for i, t in enumerate(T_FACTORS):
        op_rows.append({"t": t, "hits_shift": int(cs[i]),
                        "hits_matmul": int(cm[i]),
                        "count_delta": int(cm[i] - cs[i])})
        print(f"  T={t:5.1f}: shift {int(cs[i]):>9} matmul {int(cm[i]):>9} "
              f"(delta {int(cm[i] - cs[i]):+d})", flush=True)
    i8 = T_FACTORS.index(8.0)

    report = {
        "device": str(jax.devices()[0].platform),
        "what": "Pfa delta of CfarParams.means_impl='matmul' vs 'shift', "
                "both impls on IDENTICAL draws (VERDICT r2 item 3)",
        "cfar": {"method": cfg.cfar.method, "ref_r": cfg.cfar.ref_cells_r,
                 "guard_r": cfg.cfar.guard_cells_r,
                 "ref_v": cfg.cfar.ref_cells_v,
                 "guard_v": cfg.cfar.guard_cells_v},
        "exponential_validation": {
            "t_factors": T_FACTORS, "frames": args.exp_frames,
            "cells": n_cells, "rows": exp_rows},
        "sim_path_operating": {
            "t_factors": T_FACTORS, "frames": args.frames,
            "cells": int(ns), "rows": op_rows,
            "t8_hits_shift": int(cs[i8]), "t8_hits_matmul": int(cm[i8]),
            "t8_pfa_ub95_matmul": (int(cm[i8]) + 3) / int(ns)},
    }
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
