"""A/B pipeline variants of the full reference-size frame on the GPU.

Each variant runs inside one on-device fori_loop with a traced trip count;
per-frame time is the slope between two trip counts, outputs consumed into
the carry (radar_tpu/bench/timing.py). Variant names combine the tokens
``fused``, ``lowrank``, ``bf16``, ``rbg``, ``nscan``, ``mrefined`` and
``mcfar``.

Usage: python scripts/ab_fused_synth.py default lowrank_bf16_rbg
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp


def time_variant(cfg, targets, label):
    from radar_tpu.bench.timing import frame_time_slope, make_frames_loop
    from radar_tpu.pipeline.frame import make_frame_processor

    process = make_frame_processor(cfg, dtype=jnp.complex64, jit=False)
    dt, _ = frame_time_slope(make_frames_loop(process, targets))
    print(json.dumps({"variant": label, "ms_per_frame": round(1e3 * dt, 3),
                      "frames_per_s": round(1.0 / dt, 1)}))
    return dt


def main():
    from radar_tpu.config.params import full_config
    from radar_tpu.sim.scenario import TargetBatch

    targets_np = TargetBatch.make([3000.0, 10000.0], [20.0, 25.0],
                                  [10.0, 10.0], [10.0, 15.0])
    targets = TargetBatch(*[jnp.asarray(x, jnp.float32)
                            for x in targets_np])
    cfg = full_config()
    import sys
    variants = sys.argv[1:] or ["default", "fused"]
    dts = {}
    for v in variants:
        kw = {}
        if "fused" in v:
            kw["fused_synth_dbf"] = True
        if "lowrank" in v:
            kw["fused_synth_dbf"] = True
            kw["lowrank_rdm"] = True
        if "bf16" in v:
            kw["matmul_precision"] = "bf16"
        if "rbg" in v:
            kw["noise_prng"] = "rbg"
        if "nscan" in v:
            kw["extract_native_scan"] = True
        if "mrefined" in v:  # spline-refined-index monopulse (flaw fix)
            kw["monopulse_refined"] = True
        if "mcfar" in v:   # banded-stencil matmul CFAR window means
            import dataclasses

            kw["cfar"] = dataclasses.replace(cfg.cfar, means_impl="matmul")
        dts[v] = time_variant(cfg.replace(**kw) if kw else cfg, targets, v)
    if len(dts) > 1:
        base = list(dts.values())[0]
        print(json.dumps({f"speedup_vs_{variants[0]}":
                          {v: round(base / dt, 3) for v, dt in dts.items()}}))


if __name__ == "__main__":
    main()
