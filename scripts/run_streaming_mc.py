"""Streaming many-target Monte-Carlo driver (BASELINE config 5): scenes of
random targets x noise trials, detection-rate statistics vs SNR, range/
velocity RMSE. Scales to 10k+ injected targets on one chip; trials shard
over a dp mesh axis with --mesh.

Usage:
  python scripts/run_streaming_mc.py [--cpu] [--small] [--perf]
         [--scenes 32] [--targets 40] [--trials 8] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--channels", type=int, default=0,
                    help="with --pulses: the scaled production config "
                         "(BASELINE config 3 geometry, e.g. 64 256)")
    ap.add_argument("--pulses", type=int, default=0)
    ap.add_argument("--perf", action="store_true",
                    help="perf pipeline configuration (lowrank+bf16+rbg)")
    ap.add_argument("--scenes", type=int, default=32)
    ap.add_argument("--targets", type=int, default=40)
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--snr", default="-5:20", help="min:max injected SNR dB")
    ap.add_argument("--json", default=None)
    ap.add_argument("--dp", type=int, default=0,
                    help="shard trials over a dp mesh axis of this size "
                         "(the reference's parfor boundary on the mesh)")
    ap.add_argument("--orbax", default=None, metavar="DIR",
                    help="elastic recovery: checkpoint each scene's sharded "
                         "trial results here; a rerun resumes completed "
                         "scenes from disk, even onto a different --dp")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    from radar_tpu.utils.device import setup_compile_cache

    setup_compile_cache()

    if args.cpu:
        if args.dp:
            # virtual CPU devices for the dp mesh (must precede jax init)
            import re

            flags = os.environ.get("XLA_FLAGS", "")
            m = re.search(r"xla_force_host_platform_device_count=(\d+)",
                          flags)
            if m is None:
                os.environ["XLA_FLAGS"] = (
                    flags + " --xla_force_host_platform_device_count="
                    f"{args.dp}").strip()
            elif int(m.group(1)) < args.dp:
                raise SystemExit(
                    f"XLA_FLAGS already pins "
                    f"{m.group(1)} virtual devices but --dp {args.dp} "
                    f"needs at least {args.dp}; unset XLA_FLAGS or raise "
                    "the count")
        import jax

        jax.config.update("jax_platforms", "cpu")

    from radar_tpu.config.params import (full_config, scaled_config,
                                         small_test_config)
    from radar_tpu.pipeline.streaming import run_streaming_mc

    if args.channels and args.pulses:
        cfg = scaled_config(args.channels, args.pulses)
    else:
        cfg = small_test_config() if args.small else full_config()
    if args.perf:
        from radar_tpu.config.params import perf_config

        cfg = perf_config(cfg)
    lo, hi = (float(x) for x in args.snr.split(":"))
    mesh = None
    if args.dp:
        from radar_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(dp=args.dp)
    store = None
    if args.orbax:
        from radar_tpu.io.orbax_store import OrbaxFrameStore

        store = OrbaxFrameStore(args.orbax)
        if store.frames_done():
            print(f"resuming: scenes {store.frames_done()} replay from "
                  f"{args.orbax}")
    t0 = time.time()
    stats = run_streaming_mc(cfg, num_scenes=args.scenes,
                             targets_per_scene=args.targets,
                             trials_per_scene=args.trials, seed=args.seed,
                             mesh=mesh, dp_trials=bool(args.dp),
                             store=store,
                             snr_range=(lo, hi), progress=True)
    wall = time.time() - t0
    total = args.scenes * args.targets * args.trials
    print(f"\n{total} injected targets in {wall:.1f}s "
          f"({total / wall:.0f} targets/s)")
    print(f"overall detection rate: {stats.detection_rate:.3f}")
    for lo_e, rate, n in zip(stats.snr_bin_edges[:-1], stats.snr_bin_rate,
                             stats.snr_bin_counts):
        print(f"  SNR >= {lo_e:+6.1f} dB: rate={rate:.2f} (n={n})")
    print(f"range RMSE {stats.range_rmse_m:.2f} m, "
          f"velocity RMSE {stats.velocity_rmse_ms:.3f} m/s")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({
                "perf_config": args.perf,
                "injected_targets": total,
                "wall_s": round(wall, 1),
                "targets_per_s": round(total / wall, 1),
                "overall_rate": float(stats.detection_rate),
                "rate_by_snr": [float(x) for x in stats.snr_bin_rate],
                "snr_bin_edges": [float(x) for x in stats.snr_bin_edges],
                "range_rmse_m": float(stats.range_rmse_m),
                "velocity_rmse_ms": float(stats.velocity_rmse_ms),
            }, fh, indent=1)
        print("json:", args.json)


if __name__ == "__main__":
    main()
