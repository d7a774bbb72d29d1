"""Multi-frame radar simulation driver — the framework's equivalent of the
reference's primary entry point ``main_simulate_echoes_with_array_v8_3.m``:
N frames of two-target constant-altitude kinematics with servo scan, per
frame the full jitted processing chain, then 5D track association and the
PPI/RHI/track-history/cluster-comparison figures.

Usage:
  python scripts/run_simulation.py [--frames 50] [--cpu] [--small]
         [--out out_sim] [--checkpoint]
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
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--small", action="store_true",
                    help="8-channel/32-pulse small config")
    ap.add_argument("--out", default="out_sim")
    ap.add_argument("--checkpoint", action="store_true",
                    help="persist per-frame measurement checkpoints")
    ap.add_argument("--resume", action="store_true",
                    help="restart-on-failure: persist per-frame "
                         "measurements as the loop runs and skip frames "
                         "already checkpointed under --out (an "
                         "interrupted run rerun with the same arguments "
                         "continues where it died; SURVEY 5.3)")
    ap.add_argument("--device-scan", action="store_true",
                    help="run all frames inside one on-device lax.scan "
                         "(no host round trip per frame; best on "
                         "high-latency accelerators)")
    ap.add_argument("--smooth", action="store_true",
                    help="Kalman/RTS-smooth the associated tracks and plot "
                         "the smoothed trajectories")
    ap.add_argument("--perf", action="store_true",
                    help="run the perf configuration (rank-K signal RDM + "
                         "post-MTD beam-noise mixing, bf16 matmul planes, "
                         "rbg PRNG; statistically validated, results/)")
    ap.add_argument("--five-target", action="store_true",
                    help="run the v8_2 five-target scene (SNR -20..+15 dB, "
                         "main_simulate_echoes_with_array_v8_2.m:28-51) "
                         "instead of the v8_3 two-target scene; implies "
                         "--kinematics simple unless overridden")
    ap.add_argument("--kinematics", choices=("altitude", "simple"),
                    default=None,
                    help="track model: 'altitude' = v8_3 constant-altitude "
                         "(default), 'simple' = v8_2 R-=V*T with constant "
                         "El/V (v8_2.m:200-205)")
    args = ap.parse_args()
    from radar_tpu.utils.device import setup_compile_cache

    setup_compile_cache()
    if args.kinematics is None:
        args.kinematics = "simple" if args.five_target else "altitude"

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from radar_tpu.config.params import full_config, small_test_config
    from radar_tpu.io.checkpoint import (CheckpointStore, SaveOptions,
                                         save_detection_log_json)
    from radar_tpu.pipeline.driver import run_multiframe
    from radar_tpu.sim.scenario import (default_two_target_scene,
                                        five_target_scene)
    from radar_tpu.viz.plots import (plot_cluster_comparison, plot_ppi,
                                     plot_rhi, plot_track_history)
    from radar_tpu.waveform.precompute import precompute

    cfg = small_test_config() if args.small else full_config()
    if args.perf:
        from radar_tpu.config.params import perf_config

        cfg = perf_config(cfg)
    pre = precompute(cfg)
    scene = (five_target_scene() if args.five_target
             else default_two_target_scene())

    t0 = time.time()
    if args.device_scan:
        from radar_tpu.pipeline.driver import run_multiframe_device

        dstore, chunk = None, None
        if args.resume:
            # chunked device scan with orbax chunk checkpoints: a rerun
            # replays completed chunks and resumes the scan from the
            # persisted kinematic carry (bit-identical to uninterrupted)
            from radar_tpu.io.orbax_store import OrbaxFrameStore

            dstore = OrbaxFrameStore(os.path.join(args.out,
                                                  "device_chunks"))
            manifest = os.path.join(dstore.root, "run_manifest.json")
            if os.path.exists(manifest):
                # the chunk size is part of the run identity — reuse it
                with open(manifest) as f:
                    chunk = json.load(f)["chunk_frames"]
                if args.frames % chunk:
                    raise SystemExit(
                        f"--frames {args.frames} not divisible by the "
                        f"store's chunk_frames {chunk}")
            else:
                chunk = max(1, min(10, args.frames))
                while args.frames % chunk:
                    chunk -= 1
            if dstore.frames_done():
                print(f"resuming: chunks ending at {dstore.frames_done()} "
                      f"replay from {dstore.root}")
        log, tracks = run_multiframe_device(cfg, scene, args.frames, seed=0,
                                            precomp=pre, store=dstore,
                                            chunk_frames=chunk,
                                            kinematics=args.kinematics)
    else:
        store = None
        if args.resume:
            store = CheckpointStore(os.path.join(args.out, "checkpoints"),
                                    SaveOptions(measurements=True))
            done = store.frames_done("measurements")
            if done:
                print(f"resuming: frames {done[0]}..{done[-1]} replay "
                      f"from {store.root}")
        log, tracks, scen = run_multiframe(cfg, scene, args.frames, seed=0,
                                           precomp=pre, progress=True,
                                           store=store,
                                           kinematics=args.kinematics)
    print(f"\nprocessed {args.frames} frames in {time.time() - t0:.2f}s: "
          f"{len(log)} detections -> {len(tracks)} tracks")
    for t in sorted(tracks, key=lambda t: -t.num_points)[:10]:
        print(f"  R={t.range_m:8.1f} m  V={t.velocity_ms:6.2f} m/s  "
              f"El={t.elevation_deg:5.2f} deg  Az={t.azimuth_deg:6.2f} deg  "
              f"frames {t.first_frame}-{t.last_frame} "
              f"({t.num_points} pts)")

    os.makedirs(args.out, exist_ok=True)
    if args.smooth:
        from radar_tpu.pipeline.tracking import smooth_tracks
        from radar_tpu.viz.plots import plot_smoothed_tracks

        smoothed = smooth_tracks(log, tracks, cfg)
        for st in smoothed:
            print(f"  smoothed: R={st.range_m[-1]:8.1f} m  "
                  f"V={st.velocity_ms[-1]:6.2f} m/s  "
                  f"El={st.elevation_deg[-1]:5.2f} deg  "
                  f"sigmaR={st.range_std_m[-1]:.1f} m  "
                  f"({len(st.frames)} frames)")
        print("smoothed figure:",
              plot_smoothed_tracks(
                  smoothed, os.path.join(args.out, "smoothed_tracks.png")))
    print("figures:",
          plot_ppi(tracks, os.path.join(args.out, "ppi.png")),
          plot_rhi(tracks, os.path.join(args.out, "rhi.png")),
          plot_track_history(log, tracks,
                             os.path.join(args.out, "track_history.png")),
          plot_cluster_comparison(log, tracks,
                                  os.path.join(args.out, "clusters.png")))
    save_detection_log_json(os.path.join(args.out, "detection_log.json"),
                            log)
    if args.checkpoint:
        store = CheckpointStore(os.path.join(args.out, "checkpoints"),
                                SaveOptions(cumulative_log=True))
        store.save("cumulative_log", args.frames,
                   range_m=log.range_m, velocity_ms=log.velocity_ms,
                   elevation_deg=log.elevation_deg, power=log.power,
                   frame=log.frame, azimuth_deg=log.azimuth_deg)
        print("checkpoints under", os.path.join(args.out, "checkpoints"))


if __name__ == "__main__":
    main()
