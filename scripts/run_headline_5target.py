"""Execute the reference's HARDEST end-to-end demonstration: the v8_2
five-target scene (SNR -20..+15 dB, main_simulate_echoes_with_array_v8_2.m:
28-51) for 50 frames with the v8_2 simple kinematics (R -= V*T, El/V
constant, v8_2:200-205), through the full pipeline + 5D track association
(v8_2:227-332), scored with track-level metrics against the 5 injected
trajectories — including the fate of the -20 dB target among four
stronger ones (CFAR masking + clustering gates + association stressed
simultaneously).

Usage:
  python scripts/run_headline_5target.py                 # GPU, perf config
  python scripts/run_headline_5target.py --cpu --small   # smoke
Artifacts: results/headline_5target.json + _ppi/_history figures.
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
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="8-channel/32-pulse smoke config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1,
                    help="repeat the run across N seeds (seed, seed+1, "
                         "...) and aggregate per-target outcomes — the "
                         "robustness arm; figures/headline fields come "
                         "from the first seed")
    ap.add_argument("--exact", action="store_true",
                    help="exact-reference-stream path instead of the perf "
                         "config (same detections statistically)")
    ap.add_argument("--out", default=None,
                    help="JSON artifact path (default results/"
                         "headline_5target.json; smoke runs go to /tmp)")
    args = ap.parse_args()
    from radar_tpu.utils.device import setup_compile_cache

    setup_compile_cache()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from radar_tpu.config.params import (full_config, perf_config,
                                         small_test_config)
    from radar_tpu.pipeline.driver import run_multiframe_device
    from radar_tpu.pipeline.track_metrics import (DEFAULT_MATCH_GATES,
                                                  score_tracks)
    from radar_tpu.sim.scenario import five_target_scene
    from radar_tpu.viz.plots import plot_ppi, plot_track_history
    from radar_tpu.waveform.precompute import precompute

    cfg = small_test_config() if args.small else full_config()
    if not args.exact:
        cfg = perf_config(cfg)
    pre = precompute(cfg)
    scene = five_target_scene()

    t0 = time.time()
    runs = []
    for s in range(args.seed, args.seed + args.seeds):
        log, tracks = run_multiframe_device(cfg, scene, args.frames,
                                            seed=s, precomp=pre,
                                            kinematics="simple")
        sc = score_tracks(log, tracks, scene, args.frames, cfg,
                          kinematics="simple")
        runs.append((s, log, tracks, sc))
        if args.seeds > 1:
            print(f"seed {s}: {len(log)} det -> {len(tracks)} tracks, "
                  f"Pd={sc.track_pd:.2f} false={sc.false_tracks} "
                  f"frag={sc.fragmentation:.2f}", flush=True)
    wall = time.time() - t0
    _, log, tracks, score = runs[0]
    print(f"{args.seeds} x {args.frames} frames in {wall:.1f}s; seed "
          f"{args.seed}: {len(log)} detections -> {len(tracks)} tracks")
    per_target = []
    for k in range(scene.num_targets):
        per_target.append({
            "truth": {"range_m": scene.range_m[k],
                      "velocity_ms": scene.velocity_ms[k],
                      "elevation_deg": scene.elevation_deg[k],
                      "snr_db": scene.snr_db[k]},
            "detected": bool(score.truth_detected[k]),
            "coverage": round(float(score.truth_coverage[k]), 3),
            "n_tracks": int(score.truth_n_tracks[k]),
        })
        t = per_target[-1]
        print(f"  target {k + 1} (SNR {scene.snr_db[k]:+.0f} dB, "
              f"R {scene.range_m[k]:.0f} m): "
              f"{'TRACKED' if t['detected'] else 'MISSED'} "
              f"coverage={t['coverage']:.2f} tracks={t['n_tracks']}")
    print(f"track Pd {score.track_pd:.2f}, false tracks "
          f"{score.false_tracks}, fragmentation {score.fragmentation:.2f}, "
          f"switches {score.switched_tracks}")

    out = args.out or (os.path.join("results", "headline_5target.json")
                       if not (args.small or args.cpu)
                       else "/tmp/headline_5target.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    stem = out[:-5] if out.endswith(".json") else out
    import jax

    artifact = {
        "what": ("v8_2 five-target headline scenario "
                 "(main_simulate_echoes_with_array_v8_2.m:28-51,200-205): "
                 f"{args.frames} frames, simple kinematics, "
                 f"{'exact-stream' if args.exact else 'perf'} config, "
                 "on-device lax.scan runner, 5D track association"),
        "device": jax.devices()[0].device_kind,
        "config": {"channels": cfg.sig.channel_num,
                   "pulses": cfg.sig.prt_num, "seed": args.seed},
        "frames": args.frames,
        "wall_s": round(wall, 2),
        "detections": len(log),
        "tracks": len(tracks),
        "track_pd": round(score.track_pd, 3),
        "false_tracks": score.false_tracks,
        # fragmentation is NaN when zero truths were detected; json.dump
        # would emit a non-RFC-8259 literal — map to None (self-review r5)
        "fragmentation": (None if score.fragmentation != score.fragmentation
                          else round(score.fragmentation, 3)),
        "switched_tracks": score.switched_tracks,
        "per_target": per_target,
        "match_gates": dict(DEFAULT_MATCH_GATES),
    }
    if args.seeds > 1:
        import numpy as np

        scs = [r[3] for r in runs]
        artifact["robustness"] = {
            "seeds": args.seeds,
            "track_pd_mean": round(float(np.mean(
                [s.track_pd for s in scs])), 4),
            "per_target_detected_rate": [
                round(float(np.mean([s.truth_detected[k] for s in scs])), 3)
                for k in range(scene.num_targets)],
            "per_target_coverage_mean": [
                round(float(np.mean([s.truth_coverage[k] for s in scs])), 3)
                for k in range(scene.num_targets)],
            "false_tracks_total": int(sum(s.false_tracks for s in scs)),
            # nanmean: a zero-detection seed contributes NaN (same
            # convention as run_tracking_mc.py's aggregation)
            "fragmentation_mean": round(float(np.nanmean(
                [s.fragmentation for s in scs])), 3),
        }
        print("robustness:", json.dumps(artifact["robustness"]))
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print("wrote", out)
    print("figures:",
          plot_ppi(tracks, stem + "_ppi.png",
                   title="v8_2 five-target headline (50 frames)"),
          plot_track_history(log, tracks, stem + "_history.png"))


if __name__ == "__main__":
    main()
