"""Tutorial: the v8_2 five-target scene and track-level scoring.

The reference's hardest end-to-end demonstration is the v8_2 driver's
five-target scene — SNR spread -20..+15 dB, so a -20 dB target must
survive CFAR next to four stronger ones
(main_simulate_echoes_with_array_v8_2.m:28-51). v8_2 evolves it with the
SIMPLE kinematic model (R -= V*T_frame, elevation/velocity constant,
v8_2.m:200-205) rather than v8_3's constant-altitude model.

This tutorial runs the scene at the small CPU config through the
on-device lax.scan multi-frame runner, associates tracks with the 5D BFS
(v8_2.m:227-332), and scores the result with the track-level metrics of
pipeline/track_metrics.py — the quantitative form of the reference's
"compare detections with preset targets by eye" idiom (SURVEY.md
section 4). The full-scale record is in git history
(``git show dc6ffd7:results/headline_5target.json``: 5/5 clean tracks, the
-20 dB target included).

Run: python examples/06_five_target_tracking.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from radar_tpu.config.params import small_test_config
from radar_tpu.pipeline.driver import (associate_tracks,
                                       device_results_to_log,
                                       make_device_multiframe)
from radar_tpu.pipeline.track_metrics import score_tracks
from radar_tpu.sim.scenario import five_target_scene

cfg = small_test_config()
scene = five_target_scene()
n_frames = 8

print("v8_2 five-target scene (v8_2.m:28-51):")
for k in range(scene.num_targets):
    print(f"  target {k + 1}: R={scene.range_m[k]:7.0f} m  "
          f"V={scene.velocity_ms[k]:4.0f} m/s  "
          f"El={scene.elevation_deg[k]:4.0f} deg  "
          f"SNR={scene.snr_db[k]:+4.0f} dB")

# the whole multi-frame scenario runs as ONE jitted lax.scan program:
# kinematics + per-frame pipeline on device, no host round trip per frame
runner = make_device_multiframe(cfg, kinematics="simple")
results, azimuths, _ = jax.block_until_ready(
    runner(jax.random.PRNGKey(0), scene, n_frames))
log = device_results_to_log(results, azimuths)
tracks = associate_tracks(log, cfg)
print(f"\n{n_frames} frames: {len(log)} detections -> "
      f"{len(tracks)} tracks")

score = score_tracks(log, tracks, scene, n_frames, cfg,
                     kinematics="simple")
for k in range(scene.num_targets):
    print(f"  target {k + 1} (SNR {scene.snr_db[k]:+.0f} dB): "
          f"{'TRACKED' if score.truth_detected[k] else 'MISSED'} "
          f"coverage={score.truth_coverage[k]:.2f} "
          f"tracks={score.truth_n_tracks[k]}")
print(f"track Pd {score.track_pd:.2f}, false tracks "
      f"{score.false_tracks}, fragmentation {score.fragmentation:.2f}, "
      f"ID switches {score.switched_tracks}")
assert score.track_pd == 1.0, "all five targets should be tracked"
print("\nall five targets tracked — including the -20 dB one. The\n"
      "integration gain (PC ~28 dB + MTD ~25 dB) lifts it far above the\n"
      "CFAR threshold; what this scene really stresses is the CLUSTERING\n"
      "gates and 5D association keeping five tracks apart.")
print(f"(small {cfg.sig.channel_num}ch x {cfg.sig.prt_num}p config; "
      "run scripts/run_headline_5target.py for the full-scale artifact)")
