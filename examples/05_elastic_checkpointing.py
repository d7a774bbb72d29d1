"""Tutorial: restart-on-failure and ELASTIC recovery.

Two checkpointing subsystems cover the reference's staged-persistence
design (main_test_with_simulated_data.m:26-35,143-163) and its device-side
extension:

1. Host npz store (io/checkpoint.py): the frame loop persists each
   frame's measurement rows atomically; a rerun with the same store
   replays completed frames from disk and recomputes only the missing
   ones — field-exact, guarded by a run manifest that refuses a store
   written with a different (seed, config, scene).
2. Orbax store (io/orbax_store.py): SHARDED device arrays checkpoint
   shard-local (no host gather) and restore onto a DIFFERENT mesh shape
   — here a dp=4 streaming Monte-Carlo run "crashes" after half its
   scenes and resumes on dp=2 with bit-identical final statistics.

Run: python examples/05_elastic_checkpointing.py
"""

import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from radar_tpu.config.params import small_test_config
from radar_tpu.io.checkpoint import CheckpointStore, SaveOptions
from radar_tpu.io.orbax_store import OrbaxFrameStore
from radar_tpu.parallel.mesh import make_mesh
from radar_tpu.pipeline.driver import run_multiframe
from radar_tpu.pipeline.streaming import run_streaming_mc
from radar_tpu.sim.scenario import TargetBatch
from radar_tpu.waveform.precompute import precompute

root = tempfile.mkdtemp(prefix="radar_ckpt_")
cfg = small_test_config(channels=8, pulses=32)
pre = precompute(cfg)

# ---------------------------------------------------------------- part 1
print("== 1. restart-on-failure: the npz frame store ==")
tb = TargetBatch.make([3000.0], [15.0], [10.0], [18.0])
store = CheckpointStore(os.path.join(root, "frames"),
                        SaveOptions(measurements=True))

# a run that "dies" after 3 of 6 frames
run_multiframe(cfg, tb, num_frames=3, seed=4, precomp=pre, store=store)
print(f"   crashed run persisted frames {store.frames_done('measurements')}")

# the rerun replays 1-3 from disk, computes only 4-6
log, tracks, _ = run_multiframe(cfg, tb, num_frames=6, seed=4, precomp=pre,
                                store=store, progress=True)
print(f"   resumed -> {len(log)} rows, {len(tracks)} track(s); "
      f"frames done {store.frames_done('measurements')}")

# the manifest refuses a mismatched resume (wrong seed here)
try:
    run_multiframe(cfg, tb, num_frames=6, seed=5, precomp=pre, store=store)
except ValueError as e:
    print(f"   mismatched seed refused: {str(e)[:72]}...")

# ---------------------------------------------------------------- part 2
print("\n== 2. elastic recovery: orbax sharded store, dp=4 -> dp=2 ==")
kw = dict(targets_per_scene=3, trials_per_scene=4, seed=5, precomp=pre,
          snr_range=(12.0, 20.0))

ck = os.path.join(root, "orbax")
# dp=4 run "crashes" after 2 of 4 scenes (each scene's sharded trial
# batch was checkpointed shard-local as it completed)
run_streaming_mc(cfg, num_scenes=2, mesh=make_mesh(dp=4), dp_trials=True,
                 store=OrbaxFrameStore(ck), **kw)
print(f"   crashed dp=4 run persisted scenes "
      f"{OrbaxFrameStore(ck).frames_done()}")

# resume on HALF the devices: scenes 1-2 restore onto dp=2 shardings via
# explicit like=, scenes 3-4 compute fresh on the dp=2 mesh
res = run_streaming_mc(cfg, num_scenes=4, mesh=make_mesh(dp=2),
                       dp_trials=True, store=OrbaxFrameStore(ck), **kw)
full = run_streaming_mc(cfg, num_scenes=4, mesh=make_mesh(dp=4),
                        dp_trials=True, **kw)
assert res.total_detected == full.total_detected
np.testing.assert_array_equal(res.snr_bin_rate, full.snr_bin_rate)  # NaN==NaN
print(f"   elastic resume on dp=2: rate={res.detection_rate:.3f}, "
      f"detected {res.total_detected}/{res.total_targets} — bit-equal to "
      "the uninterrupted dp=4 run")

shutil.rmtree(root)
print("\nok")
