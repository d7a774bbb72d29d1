"""Tutorial: multi-device execution — meshes, shardings, collectives.

The reference is strictly single-process (MATLAB; its only parallelism is
a shared-nothing `parfor` over Monte-Carlo trials,
main_plot_snr_vs_angle_error.m:167). This framework instead scales along
the physical axes of the problem via a `jax.sharding.Mesh`:

  dp   — data parallel: independent frames/trials (no collectives)
  ch   — array channels: synthesis + DBF partial-sums psum-reduced
  cpi  — slow time / range: all_to_all axis swaps between PC and MTD

This tutorial runs everything on 8 VIRTUAL CPU devices (the same
mechanism the test suite and the driver's dryrun use), so it works on
any machine; on a multi-GPU host the identical code spans the cards, and
XLA hands the collectives to NCCL.

It shows, smallest to largest:
  1. the communication patterns one at a time as explicit shard_map
     collectives (parallel/collectives.py) — psum DBF, halo-exchange
     overlap-save PC, all_to_all MTD;
  2. the complete frame pipeline GSPMD-sharded over (ch, cpi) with
     single-device parity (parallel/sharded.py);
  3. a dp-sharded frame batch and the dp x (ch, cpi) composition — dp
     across hosts, model axes within a host (parallel/dp.py).

Run: python examples/07_multichip_sharding.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# 8 virtual CPU devices MUST be requested before jax initializes
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from radar_tpu.config.params import (CfarParams, ClusterParams, RadarConfig,
                                     SigConfig)
from radar_tpu.parallel.collectives import (dbf_channel_sharded,
                                            mtd_cpi_sharded,
                                            pulse_compress_range_sharded)
from radar_tpu.parallel.dp import (make_dp_frame_processor,
                                   make_dp_sharded_frame_processor)
from radar_tpu.parallel.mesh import make_mesh
from radar_tpu.parallel.sharded import make_sharded_frame_processor
from radar_tpu.pipeline.frame import make_frame_processor
from radar_tpu.sim.scenario import TargetBatch
from radar_tpu.waveform.precompute import precompute

print(f"devices: {len(jax.devices())} x {jax.devices()[0].device_kind}")

# A tiny-but-complete config (8 ch, 16 pulses, full fast-time geometry) —
# the same shapes the driver's dryrun_multichip validates.
cfg = RadarConfig(
    sig=SigConfig(prt_num=16, channel_num=8, beam_num=5),
    cfar=CfarParams(ref_cells_v=2, guard_cells_v=2, ref_cells_r=5,
                    guard_cells_r=10, max_detections=64),
    cluster=ClusterParams(max_clusters=32),
)
pre = precompute(cfg)
targets = TargetBatch.make([3000.0], [10.0], [5.0], [20.0])
targets = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), targets)
key = jax.random.PRNGKey(0)

# ----------------------------------------------------------------------
# 1) The collectives, one at a time.
# ----------------------------------------------------------------------
print("\n== 1. explicit collectives (shard_map) ==")

# 1a. Channel-sharded DBF: each device holds a block of channels, computes
#     its partial beam sum, and the beams are psum-reduced across 'ch'.
mesh_ch = make_mesh(ch=8)
rng = np.random.default_rng(1)
iq = jnp.asarray(rng.normal(size=(16, 128, 8))
                 + 1j * rng.normal(size=(16, 128, 8)), jnp.complex64)
w = jnp.asarray(np.asarray(pre.dbf_w)[:5, :8], jnp.complex64)
beams = dbf_channel_sharded(mesh_ch, variant="v8")(iq, w)
print(f"dbf psum over ch=8: iq{tuple(iq.shape)} -> beams{tuple(beams.shape)}")

# 1b. Range-sharded overlap-save pulse compression: each shard convolves
#     its block of fast-time samples, importing the trailing len(h)-1
#     samples of its LEFT neighbor over a ppermute ring (the
#     ring-attention analog).
mesh_r = make_mesh(cpi=8)
h = np.asarray(pre.tx_pulse, np.complex64)[:33]
x = jnp.asarray(rng.normal(size=(4, 512))
                + 1j * rng.normal(size=(4, 512)), jnp.complex64)
y = pulse_compress_range_sharded(mesh_r, h, nfft=256, axis="cpi")(x)
want = np.stack([np.convolve(np.asarray(x)[i], h)[:512] for i in range(4)])
np.testing.assert_allclose(np.asarray(y), want, rtol=2e-4, atol=2e-4)
print(f"overlap-save PC over range=8 shards: halo={len(h) - 1} samples, "
      "matches np.convolve")

# 1c. CPI-sharded MTD: the slow-time FFT needs all pulses per gate, but
#     pulses are sharded — an all_to_all swaps the sharded axis from
#     pulses to gates (Ulysses-style), FFTs locally, and swaps back.
mesh_cpi = make_mesh(cpi=8)
pc = jnp.asarray(rng.normal(size=(16, 256, 5))
                 + 1j * rng.normal(size=(16, 256, 5)), jnp.complex64)
rdm = mtd_cpi_sharded(mesh_cpi, np.asarray(pre.mtd_win)[:16])(pc)
print(f"mtd all_to_all over cpi=8: pc{tuple(pc.shape)} -> "
      f"rdm{tuple(rdm.shape)}")

# ----------------------------------------------------------------------
# 2) The whole frame pipeline, GSPMD-sharded.
# ----------------------------------------------------------------------
print("\n== 2. full frame pipeline sharded over (ch=2, cpi=2) ==")
# Here we annotate shardings and let XLA insert the same collectives
# automatically (parallel/sharded.py documents the per-stage layout).
mesh = make_mesh(dp=2, ch=2, cpi=2)
sharded = make_sharded_frame_processor(cfg, mesh, pre, dtype=jnp.complex64)
res_sh = jax.block_until_ready(sharded(key, targets))
res_1d = jax.block_until_ready(make_frame_processor(cfg, pre)(key, targets))
assert int(res_sh.num_final) == int(res_1d.num_final)
np.testing.assert_allclose(
    np.asarray(res_sh.targets.range_m)[np.asarray(res_sh.targets.valid)],
    np.asarray(res_1d.targets.range_m)[np.asarray(res_1d.targets.valid)],
    rtol=1e-3)
print(f"sharded == single-device: {int(res_sh.num_final)} target at "
      f"R={float(res_sh.targets.range_m[0]):.0f} m (truth 3000 m)")

# ----------------------------------------------------------------------
# 3) Data parallelism and the dp x model composition.
# ----------------------------------------------------------------------
print("\n== 3. dp batch + dp x (ch,cpi) composition ==")
# 3a. Pure dp: 8 independent frames, one per device. Each entry of the
#     batch gets its own PRNG key — trials stay statistically independent
#     by construction (SURVEY 5.2).
mesh_dp = make_mesh(dp=8)
proc_dp = make_dp_frame_processor(cfg, mesh_dp, pre)
keys = jnp.stack([jax.random.fold_in(key, i) for i in range(8)])
tb = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (8,) + x.shape),
                  targets)
out = jax.block_until_ready(proc_dp(keys, tb))
print(f"dp=8 frame batch: raw={[int(v) for v in out.num_raw_detections]}")

# 3b. The composition: the batch axis sharded over dp, each frame
#     internally sharded over (ch, cpi).
proc_comp = make_dp_sharded_frame_processor(cfg, mesh, pre)
keys4 = jnp.stack([jax.random.fold_in(key, 100 + i) for i in range(4)])
tb4 = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (4,) + x.shape),
                   targets)
out4 = jax.block_until_ready(proc_comp(keys4, tb4))
print(f"dp=2 x (ch=2,cpi=2): batch 4, "
      f"raw={[int(v) for v in out4.num_raw_detections]}")

print("\nOn real hardware: the same code over jax.distributed processes "
      "spans hosts (scripts/run_multiprocess.py runs it for real across "
      "2 coordinator-joined processes with bit-exact statistics).")
