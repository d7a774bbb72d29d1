"""GSPMD-annotated multi-device frame pipeline (SURVEY.md section 2.3).

The scaling-book recipe: pick a mesh (parallel/mesh.py), annotate stage
boundaries with sharding constraints, and let XLA insert the collectives:

  stage                 layout [axes]                   collective into it
  -----------------------------------------------------------------------
  raw IQ  [P, S, C]     P=(dp,cpi)-sharded, C=ch-sharded   (generated in place)
  DBF     [P, S, B]     P=(dp,cpi)-sharded, B replicated   psum over ch
                                                           (channel combine)
  PC      [P, G, B]     P=(dp,cpi)-sharded                 none (pulse-parallel)
  MTD     [P', G, B]    G=(dp,cpi,ch)-sharded              all_to_all transpose
                                                           (slow-time gather)
  CFAR    [P', G, Bp]   G-sharded                          halo exchange for
                                                           the range window
  extract/measure/cluster: replicated                      all_gather (small)

The channel axis of the echo cube is genuinely channel-sharded: each device
synthesizes + adds noise for its own element block, so raw-IQ memory scales
down with the ch axis. Explicit shard_map equivalents of the interesting
collectives live in parallel/collectives.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..cluster.stages import cluster_stage1, cluster_stage2
from ..config.params import RadarConfig
from ..measure.estimate import estimate_parameters
from ..ops.cfar import extract_detections, goca_cfar_2d, pair_sum_maps
from ..ops.dbf import dbf
from ..ops.mtd import make_mtd_matrix, mtd, mtd_matmul
from ..ops.pulse_compression import (make_matmul_plan, make_plan,
                                     pulse_compress, pulse_compress_matmul)
from ..pipeline.frame import FrameResult, measure_consts
from ..sim.echo import add_noise, synthesize_echoes
from ..sim.scenario import TargetBatch
from ..waveform.precompute import Precomputed, precompute
from .mesh import AXIS_CH, AXIS_CPI, AXIS_DP


def make_sharded_frame_processor(cfg: RadarConfig, mesh: Mesh,
                                 precomp: Precomputed | None = None,
                                 dtype=jnp.complex64, jit: bool = True,
                                 frame_axes: tuple = (AXIS_DP, AXIS_CPI)):
    """Jitted ``process(key, targets) -> FrameResult`` sharded over ``mesh``.
    Results match the single-device pipeline (collectives only change *where*
    values are computed).

    ``frame_axes``: mesh axes the frame's pulse/gate dimensions shard over
    (default dp+cpi). The dp x model-parallel composition
    (:func:`radar_tpu.parallel.dp.make_dp_sharded_frame_processor`) passes
    ``(AXIS_CPI,)`` so the dp axis is free to carry the frame-batch
    dimension instead. ``jit=False`` returns the raw traceable fn (for
    vmapping in that composition)."""
    if precomp is None:
        precomp = precompute(cfg)
    plan = make_plan(precomp)
    mplan = make_matmul_plan(precomp) if cfg.pc_method == "matmul" else None
    real_dtype = jnp.finfo(dtype).dtype
    # host numpy constants, embedded in the compiled program at trace time
    dbf_w = np.asarray(precomp.dbf_w)
    mtd_win = np.asarray(precomp.mtd_win, real_dtype)
    mtd_mat = (make_mtd_matrix(precomp.mtd_win, cfg.sig.prt_num,
                               cfg.mtd_fft_len)
               if cfg.mtd_method == "matmul" else None)
    mc = measure_consts(cfg, precomp, real_dtype)
    ip = cfg.interp

    pulse_axes = tuple(frame_axes)
    cube_spec = NamedSharding(mesh, P(pulse_axes, None, AXIS_CH))
    beams_spec = NamedSharding(mesh, P(pulse_axes, None, None))
    # gates shard over the SAME axis group as pulses: the pulses->gates
    # reshard then maps onto an all_to_all within fixed device groups; adding
    # the ch axis here forces GSPMD into a full rematerialization
    # ("involuntary full remat" warning) because the source is ch-replicated
    gate_spec = NamedSharding(mesh, P(None, pulse_axes, None))
    repl = NamedSharding(mesh, P())
    cs = jax.lax.with_sharding_constraint

    lowrank = cfg.lowrank_rdm and cfg.fused_synth_dbf
    if lowrank:
        from ..pipeline.lowrank import make_lowrank_stages

        lr = make_lowrank_stages(cfg, precomp, dtype)

    def process(key, targets: TargetBatch):
        if lowrank:
            # lowrank sharding: there is no channel cube to ch-shard — the
            # white beam-noise cube shards over pulses (dp,cpi); PC is
            # pulse-parallel; the pulses->gates reshard (all_to_all) feeds
            # the slow-time MTD matmul; mixing/signal-add are gate-sharded
            rdm_sig = lr.signal_rdm(targets)        # tiny rank-K, replicated
            z = cs(lr.gen_noise(key), beams_spec)
            pc_z = cs(lr.pc(z), beams_spec)
            pc_z = cs(pc_z, gate_spec)              # Ulysses-style swap
            rdm_z = cs(lr.mtd(pc_z), gate_spec)
            rdm = cs(lr.mix_add(cs(rdm_sig, gate_spec), rdm_z), gate_spec)
        else:
            raw = synthesize_echoes(targets, precomp, cfg, dtype=dtype)
            raw = cs(raw, cube_spec)
            noisy = add_noise(key, raw)
            noisy = cs(noisy, cube_spec)
            beams = cs(dbf(noisy, dbf_w, cfg.dbf_variant), beams_spec)
            pc_out = (pulse_compress_matmul(beams, mplan)
                      if mplan is not None
                      else pulse_compress(beams, precomp, plan))
            pc = cs(pc_out, beams_spec)
            # reshard pulses->gates for the slow-time FFT (Ulysses swap)
            pc = cs(pc, gate_spec)
            rdm = cs(mtd_matmul(pc, mtd_mat) if mtd_mat is not None
                     else mtd(pc, mtd_win, cfg.mtd_fft_len), gate_spec)
        maps = cs(pair_sum_maps(rdm), gate_spec)
        mask, _ = goca_cfar_2d(maps, cfg.cfar)
        # detection extraction & everything after is tiny: replicate
        mask = cs(mask, repl)
        maps = cs(maps, repl)
        rdm = cs(rdm, repl)
        dets = extract_detections(mask, maps, cfg.cfar.max_detections,
                                  impl=cfg.extract_impl)
        params = estimate_parameters(
            dets, maps, rdm, mc, ip.extra_dots, ip.r_interp_times,
            ip.v_interp_times, monopulse_complex=cfg.monopulse_complex,
                monopulse_refined=cfg.monopulse_refined)
        s1 = cluster_stage1(params, cfg.cluster)
        final = cluster_stage2(s1, cfg.cluster)
        return FrameResult(targets=final, num_raw_detections=dets.count,
                           num_final=final.count.astype(jnp.int32))

    return jax.jit(process) if jit else process
