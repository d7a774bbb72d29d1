"""Single-frame processing pipeline (the reference's
``fun_process_single_frame``, SURVEY.md section 3.2), end-to-end under one
jit:

  echo synthesis -> AWGN -> DBF -> segmented pulse compression -> MTD ->
  2D GOCA-CFAR -> spline/monopulse parameter estimation -> intra-beam
  clustering -> inter-beam clustering

``make_frame_processor`` closes over all derived constants (waveform, matched
filters, DBF bank, axes, spline stencils) so the compiled program embeds them
as XLA constants; the only runtime inputs are the PRNG key and the per-frame
target state arrays — the host/device boundary sits exactly between scenario
evolution (host, sim/scenario.py) and this function (device), per SURVEY.md
section 3.1.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..cluster.stages import ClusteredTargets, cluster_stage1, cluster_stage2
from ..config.params import RadarConfig
from ..measure.estimate import ParamDetections, estimate_parameters
from ..ops.cfar import (Detections, extract_detections, goca_cfar_2d,
                        pair_sum_maps)
from ..ops.dbf import dbf
from ..ops.mtd import make_mtd_matrix, mtd, mtd_matmul
from ..ops.pulse_compression import (make_matmul_plan, make_plan,
                                     pulse_compress, pulse_compress_matmul)
from ..sim.echo import (add_noise, add_noise_beamspace, beam_noise_factor,
                        synthesize_echo_beams, synthesize_echoes)
from ..sim.scenario import TargetBatch
from ..waveform.precompute import Precomputed, precompute


class MeasureConsts(NamedTuple):
    """Device-side constants consumed by measure/estimate.py."""

    range_axis: jnp.ndarray
    velocity_axis: jnp.ndarray
    delta_r: float
    delta_v: float
    beam_angles_deg: jnp.ndarray
    k_slopes_lut: jnp.ndarray
    q_range: jnp.ndarray
    q_vel: jnp.ndarray


class FrameResult(NamedTuple):
    """Final per-frame output (ref ``final_targets``) plus diagnostics."""

    targets: ClusteredTargets
    num_raw_detections: jnp.ndarray   # int32 (true count, may exceed capacity)
    num_final: jnp.ndarray            # int32


class FrameIntermediates(NamedTuple):
    """Optional stage taps for debug harnesses / golden tests (the formalized
    version of debug_simulated_data_processing.m's stage checklist)."""

    raw_iq: jnp.ndarray
    beams: jnp.ndarray
    pc: jnp.ndarray
    rdm: jnp.ndarray
    pair_maps: jnp.ndarray
    detections: Detections
    params: ParamDetections
    stage1: ClusteredTargets
    result: FrameResult


def measure_consts(cfg: RadarConfig, precomp: Precomputed,
                   real_dtype) -> MeasureConsts:
    n_dop = cfg.mtd_fft_len or cfg.sig.prt_num
    if n_dop == cfg.sig.prt_num:
        vel_axis = precomp.velocity_axis
        delta_v = precomp.delta_v
    else:
        # zero-padded MTD variant (v7_7:150): axis respans the same ambiguity
        # window over n_dop bins
        v_max = cfg.sig.v_max
        vel_axis = np.linspace(-v_max / 2, v_max / 2, n_dop)
        delta_v = v_max / n_dop
    return MeasureConsts(
        range_axis=np.asarray(precomp.range_axis, real_dtype),
        velocity_axis=np.asarray(vel_axis, real_dtype),
        delta_r=float(precomp.delta_r),
        delta_v=float(delta_v),
        beam_angles_deg=np.asarray(precomp.beam_angles_deg, real_dtype),
        k_slopes_lut=np.asarray(precomp.k_slopes_lut, real_dtype),
        q_range=np.asarray(precomp.q_range, real_dtype),
        q_vel=np.asarray(precomp.q_vel, real_dtype),
    )


def make_detection_tail(cfg: RadarConfig, precomp: Precomputed,
                        real_dtype=jnp.float32, keep_maps: bool = False):
    """The detection half of the frame: ``tail(rdm [V, G, B]) ->
    (FrameResult, (pair_maps, detections, params, stage1))`` running
    pair-sum -> 2D GOCA-CFAR -> extraction -> spline/monopulse estimation ->
    two-stage clustering. ``keep_maps`` forces the materialized pair-sum
    maps (the ``return_intermediates`` tap) even under ``tail_from_rdm``."""
    mc = measure_consts(cfg, precomp, real_dtype)
    ip = cfg.interp
    # maps-free tail: amplitudes/stencils gather pointwise from the RDM
    # (identical values); the pair-sum cube then feeds ONLY the CFAR box
    # filters, so XLA can fuse it away instead of writing it
    tfr = (cfg.tail_from_rdm and cfg.extract_impl == "direct"
           and not cfg.extract_native_scan and not keep_maps)
    if cfg.tail_from_rdm and (cfg.extract_impl != "direct"
                              or cfg.extract_native_scan):
        import warnings

        warnings.warn(
            "cfg.tail_from_rdm is ignored unless extract_impl='direct' and "
            "extract_native_scan=False: falling back to the materialized-"
            "maps tail", stacklevel=3)

    def tail(rdm):
        maps = pair_sum_maps(rdm)
        mask, _ = goca_cfar_2d(maps, cfg.cfar)
        dets = extract_detections(mask, None if tfr else maps,
                                  cfg.cfar.max_detections,
                                  native_scan=cfg.extract_native_scan,
                                  impl=cfg.extract_impl,
                                  rdm=rdm if tfr else None)
        params = estimate_parameters(
            dets, None if tfr else maps, rdm, mc, ip.extra_dots,
            ip.r_interp_times, ip.v_interp_times,
            monopulse_complex=cfg.monopulse_complex,
            monopulse_refined=cfg.monopulse_refined)
        s1 = cluster_stage1(params, cfg.cluster)
        final = cluster_stage2(s1, cfg.cluster)
        result = FrameResult(targets=final, num_raw_detections=dets.count,
                             num_final=final.count.astype(jnp.int32))
        return result, (maps, dets, params, s1)

    return tail


def make_frame_processor(cfg: RadarConfig, precomp: Precomputed | None = None,
                         dtype=jnp.complex64, return_intermediates=False,
                         jit: bool = True):
    """Build the jitted frame processor.

    Returns ``process(key, targets: TargetBatch) -> FrameResult`` (or
    ``FrameIntermediates`` when ``return_intermediates``)."""
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
    fused = cfg.fused_synth_dbf and not return_intermediates
    if fused:
        from ..ops.dbf import dbf_weights_effective_np

        w_eff = dbf_weights_effective_np(dbf_w, cfg.dbf_variant)
        mix_np = np.ascontiguousarray(w_eff.T)        # [C,B]
        l_np = beam_noise_factor(w_eff)               # [B,B]

    lowrank = cfg.lowrank_rdm and fused
    if lowrank:
        from .lowrank import make_lowrank_stages

        lr = make_lowrank_stages(cfg, precomp, dtype)

    tail = make_detection_tail(cfg, precomp, real_dtype,
                               keep_maps=return_intermediates)

    def process(key, targets: TargetBatch):
        if lowrank:
            # rank-K deterministic RDM + post-MTD noise mixing
            rdm = lr.rdm(key, targets)
        elif fused:
            sig_beams = synthesize_echo_beams(targets, precomp, cfg, mix_np,
                                              dtype=dtype)
            beams = add_noise_beamspace(key, sig_beams, l_np)
        else:
            raw = synthesize_echoes(targets, precomp, cfg, dtype=dtype)
            noisy = add_noise(key, raw)
            beams = dbf(noisy, dbf_w, cfg.dbf_variant)
        if not lowrank:
            if mplan is not None:
                pc = pulse_compress_matmul(beams, mplan,
                                           precision=cfg.matmul_precision)
            else:
                pc = pulse_compress(beams, precomp, plan)
            rdm = (mtd_matmul(pc, mtd_mat, precision=cfg.matmul_precision)
                   if mtd_mat is not None
                   else mtd(pc, mtd_win, cfg.mtd_fft_len))
        result, (maps, dets, params, s1) = tail(rdm)
        if return_intermediates:
            return FrameIntermediates(raw_iq=noisy, beams=beams, pc=pc,
                                      rdm=rdm, pair_maps=maps,
                                      detections=dets, params=params,
                                      stage1=s1, result=result)
        return result

    return jax.jit(process) if jit else process


def assert_same_result(got: FrameResult, want: FrameResult, name="",
                       rtol: float = 1e-3, atol: float = 1e-3) -> None:
    """Full-field FrameResult equality: detection counts exact, valid mask
    exact, range/velocity/angle/power to ``rtol``/``atol`` — the check a
    sharded or batched run must pass against the single-device run of the
    same frame."""
    for f in ("num_raw_detections", "num_final"):
        g, w = int(getattr(got, f)), int(getattr(want, f))
        if g != w:
            raise AssertionError(f"{name} {f}: {g} != {w}")
    gv = np.asarray(got.targets.valid, bool)
    np.testing.assert_array_equal(gv, np.asarray(want.targets.valid, bool),
                                  err_msg=str(name))
    for f in ("range_m", "velocity_ms", "angle_deg", "power"):
        np.testing.assert_allclose(
            np.asarray(getattr(got.targets, f))[gv],
            np.asarray(getattr(want.targets, f))[gv],
            rtol=rtol, atol=atol, err_msg=f"{name} {f}")
