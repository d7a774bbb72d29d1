"""On-card check of the radar pipeline at the reference's full size.

Run on a host with one NVIDIA GPU:

    python chip_smoke.py              # phases 1-5 on one card
    python chip_smoke.py --four-gpus  # only the four-card phase

Phases (each prints its findings on lines of its own; any failure raises and
the script exits non-zero):

1. device    the GPU, its name and power limit (nvidia-smi), jax/jaxlib,
             XLA_FLAGS, the compile-cache directory.
2. flagship  ``make_frame_processor(perf_config())`` on the two-target frame
             (16 ch x 332 pulses x 5819 samples -> 332 x 3404 x 13 RDM ->
             12-pair GOCA-CFAR -> estimation -> clustering): compile time,
             memory analysis, 20 frames that must each find both targets;
             then the same check on the 64-ch x 256-pulse config.
3. parity    a) the exact path at f32 (Precision.HIGHEST) against the
             float64 NumPy oracle (tests/oracle.py): RDM and CFAR mask;
             b) the bf16-plane perf path against the same config at f32;
             c) the exact path's deviation when its matmuls run at default
             precision (TF32 on the GPU), as a finding.
4. stages    device time of each XLA stage of the perf path with its bytes
             and flops from shapes, and the whole frame under fori_loop.
5. served    ``run_multiframe`` over the five-target scene for 10 frames
             with host association (native/tracker.cpp): five confirmed
             tracks, per-frame wall time.

``--four-gpus``: ``make_dp_frame_processor`` over dp=4 on 8 full-size
frames and ``make_sharded_frame_processor`` over (ch=2, cpi=2), each
compared with the single-device run frame by frame.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402

# the two-target frame of bench.py: (range m, velocity m/s, elevation deg,
# SNR dB) per target
TWO_TARGETS = ([3000.0, 10000.0], [20.0, 25.0], [10.0, 10.0], [10.0, 15.0])
# the same two targets inside the 64-element bank's beam fan (-16..3.2 deg)
TWO_TARGETS_64 = ([3000.0, 10000.0], [20.0, 25.0], [-0.8, -4.8],
                  [10.0, 15.0])
# float32 at Precision.HIGHEST: ~6e-8 unit roundoff growing with the square
# root of the ~1e4-term contractions
EXACT_RDM_TOL = 1e-5
# relative distance from the CFAR threshold inside which f32-vs-f64 window
# sums may decide a cell differently
CFAR_MARGIN = 1e-5
# bf16 planes: ~2^-9 input quantization per operand
PERF_RDM_TOL = 1e-2


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(ok, msg) -> None:
    """A failed check (kept under ``python -O``, unlike ``assert``)."""
    if not ok:
        raise AssertionError(msg)


def _targets(truth):
    import jax.numpy as jnp

    from radar_tpu.sim.scenario import TargetBatch

    return TargetBatch(*[jnp.asarray(x, jnp.float32)
                         for x in TargetBatch.make(*truth)])


def _final_list(result):
    t = result.targets
    valid = np.asarray(t.valid, bool)
    return (np.asarray(t.range_m)[valid], np.asarray(t.velocity_ms)[valid],
            np.asarray(t.angle_deg)[valid])


def check_truth_found(result, truth, delta_r: float) -> None:
    """Every truth target has a final target within range 2*dR + 3 m,
    velocity 3 m/s and elevation 3 deg (tests/test_e2e.py tolerances)."""
    r, v, a = _final_list(result)
    for r_t, v_t, el_t, _ in zip(*truth):
        require(len(r), f"no final targets (truth R={r_t})")
        j = int(np.argmin(np.abs(r - r_t)))
        ok = (abs(r[j] - r_t) <= 2 * delta_r + 3.0
              and abs(v[j] - v_t) <= 3.0 and abs(a[j] - el_t) <= 3.0)
        require(ok, f"truth (R={r_t}, V={v_t}, El={el_t}) not found: "
                f"nearest (R={r[j]:.1f}, V={v[j]:.2f}, El={a[j]:.2f})")


def _memory_line(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis unavailable"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return " ".join(f"{f.replace('_size_in_bytes', '')}="
                    f"{getattr(ma, f, 0) / 2**20:.1f}MiB" for f in fields)


def _peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ----------------------------------------------------------------- phase 1
def phase_device(expect_count: int = 1):
    """Require a GPU and print what identifies the run."""
    import jax
    import jaxlib

    from radar_tpu.utils.device import (NVIDIA_SMI_QUERY, gpu_identity,
                                        require_gpu, setup_compile_cache)

    dev = require_gpu()
    n = len(jax.devices())
    require(n >= expect_count, f"need {expect_count} GPUs, JAX sees {n}")
    cards = gpu_identity()
    say("device", f"device_kind={dev.device_kind} count={n}")
    say("device", " ".join(NVIDIA_SMI_QUERY))
    for name, limit in cards:
        print(f"{name}, {limit}", flush=True)
    say("device", f"jax={jax.__version__} jaxlib={jaxlib.__version__}")
    say("device", f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    say("device", f"compile_cache={setup_compile_cache()}")
    return dev


# ----------------------------------------------------------------- phase 2
def phase_flagship(cfg, n_frames: int = 20, label: str = "perf",
                   truth=TWO_TARGETS) -> dict:
    """Compile the frame processor for ``cfg`` and require every one of
    ``n_frames`` frames (keys fold_in(0, i)) to find every truth target."""
    import jax

    from radar_tpu.pipeline.frame import make_frame_processor
    from radar_tpu.waveform.precompute import precompute

    pre = precompute(cfg)
    targets = _targets(truth)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    compiled = jax.jit(make_frame_processor(cfg, pre, jit=False)).lower(
        key, targets).compile()
    t_compile = time.perf_counter() - t0
    sig = cfg.sig
    say("flagship", f"{label}: {sig.channel_num}ch x {sig.prt_num}p x "
        f"{sig.point_prt}s compile_s={t_compile:.3f}")
    say("flagship", f"{label}: {_memory_line(compiled)}")
    raw = []
    for i in range(n_frames):
        res = compiled(jax.random.fold_in(key, i), targets)
        check_truth_found(res, truth, pre.delta_r)
        raw.append(int(res.num_raw_detections))
    peak = _peak_bytes(jax.devices()[0])
    say("flagship", f"{label}: {n_frames}/{n_frames} frames found all "
        f"{len(truth[0])} targets; raw detections {min(raw)}-{max(raw)}; "
        f"peak_bytes_in_use={peak}")
    return {"compile_s": t_compile, "peak_bytes": peak}


# ----------------------------------------------------------------- phase 3
def _rel_err(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _default_precision_rdm(raw, pre, cfg):
    """The exact path's DBF -> PC -> MTD on ``raw`` with every matmul at
    the backend's default precision (what the ops ran before they asked
    for Precision.HIGHEST)."""
    import jax
    import jax.numpy as jnp

    from radar_tpu.ops.dbf import dbf_weights_effective
    from radar_tpu.ops.mtd import make_mtd_matrix
    from radar_tpu.ops.pulse_compression import make_matmul_plan

    plan = make_matmul_plan(pre)
    m_mtd = make_mtd_matrix(pre.mtd_win, cfg.sig.prt_num, cfg.mtd_fft_len)

    @jax.jit
    def chain(x):
        w = dbf_weights_effective(jnp.asarray(pre.dbf_w, x.dtype),
                                  cfg.dbf_variant)
        beams = jnp.einsum("psc,bc->psb", x, w)
        pc = jnp.concatenate(
            [jnp.einsum("pwb,wj->pjb", beams[:, w0:w0 + wlen],
                        jnp.asarray(m, x.dtype))
             for w0, wlen, m in plan.chunks], axis=1)
        return jnp.einsum("vp,pgb->vgb", jnp.asarray(m_mtd, x.dtype), pc)

    return np.asarray(chain(jnp.asarray(raw, jnp.complex64)))


def phase_parity_exact(cfg, truth=TWO_TARGETS) -> dict:
    """(a) the exact f32 path on the device vs the float64 oracle, and
    (c) the same chain at default matmul precision."""
    import jax
    import jax.numpy as jnp
    from oracle import (dbf_oracle, goca_cfar_ratio_oracle, mtd_oracle,
                        pc_oracle)

    from radar_tpu.ops.cfar import goca_cfar_2d
    from radar_tpu.pipeline.frame import make_frame_processor
    from radar_tpu.waveform.precompute import precompute

    cfg = cfg.replace(matmul_precision="f32", fused_synth_dbf=False,
                      lowrank_rdm=False)
    pre = precompute(cfg)
    out = make_frame_processor(cfg, pre, return_intermediates=True)(
        jax.random.PRNGKey(7), _targets(truth))
    raw = np.asarray(out.raw_iq).astype(np.complex128)
    rdm_dev = np.asarray(out.rdm)
    rdm_ref = mtd_oracle(pc_oracle(dbf_oracle(raw, np.asarray(pre.dbf_w),
                                              cfg.dbf_variant), pre),
                         np.asarray(pre.mtd_win), cfg.mtd_fft_len)
    err = _rel_err(rdm_dev, rdm_ref)
    say("parity", f"a) exact path f32/HIGHEST vs float64 oracle: RDM "
        f"max|d|/max|RDM| = {err:.3e} (tolerance {EXACT_RDM_TOL:g})")
    require(err <= EXACT_RDM_TOL, f"exact-path RDM error {err:.3e}")

    c = cfg.cfar
    mag = np.abs(rdm_ref)
    maps_ref = mag[:, :, :-1] + mag[:, :, 1:]
    mask_ref, stat = goca_cfar_ratio_oracle(
        maps_ref, c.ref_cells_r, c.guard_cells_r, c.ref_cells_v,
        c.guard_cells_v, c.threshold_factor, c.method)
    near = np.abs(stat - 1.0) <= CFAR_MARGIN
    # the device CFAR on the oracle's maps: only f32 window sums differ
    mask_dev = np.asarray(jax.jit(lambda m: goca_cfar_2d(m, c)[0])(
        jnp.asarray(maps_ref, jnp.float32)))
    diff = mask_dev != mask_ref
    say("parity", f"a) CFAR on oracle maps: {int(mask_ref.sum())} oracle "
        f"detections, {int(diff.sum())} cells differ, all within "
        f"{CFAR_MARGIN:g} of the threshold: {bool(np.all(near[diff]))}")
    require(np.all(near[diff]), f"{int((diff & ~near).sum())} CFAR cells "
            "differ away from the threshold")
    # the whole device pipeline's mask (its own maps) for the record
    mask_pipe = np.asarray(jax.jit(lambda m: goca_cfar_2d(m, c)[0])(
        out.pair_maps))
    dp = mask_pipe != mask_ref
    worst = float(np.nanmax(np.abs(stat[dp] - 1.0))) if dp.any() else 0.0
    say("parity", f"a) CFAR of the device pipeline's own maps: "
        f"{int(dp.sum())} cells differ from the oracle, max |stat-1| among "
        f"them {worst:.3e}")

    err_tf32 = _rel_err(_default_precision_rdm(raw, pre, cfg), rdm_ref)
    say("parity", f"c) same chain at default matmul precision: RDM "
        f"max|d|/max|RDM| = {err_tf32:.3e}")
    return {"rdm_err": err, "cfar_diff": int(diff.sum()),
            "pipeline_cfar_diff": int(dp.sum()), "rdm_err_default": err_tf32}


def phase_parity_perf(cfg, truth=TWO_TARGETS) -> dict:
    """(b) the bf16-plane perf path vs the same config at f32, one key."""
    import jax

    from radar_tpu.pipeline.frame import make_frame_processor
    from radar_tpu.pipeline.lowrank import make_lowrank_stages
    from radar_tpu.waveform.precompute import precompute

    cfg_f = cfg.replace(matmul_precision="f32")
    pre = precompute(cfg)
    key, targets = jax.random.PRNGKey(11), _targets(truth)
    rdm_p, rdm_f = (np.asarray(jax.jit(make_lowrank_stages(c, pre).rdm)(
        key, targets)) for c in (cfg, cfg_f))
    err = _rel_err(rdm_p, rdm_f)
    say("parity", f"b) perf path bf16 planes vs f32: RDM max|d|/max|RDM| = "
        f"{err:.3e} (tolerance {PERF_RDM_TOL:g})")
    require(err <= PERF_RDM_TOL, f"perf-path RDM error {err:.3e}")
    (rp, vp, _), (rf, vf, _) = (
        _final_list(make_frame_processor(c, pre)(key, targets))
        for c in (cfg, cfg_f))
    require(len(rp) == len(rf), f"final targets differ: {rp} vs {rf}")
    for r, v in zip(rp, vp):
        j = int(np.argmin(np.abs(rf - r) / pre.delta_r
                          + np.abs(vf - v) / pre.delta_v))
        require(abs(rf[j] - r) <= pre.delta_r
                and abs(vf[j] - v) <= pre.delta_v,
                f"perf target (R={r}, V={v}) vs f32 ({rf[j]}, {vf[j]})")
    say("parity", f"b) same {len(rp)} final targets within one gate "
        f"({pre.delta_r:.2f} m) and one Doppler bin ({pre.delta_v:.3f} m/s)")
    return {"rdm_err": err, "n_final": len(rp)}


# ----------------------------------------------------------------- phase 4
def _time_call(fn, *args, reps: int = 20) -> float:
    """Median device seconds of ``fn(*args)`` after warm-up."""
    import jax

    for _ in range(3):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def stage_costs(cfg, pre, n_targets: int) -> dict:
    """Bytes moved (activations in + out) and flops (complex MAC = 8) of
    each XLA stage of the perf path, from shapes."""
    from radar_tpu.ops.pulse_compression import (compact_noise_plan,
                                                 make_matmul_plan)

    p, b = cfg.sig.prt_num, cfg.sig.beam_num
    v, g = cfg.mtd_fft_len or p, pre.n_total_gate
    plan, s_len = compact_noise_plan(make_matmul_plan(pre))
    c8 = 8  # complex64 bytes
    z, pcb, rdm = p * s_len * b * c8, p * g * b * c8, v * g * b * c8
    pc_flops = sum(8 * p * b * wlen * m.shape[1] for _, wlen, m in plan.chunks)
    return {
        "gen_noise": (z, 0),
        "pc": (z + pcb, pc_flops),
        "mtd": (pcb + rdm, 8 * v * p * g * b),
        "signal_rdm": (rdm, 8 * n_targets * v * g * b),
        "mix_add": (3 * rdm, 8 * v * g * b * b),
        "detection_tail": (rdm, 0),
    }


def phase_stages(cfg, truth=TWO_TARGETS, reps: int = 20,
                 loop_frames=(5, 25)) -> dict:
    """Time each stage of the XLA perf chain and the whole frame."""
    import jax

    from radar_tpu.bench.timing import frame_time_slope, make_frames_loop
    from radar_tpu.pipeline.frame import (make_detection_tail,
                                          make_frame_processor)
    from radar_tpu.pipeline.lowrank import make_lowrank_stages
    from radar_tpu.waveform.precompute import precompute

    pre = precompute(cfg)
    lr = make_lowrank_stages(cfg, pre)
    key, targets = jax.random.PRNGKey(3), _targets(truth)
    tail = jax.jit(lambda r: make_detection_tail(cfg, pre)(r)[0])
    z = jax.jit(lr.gen_noise)(key)
    pc = jax.jit(lr.pc)(z)
    rz = jax.jit(lr.mtd)(pc)
    sig = jax.jit(lr.signal_rdm)(targets)
    rdm = jax.jit(lr.mix_add)(sig, rz)
    calls = {
        "gen_noise": (jax.jit(lr.gen_noise), (key,)),
        "pc": (jax.jit(lr.pc), (z,)),
        "mtd": (jax.jit(lr.mtd), (pc,)),
        "signal_rdm": (jax.jit(lr.signal_rdm), (targets,)),
        "mix_add": (jax.jit(lr.mix_add), (sig, rz)),
        "detection_tail": (tail, (rdm,)),
    }
    costs = stage_costs(cfg, pre, len(truth[0]))
    out = {}
    for name, (fn, args) in calls.items():
        t = _time_call(fn, *args, reps=reps)
        nbytes, flops = costs[name]
        out[name] = {"ms": 1e3 * t, "bytes": nbytes, "flops": flops}
        say("stages", f"{name:15s} {1e3 * t:9.4f} ms  bytes={nbytes:.4e} "
            f"({nbytes / t / 1e9:8.1f} GB/s)  flops={flops:.4e} "
            f"({flops / t / 1e12:7.2f} TFLOP/s)")
    loop = make_frames_loop(make_frame_processor(cfg, pre, jit=False),
                            targets)
    dt, slopes = frame_time_slope(loop, *loop_frames, pairs=3)
    out["frame"] = {"ms": 1e3 * dt}
    say("stages", f"whole frame (fori_loop slope) {1e3 * dt:.4f} ms = "
        f"{1 / dt:.2f} frames/s; slopes_ms="
        f"{[round(1e3 * s, 4) for s in slopes]}")
    return out


# ----------------------------------------------------------------- phase 5
def phase_served(cfg, n_frames: int = 10, scene=None,
                 min_coverage: float = 0.5) -> dict:
    """``run_multiframe`` with host association; every truth of the scene
    must own a confirmed track (matched, covering >= ``min_coverage`` of
    the frames)."""
    import jax

    from radar_tpu.native import load_library
    from radar_tpu.pipeline.driver import associate_tracks, run_multiframe
    from radar_tpu.pipeline.frame import make_frame_processor
    from radar_tpu.pipeline.track_metrics import score_tracks
    from radar_tpu.sim.scenario import five_target_scene

    require(load_library() is not None, "native tracker did not build")
    scene = five_target_scene() if scene is None else scene
    proc = make_frame_processor(cfg)
    jax.block_until_ready(proc(jax.random.PRNGKey(0), _targets(
        [np.asarray(x) for x in scene])))                       # compile
    t0 = time.perf_counter()
    log, tracks, _ = run_multiframe(cfg, scene, n_frames, seed=0,
                                    processor=proc, kinematics="simple")
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    associate_tracks(log, cfg)
    t_assoc = time.perf_counter() - t0
    sc = score_tracks(log, tracks, scene, n_frames, cfg, kinematics="simple")
    confirmed = int(np.sum(sc.truth_detected
                           & (sc.truth_coverage >= min_coverage)))
    say("served", f"{n_frames} frames: {len(log)} detections -> "
        f"{len(tracks)} tracks; confirmed {confirmed}/{sc.n_truth}; "
        f"coverage={np.round(sc.truth_coverage, 2).tolist()} "
        f"false={sc.false_tracks}")
    say("served", f"wall {wall:.3f} s = {1e3 * wall / n_frames:.2f} ms/frame "
        f"(device + transfer + host log), association {1e3 * t_assoc:.3f} ms")
    require(confirmed == sc.n_truth,
            f"{confirmed} of {sc.n_truth} truths own a confirmed track")
    return {"ms_per_frame": 1e3 * wall / n_frames, "confirmed": confirmed}


# ------------------------------------------------------------ four cards
def phase_four(cfg_perf, cfg_exact, n_frames: int = 8,
               truth=TWO_TARGETS) -> None:
    """dp=4 batch and (ch=2, cpi=2) sharded frame vs single device."""
    import jax

    from radar_tpu.parallel.dp import broadcast_targets, make_dp_frame_processor
    from radar_tpu.parallel.mesh import make_mesh
    from radar_tpu.parallel.sharded import make_sharded_frame_processor
    from radar_tpu.pipeline.frame import (assert_same_result,
                                          make_frame_processor)
    from radar_tpu.waveform.precompute import precompute

    targets = _targets(truth)
    key = jax.random.PRNGKey(5)
    pre = precompute(cfg_perf)
    keys = jax.numpy.stack([jax.random.fold_in(key, i)
                            for i in range(n_frames)])
    proc_dp = make_dp_frame_processor(cfg_perf, make_mesh(dp=4), pre)
    out = jax.block_until_ready(proc_dp(keys, broadcast_targets(targets,
                                                                n_frames)))
    single = make_frame_processor(cfg_perf, pre)
    for i in range(n_frames):
        assert_same_result(jax.tree.map(lambda x: x[i], out),
                           single(keys[i], targets), ("dp", i))
    say("four", f"dp=4 over {n_frames} frames: every frame matches the "
        f"single-device run; raw="
        f"{[int(x) for x in out.num_raw_detections]}")

    pre_x = precompute(cfg_exact)
    got = make_sharded_frame_processor(cfg_exact, make_mesh(ch=2, cpi=2),
                                       pre_x)(key, targets)
    assert_same_result(got, make_frame_processor(cfg_exact, pre_x)(
        key, targets), "sharded")
    say("four", f"sharded (ch=2, cpi=2) exact path matches the single-device "
        f"run: raw={int(got.num_raw_detections)} final={int(got.num_final)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card dp / sharded phase")
    args = ap.parse_args(argv)

    import jax

    from radar_tpu.config.params import full_config, perf_config, scaled_config

    dev = phase_device(expect_count=4 if args.four_gpus else 1)
    if args.four_gpus:
        phase_four(perf_config(), full_config())
    else:
        phase_flagship(perf_config(), label="perf 16ch")
        phase_flagship(perf_config(scaled_config(64, 256)), n_frames=1,
                       label="perf 64ch", truth=TWO_TARGETS_64)
        phase_parity_exact(full_config())
        phase_parity_perf(perf_config())
        phase_stages(perf_config())
        phase_served(perf_config())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
