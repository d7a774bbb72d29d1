"""Multi-frame simulation driver + inter-frame track association
(SURVEY.md L6/L9; reference main_simulate_echoes_with_array_v8_3.m).

Host side owns the frame loop and scenario evolution (v8_3:200-248); each
frame's device work is one call of the jitted frame processor. Final targets
are accumulated into a cumulative detection log with the frame index and
servo azimuth injected (v8_3:236-246), then associated into tracks by 5D BFS
clustering (v8_3:253-335) with the reference's hybrid merge: winner-take-all
(by power) for range/velocity/elevation/power, power-weighted mean azimuth,
and First/Last frame + point-count statistics.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import numpy as np

from ..cluster.connected import connected_components_np
from ..config.params import RadarConfig
from ..sim.scenario import Scenario, TargetBatch
from .frame import make_frame_processor


@dataclasses.dataclass
class DetectionLog:
    """Cumulative final-target log (ref ``cumulative_final_log``);
    struct-of-arrays, one row per final target per frame."""

    range_m: np.ndarray
    velocity_ms: np.ndarray
    elevation_deg: np.ndarray
    power: np.ndarray
    frame: np.ndarray        # int, 1-based like the reference's iFrame
    azimuth_deg: np.ndarray  # servo azimuth at that frame (iAntAngle)

    @staticmethod
    def empty() -> "DetectionLog":
        z = np.zeros(0)
        return DetectionLog(z, z, z, z, np.zeros(0, int), z)

    def __len__(self) -> int:
        return len(self.range_m)

    def append_frame(self, result, frame_idx: int, azimuth_deg: float):
        t = result.targets
        valid = np.asarray(t.valid)
        n = int(valid.sum())
        self.range_m = np.concatenate(
            [self.range_m, np.asarray(t.range_m)[valid]])
        self.velocity_ms = np.concatenate(
            [self.velocity_ms, np.asarray(t.velocity_ms)[valid]])
        self.elevation_deg = np.concatenate(
            [self.elevation_deg, np.asarray(t.angle_deg)[valid]])
        self.power = np.concatenate([self.power, np.asarray(t.power)[valid]])
        self.frame = np.concatenate([self.frame, np.full(n, frame_idx)])
        self.azimuth_deg = np.concatenate(
            [self.azimuth_deg, np.full(n, azimuth_deg)])

    def append_rows(self, saved: dict, frame_idx: int):
        """Replay checkpointed measurement rows (resume path of
        ``run_multiframe``): ``saved`` holds the per-frame arrays written
        by the "measurements" stage."""
        n = len(saved["range_m"])
        self.range_m = np.concatenate([self.range_m, saved["range_m"]])
        self.velocity_ms = np.concatenate(
            [self.velocity_ms, saved["velocity_ms"]])
        self.elevation_deg = np.concatenate(
            [self.elevation_deg, saved["elevation_deg"]])
        self.power = np.concatenate([self.power, saved["power"]])
        self.frame = np.concatenate([self.frame, np.full(n, frame_idx)])
        self.azimuth_deg = np.concatenate(
            [self.azimuth_deg, saved["azimuth_deg"]])


class Track(NamedTuple):
    """ref ``final_tracks_log`` entry (v8_3:310,327-334)."""

    range_m: float
    velocity_ms: float
    elevation_deg: float
    azimuth_deg: float
    power: float
    first_frame: int
    last_frame: int
    num_points: int
    member_idx: np.ndarray   # log rows of this track (for plots/tests)

    @property
    def height_m(self) -> float:
        """Target altitude H = R*sin(El) — the v7_7 stage-2 derived field
        (main_simulate_echoes_with_array_v7_7.m:847)."""
        return self.range_m * float(np.sin(np.deg2rad(self.elevation_deg)))


def associate_tracks(log: DetectionLog, cfg: RadarConfig) -> list[Track]:
    """5D BFS association over the cumulative log (v8_3:276-335)."""
    n = len(log)
    if n == 0:
        return []
    ifc = cfg.inter_frame
    gate_vals = (ifc.gate_r(cfg.cluster), ifc.gate_v(cfg.cluster),
                 ifc.gate_az_deg, ifc.gate_el(cfg.cluster),
                 float(ifc.max_frame_gap))
    # fast path: native C++ spatial-hash BFS (radar_tpu/native); identical
    # partition and component order to the dense numpy BFS fallback. The
    # wrap_azimuth variant needs the circular azimuth metric the native
    # engine does not implement — it takes the numpy path.
    from ..native import associate_tracks_5d_native

    comp = None
    if not ifc.wrap_azimuth:
        comp = associate_tracks_5d_native(log.range_m, log.velocity_ms,
                                          log.azimuth_deg,
                                          log.elevation_deg,
                                          log.frame, gate_vals)
    if comp is None:
        gates = [
            (log.range_m, gate_vals[0]),
            (log.velocity_ms, gate_vals[1]),
            (log.azimuth_deg, gate_vals[2]),
            (log.elevation_deg, gate_vals[3]),
            (log.frame.astype(float), gate_vals[4]),
        ]
        adj = np.ones((n, n), dtype=bool)
        for i, (f, g) in enumerate(gates):
            d = np.abs(f[:, None] - f[None, :])
            if i == 2 and ifc.wrap_azimuth:
                d = np.minimum(d, 360.0 - d)   # circular distance
            adj &= d <= g
        comp = connected_components_np(adj)

    tracks = []
    for cid in range(comp.max() + 1):
        m = np.nonzero(comp == cid)[0]
        powers = log.power[m]
        total = powers.sum()
        w = int(np.argmax(powers))
        if ifc.wrap_azimuth:
            # power-weighted CIRCULAR mean — a cluster straddling north
            # (359.9/0.1) merges to ~0 deg, not ~180
            az_r = np.deg2rad(log.azimuth_deg[m])
            az = float(np.mod(np.rad2deg(np.arctan2(
                (np.sin(az_r) * powers).sum(),
                (np.cos(az_r) * powers).sum())), 360.0))
        else:
            az = float((log.azimuth_deg[m] * powers).sum() / total)
        tracks.append(Track(
            range_m=float(log.range_m[m][w]),
            velocity_ms=float(log.velocity_ms[m][w]),
            elevation_deg=float(log.elevation_deg[m][w]),
            azimuth_deg=az,
            power=float(powers[w]),
            first_frame=int(log.frame[m].min()),
            last_frame=int(log.frame[m].max()),
            num_points=len(m),
            member_idx=m,
        ))
    return tracks


def tracks_without_association(log: DetectionLog) -> list[Track]:
    """inter_frame.enable=False passthrough (v8_3:337-352): one single-point
    track per log row."""
    return [Track(float(log.range_m[i]), float(log.velocity_ms[i]),
                  float(log.elevation_deg[i]), float(log.azimuth_deg[i]),
                  float(log.power[i]), int(log.frame[i]), int(log.frame[i]),
                  1, np.array([i]))
            for i in range(len(log))]


def make_device_multiframe(cfg: RadarConfig, precomp=None,
                           dtype=None, kinematics: str = "altitude"):
    """On-device multi-frame runner: kinematic state evolution (the v9.2
    track model, v8_3:203-228 — or the v8_2 simple model ``R -= V*T``
    with constant El/V, v8_2:200-205, under ``kinematics="simple"``) AND
    the per-frame processing chain run inside
    ONE jitted ``lax.scan`` over frames — no host round trip per frame.

    The host-side frame loop (``run_multiframe``) costs a dispatch and a
    result transfer per frame; this runs a whole multi-frame scenario as
    one program.

    Returns ``run(key, initial: TargetBatch, num_frames) -> (stacked
    FrameResult [num_frames, ...], azimuth_deg [num_frames])``; feed the
    stacked results to ``device_results_to_log`` for association."""
    import jax.numpy as jnp

    if kinematics not in ("altitude", "simple"):
        raise ValueError(f"unknown kinematics model {kinematics!r}")
    process = make_frame_processor(cfg, precomp, dtype=dtype or jnp.complex64,
                                   jit=False)
    t_frame = cfg.sig.frame_time
    deg_per_frame = cfg.scan.deg_per_frame(cfg.sig)

    def run(key, initial: TargetBatch, num_frames: int, frame_offset=0,
            carry_in=None):
        """Scan frames [frame_offset+1, frame_offset+num_frames]. The
        kinematic carry (azimuth, r_ground) may come from a previous
        chunk (``carry_in``) so a CHUNKED run reproduces the unchunked
        state-update sequence bit-for-bit (restart-on-failure for the
        device-scan runner, SURVEY section 5.3); the per-frame PRNG keys
        fold the ABSOLUTE frame index, so chunking never changes draws.
        Returns (stacked results, azimuths, carry_out). Under
        kinematics="simple" the second carry element is the slant range
        itself (El/V constant, v8_2:200-205)."""
        r0 = jnp.asarray(initial.range_m, jnp.float32)
        el0_deg = jnp.asarray(initial.elevation_deg, jnp.float32)
        el0 = jnp.deg2rad(el0_deg)
        v0 = jnp.asarray(initial.velocity_ms, jnp.float32)
        snr = jnp.asarray(initial.snr_db, jnp.float32)
        const_h = r0 * jnp.sin(el0)
        const_vg = v0 / jnp.cos(el0)
        if carry_in is None:
            carry_in = (jnp.asarray(cfg.scan.start_azimuth_deg,
                                    jnp.float32),
                        r0 if kinematics == "simple"
                        else r0 * jnp.cos(el0))

        def step(state, frame_idx):
            azimuth, r_state = state
            azimuth = jnp.mod(azimuth + deg_per_frame, 360.0)
            if kinematics == "simple":
                r_state = r_state - v0 * t_frame
                tb = TargetBatch(r_state, v0, el0_deg, snr)
            else:
                r_state = r_state - const_vg * t_frame
                r = jnp.sqrt(r_state**2 + const_h**2)
                el = jnp.rad2deg(jnp.arcsin(const_h / r))
                v_rad = const_vg * jnp.cos(jnp.deg2rad(el))
                tb = TargetBatch(r, v_rad, el, snr)
            res = process(jax.random.fold_in(key, frame_idx), tb)
            return (azimuth, r_state), (res, azimuth)

        carry_out, (results, azimuths) = jax.lax.scan(
            step, carry_in,
            jnp.arange(1, num_frames + 1) + jnp.asarray(frame_offset,
                                                        jnp.int32))
        return results, azimuths, carry_out

    return jax.jit(run, static_argnums=2)


def device_results_to_log(results, azimuths) -> DetectionLog:
    """Stacked device FrameResults [F, ...] -> host DetectionLog."""
    log = DetectionLog.empty()
    valid = np.asarray(results.targets.valid)
    range_m = np.asarray(results.targets.range_m)
    vel = np.asarray(results.targets.velocity_ms)
    ang = np.asarray(results.targets.angle_deg)
    power = np.asarray(results.targets.power)
    az = np.asarray(azimuths)
    for f in range(valid.shape[0]):
        m = valid[f]
        n = int(m.sum())
        log.range_m = np.concatenate([log.range_m, range_m[f][m]])
        log.velocity_ms = np.concatenate([log.velocity_ms, vel[f][m]])
        log.elevation_deg = np.concatenate([log.elevation_deg, ang[f][m]])
        log.power = np.concatenate([log.power, power[f][m]])
        log.frame = np.concatenate([log.frame, np.full(n, f + 1)])
        log.azimuth_deg = np.concatenate([log.azimuth_deg,
                                          np.full(n, az[f])])
    return log


def run_multiframe_device(cfg: RadarConfig, initial_targets: TargetBatch,
                          num_frames: int, seed: int = 0, precomp=None,
                          dtype=None, store=None,
                          chunk_frames: int | None = None,
                          kinematics: str = "altitude"):
    """Device-scan counterpart of ``run_multiframe``. Returns
    ``(log, tracks)`` — unlike ``run_multiframe``, no host-side
    ``Scenario`` exists to return (the kinematic state lives in the scan
    carry).

    ``store`` (an ``io.orbax_store.OrbaxFrameStore``) + ``chunk_frames``:
    restart-on-failure for the DEVICE-SCAN runner — the scan executes in
    chunks, each chunk's stacked results AND the kinematic carry persist
    (keyed by the chunk's end frame); a rerun replays completed chunks
    from disk and resumes the scan from the last carry, bit-identical to
    an uninterrupted run (the carry threads the exact state-update
    sequence and the PRNG keys fold absolute frame indices;
    tests/test_pipeline.py::test_device_scan_chunked_resume)."""
    import jax.numpy as jnp  # noqa: F401

    runner = make_device_multiframe(cfg, precomp, dtype, kinematics)
    key = jax.random.PRNGKey(seed)
    if store is None:
        results, azimuths, _ = jax.block_until_ready(
            runner(key, initial_targets, num_frames))
    else:
        if not chunk_frames or chunk_frames <= 0:
            raise ValueError("store= needs chunk_frames > 0")
        if num_frames % chunk_frames:
            raise ValueError(f"num_frames {num_frames} not divisible by "
                             f"chunk_frames {chunk_frames}")
        from ..io.checkpoint import check_run_manifest

        check_run_manifest(store.root, {
            **_run_fingerprint(cfg, initial_targets, seed, dtype),
            "chunk_frames": int(chunk_frames),
            "kinematics": kinematics,   # model changes the truth stream
        })
        done = set(store.frames_done())
        # orbax restores plain containers, not NamedTuples: persist the
        # FrameResult tree as flat leaves and rebuild with the treedef
        abs_res, _, _ = jax.eval_shape(
            runner, key, jax.tree.map(jnp.asarray, initial_targets),
            chunk_frames, 0, None)
        treedef = jax.tree.structure(abs_res)
        nleaves = treedef.num_leaves
        chunks = []
        carry = None
        for lo in range(0, num_frames, chunk_frames):
            end = lo + chunk_frames
            if end in done:
                saved = store.restore(end)
                carry = (jnp.asarray(saved["carry_az"]),
                         jnp.asarray(saved["carry_rg"]))
                res_np = jax.tree.unflatten(
                    treedef, [saved[f"l{i}"] for i in range(nleaves)])
                chunks.append((res_np, saved["azimuths"]))
                continue
            res, az, carry = jax.block_until_ready(
                runner(key, initial_targets, chunk_frames, lo, carry))
            res_np = jax.tree.map(np.asarray, res)
            store.save(end, {
                **{f"l{i}": x for i, x in
                   enumerate(jax.tree.leaves(res_np))},
                "azimuths": np.asarray(az),
                "carry_az": np.asarray(carry[0]),
                "carry_rg": np.asarray(carry[1]),
            })
            chunks.append((res_np, np.asarray(az)))
        results = jax.tree.map(lambda *xs: np.concatenate(xs),
                               *[c[0] for c in chunks])
        azimuths = np.concatenate([c[1] for c in chunks])
    log = device_results_to_log(results, azimuths)
    if cfg.inter_frame.enable:
        tracks = associate_tracks(log, cfg)
    else:
        tracks = tracks_without_association(log)
    return log, tracks


def _run_fingerprint(cfg: RadarConfig, targets: TargetBatch,
                     seed: int, dtype=None) -> dict:
    """Stable fingerprint of (config, initial scene, seed, dtype) for the
    resume manifest. RadarConfig is a frozen-dataclass tree, so its repr
    is a deterministic function of every field; the target batch hashes
    by array bytes. ``dtype`` is the processor dtype the run computes in
    — resuming a complex64 store under complex128 (or vice versa) would
    silently splice mixed-precision frames into one log (advisor round-4
    finding), so it is part of the guarded identity."""
    import hashlib

    import jax.numpy as jnp

    h = hashlib.sha256()
    for f in (targets.range_m, targets.velocity_ms, targets.elevation_deg,
              targets.snr_db):
        h.update(np.ascontiguousarray(np.asarray(f, np.float64)).tobytes())
    return {
        "seed": int(seed),
        "config_sha": hashlib.sha256(repr(cfg).encode()).hexdigest()[:16],
        "targets_sha": h.hexdigest()[:16],
        "dtype": str(jnp.dtype(dtype or jnp.complex64)),
        "num_frames": None,  # extending a run is allowed; not compared
    }


def run_multiframe(cfg: RadarConfig, initial_targets: TargetBatch,
                   num_frames: int, seed: int = 0, processor=None,
                   precomp=None, dtype=None, progress: bool = False,
                   store=None, kinematics: str = "altitude"):
    """Run the full multi-frame simulation; returns (log, tracks, scenario).

    ``processor`` may be a pre-built jitted frame processor (reused across
    runs to amortize compilation).

    ``store``: an ``io.checkpoint.CheckpointStore`` enabling
    restart-on-failure (SURVEY.md section 5.3/5.4): each frame's
    measurement rows are persisted under the "measurements" stage, and a
    rerun with the same store skips already-completed frames, replaying
    their rows from disk instead of recomputing — the scenario kinematics
    and per-frame PRNG keys are deterministic functions of (seed,
    frame_idx), so the resumed log is identical to an uninterrupted run
    (tests/test_pipeline.py::test_multiframe_resume_after_crash)."""
    import jax.numpy as jnp

    if processor is None:
        processor = make_frame_processor(cfg, precomp,
                                         dtype=dtype or jnp.complex64)
    scen = Scenario.from_initial(initial_targets, cfg, kinematics)
    log = DetectionLog.empty()
    key = jax.random.PRNGKey(seed)
    if store is not None:
        store.check_manifest({
            **_run_fingerprint(cfg, initial_targets, seed, dtype),
            "kinematics": kinematics,   # model changes the truth stream
        })
    done = set(store.frames_done("measurements")) if store else set()
    for frame_idx in range(1, num_frames + 1):
        targets = scen.step(cfg)
        if frame_idx in done:
            saved = store.load("measurements", frame_idx)
            log.append_rows(saved, frame_idx)
            if progress:
                print(f"frame {frame_idx}/{num_frames}: "
                      f"{len(saved['range_m'])} targets (resumed)")
            continue
        fkey = jax.random.fold_in(key, frame_idx)
        result = jax.block_until_ready(processor(fkey, targets))
        log.append_frame(result, frame_idx, scen.azimuth_deg)
        if store is not None:
            rows = log.frame == frame_idx
            store.save("measurements", frame_idx,
                       range_m=log.range_m[rows],
                       velocity_ms=log.velocity_ms[rows],
                       elevation_deg=log.elevation_deg[rows],
                       power=log.power[rows],
                       azimuth_deg=log.azimuth_deg[rows])
        if progress:
            print(f"frame {frame_idx}/{num_frames}: "
                  f"{int(result.num_final)} targets, az="
                  f"{scen.azimuth_deg:.2f}")
    if cfg.inter_frame.enable:
        tracks = associate_tracks(log, cfg)
    else:
        tracks = tracks_without_association(log)
    return log, tracks, scen
