"""Streaming many-target Monte-Carlo with sharded trials and detection-rate
statistics (BASELINE.json config 5: "10k-target Monte-Carlo across N>=2
hosts, channels+CPIs sharded, detection-rate statistics").

Scenes of random targets are generated on the host; per scene, a batch of
noise trials runs as one device program with the trial axis sharded over the
mesh's ``dp`` axis (and the processing cube sharded over ``ch``/``cpi`` via
the GSPMD constraints of parallel/sharded.py when a mesh is given). Truth
matching uses the clustering gates; statistics aggregate per-SNR-bin
detection rates over all injected targets — the scaled-up version of the
reference's Pd measurement (main_plot_snr_vs_angle_error.m:284).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config.params import RadarConfig
from ..sim.scenario import TargetBatch
from ..waveform.precompute import Precomputed, precompute
from .frame import make_frame_processor


class StreamingStats(NamedTuple):
    total_targets: int
    total_detected: int
    detection_rate: float
    snr_bin_edges: np.ndarray
    snr_bin_rate: np.ndarray        # detection rate per SNR bin
    snr_bin_counts: np.ndarray
    range_rmse_m: float             # over matched detections
    velocity_rmse_ms: float


def random_scene(rng: np.random.Generator, num_targets: int,
                 cfg: RadarConfig, snr_range=(0.0, 20.0)) -> TargetBatch:
    """Random targets inside the unambiguous detection region: ranges in
    the CFAR-valid gate span, velocities inside the valid Doppler region,
    elevations across the beam fan."""
    sig = cfg.sig
    delta_r = sig.c / (2 * sig.fs)
    border_r = cfg.cfar.ref_cells_r + cfg.cfar.guard_cells_r
    border_v = cfg.cfar.ref_cells_v + cfg.cfar.guard_cells_v
    r = rng.uniform((border_r + 5) * delta_r,
                    (sig.n_total_gate - border_r - 5) * delta_r, num_targets)
    v_max = sig.v_max
    # valid shifted Doppler bins are [border_v, prt_num-border_v)
    v_lo = (border_v + 2) / sig.prt_num - 0.5
    v_hi = (sig.prt_num - border_v - 2) / sig.prt_num - 0.5
    v = rng.uniform(v_lo * v_max, v_hi * v_max, num_targets)
    el = rng.uniform(-10.0, 40.0, num_targets)
    snr = rng.uniform(*snr_range, num_targets)
    return TargetBatch.make(r, v, el, snr)


def _match_rate(final, truth: TargetBatch, gate_r: float, gate_v: float):
    """Per-truth-target detected flags + (dR, dV) of the best match.

    Convention: each truth is gated INDEPENDENTLY (no one-to-one
    assignment) — one merged detection sitting inside two truths' gates
    marks both detected. With truths drawn uniformly over ~3k gates the
    collision probability is <1e-3 per pair, so the Pd inflation is
    negligible at the committed artifact scales; track-level scoring
    (pipeline/track_metrics.py) does perform exclusive assignment."""
    valid = np.asarray(final.valid)
    fr = np.asarray(final.range_m)[valid]
    fv = np.asarray(final.velocity_ms)[valid]
    k = truth.num_targets
    detected = np.zeros(k, bool)
    dr = np.full(k, np.nan)
    dv = np.full(k, np.nan)
    if len(fr):
        for i in range(k):
            d_r = np.abs(fr - truth.range_m[i])
            d_v = np.abs(fv - truth.velocity_ms[i])
            ok = (d_r <= gate_r) & (d_v <= gate_v)
            if ok.any():
                j = int(np.argmin(np.where(ok, d_r, np.inf)))
                detected[i] = True
                dr[i] = fr[j] - truth.range_m[i]
                dv[i] = fv[j] - truth.velocity_ms[i]
    return detected, dr, dv


def run_streaming_mc(cfg: RadarConfig, num_scenes: int = 16,
                     targets_per_scene: int = 8, trials_per_scene: int = 4,
                     seed: int = 0, mesh=None,
                     precomp: Precomputed | None = None,
                     dtype=jnp.complex64, snr_range=(0.0, 20.0),
                     match_gate_r: float = 60.0, match_gate_v: float = 3.0,
                     progress: bool = False, dp_trials: bool = False,
                     store=None) -> StreamingStats:
    """Total injected targets = num_scenes*targets_per_scene*trials_per_scene
    (10k-scale via e.g. 80 scenes x 32 targets x 4 trials).

    ``dp_trials=True`` (with a mesh carrying a dp axis): the trial batch
    shards ACROSS devices via the perf-path dp processor
    (parallel/dp.py) — each device runs complete frames for its slice of
    the trials, the reference's parfor boundary
    (main_plot_snr_vs_angle_error.m:167) on the mesh.

    ``store``: an ``io.orbax_store.OrbaxFrameStore`` enabling ELASTIC
    recovery (SURVEY.md sections 5.3/5.4): each scene's sharded trial-
    result batch is checkpointed shard-local (no host gather); a rerun
    with the same (seed, scene schedule) replays completed scenes from
    disk — restored onto the CURRENT mesh's sharding via explicit
    ``like=`` shardings, so the run may resume on a DIFFERENT mesh shape
    (e.g. dp=4 -> dp=2) with field-exact final statistics
    (tests/test_streaming.py::test_streaming_orbax_elastic_resume)."""
    if precomp is None:
        precomp = precompute(cfg)
    if mesh is not None and dp_trials:
        from ..parallel.dp import (broadcast_targets,
                                   make_dp_frame_processor)

        proc_dp = make_dp_frame_processor(cfg, mesh, precomp, dtype=dtype)

        def trial_batch(keys, truth):
            tb = broadcast_targets(jax.tree.map(jnp.asarray, truth),
                                   keys.shape[0])
            return proc_dp(keys, tb)
    elif mesh is not None:
        # the mesh path shards WITHIN each trial (dp+cpi over pulses, ch
        # over channels); trials run back-to-back. (vmapping the sharded
        # program trips an XLA:CPU FFT layout RET_CHECK, so the portable
        # path keeps trials un-vmapped.)
        from ..parallel.sharded import make_sharded_frame_processor

        process = make_sharded_frame_processor(cfg, mesh, precomp,
                                               dtype=dtype)

        def trial_batch(keys, truth):
            outs = [process(k, truth) for k in keys]
            return jax.tree.map(lambda *xs: jnp.stack(xs), *outs)
    else:
        process = make_frame_processor(cfg, precomp, dtype=dtype)
        trial_batch = jax.jit(jax.vmap(process, in_axes=(0, None)))

    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    done = set()
    if store is not None:
        # refuse resuming a store written by a DIFFERENT run: restored
        # scenes would be matched against THIS run's (different) truths —
        # silently wrong statistics. Mesh shape is deliberately absent
        # (elastic dp=4 -> dp=2 resume is the feature); num_scenes too
        # (extending a run is allowed).
        import hashlib

        from ..io.checkpoint import check_run_manifest

        check_run_manifest(store.root, {
            "seed": int(seed),
            "config_sha": hashlib.sha256(repr(cfg).encode()).hexdigest()[:16],
            "targets_per_scene": int(targets_per_scene),
            "trials_per_scene": int(trials_per_scene),
            "snr_range": [float(snr_range[0]), float(snr_range[1])],
            # knobs that alter per-trial NUMERICS: a resume under a
            # different dtype (or a different trial-batch route — dp-
            # sharded vs vmapped) would silently splice
            # mixed-precision / differently-reduced results into one
            # statistic (advisor round-4 finding)
            "dtype": str(jnp.dtype(dtype)),
            # the full trial-batch ROUTE, not just the dp bool: the
            # mesh-GSPMD within-frame route and the single-device
            # vmap route reduce in different orders (~1e-3
            # rtol), so splicing them into one statistic must be refused
            # (round-5 self-review). "dp" deliberately omits the mesh
            # shape — each device runs the full pipeline locally, so
            # per-trial numerics are dp-size-independent (the elastic
            # dp=N -> dp=M resume feature, proven field-exact in
            # tests/test_streaming.py). The gspmd route's numerics DO
            # depend on the model-axis sizes — they are recorded.
            "trial_route": (
                "dp" if (mesh is not None and dp_trials)
                else "gspmd:" + "x".join(
                    f"{k}={v}" for k, v in mesh.shape.items()
                    if k != "dp") if mesh is not None
                else "vmap"),
        })
        done = set(store.frames_done())
    like_cache = None

    def sharded_like(keys, truth):
        """Abstract result tree with EXPLICIT shardings on the CURRENT
        mesh (trial axis over dp) — what makes cross-mesh-shape restore
        well-defined instead of orbax's 'unsafe topology' guess."""
        nonlocal like_cache
        if like_cache is None:
            abs_tree = jax.eval_shape(trial_batch, keys, truth)
            if mesh is not None and dp_trials:
                from jax.sharding import NamedSharding, PartitionSpec as P

                from ..parallel.mesh import AXIS_DP

                sh = NamedSharding(mesh, P(AXIS_DP))
                abs_tree = jax.tree.map(
                    lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype,
                                                   sharding=sh), abs_tree)
            like_cache = (jax.tree.leaves(abs_tree),
                          jax.tree.structure(abs_tree))
        return like_cache

    all_snr, all_det = [], []
    all_dr, all_dv = [], []
    for s in range(num_scenes):
        # the scene rng ADVANCES for replayed scenes too: truth must be the
        # deterministic function of (seed, scene index) the original run saw
        truth = random_scene(rng, targets_per_scene, cfg, snr_range)
        keys = jax.random.split(jax.random.fold_in(key, s),
                                trials_per_scene)
        if store is not None and (s + 1) in done:
            leaves, treedef = sharded_like(keys, truth)
            saved = store.restore(
                s + 1, like={f"l{i}": x for i, x in enumerate(leaves)})
            results = jax.tree.unflatten(
                treedef, [saved[f"l{i}"] for i in range(len(leaves))])
        else:
            results = jax.block_until_ready(trial_batch(keys, truth))
            if store is not None:
                store.save(s + 1, {f"l{i}": x for i, x in
                                   enumerate(jax.tree.leaves(results))})
        for t in range(trials_per_scene):
            one = jax.tree.map(lambda x: x[t], results)
            det, dr, dv = _match_rate(one.targets, truth, match_gate_r,
                                      match_gate_v)
            all_snr.append(truth.snr_db)
            all_det.append(det)
            all_dr.append(dr)
            all_dv.append(dv)
        if progress:
            print(f"scene {s + 1}/{num_scenes}: "
                  f"rate={np.mean(all_det[-trials_per_scene:]):.2f}")

    return aggregate_stats(np.concatenate(all_snr), np.concatenate(all_det),
                           np.concatenate(all_dr), np.concatenate(all_dv),
                           snr_range)


def aggregate_stats(snr: np.ndarray, det: np.ndarray, dr: np.ndarray,
                    dv: np.ndarray, snr_range) -> StreamingStats:
    """Detection-rate statistics from flat per-injected-target records —
    shared by the in-process loop above and the multi-process scene-sharded
    runner (scripts/run_multiprocess.py --streaming), which gathers the
    records across processes before aggregating."""
    edges = np.linspace(snr_range[0], snr_range[1], 9)
    bins = np.clip(np.digitize(snr, edges) - 1, 0, len(edges) - 2)
    rate = np.zeros(len(edges) - 1)
    counts = np.zeros(len(edges) - 1, int)
    for b in range(len(edges) - 1):
        m = bins == b
        counts[b] = m.sum()
        rate[b] = det[m].mean() if m.any() else np.nan
    matched = ~np.isnan(dr)
    return StreamingStats(
        total_targets=len(det),
        total_detected=int(det.sum()),
        detection_rate=float(det.mean()),
        snr_bin_edges=edges,
        snr_bin_rate=rate,
        snr_bin_counts=counts,
        range_rmse_m=float(np.sqrt(np.nanmean(dr[matched] ** 2)))
        if matched.any() else np.nan,
        velocity_rmse_ms=float(np.sqrt(np.nanmean(dv[matched] ** 2)))
        if matched.any() else np.nan,
    )
