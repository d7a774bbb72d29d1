"""Real multi-process (2+ ``jax.distributed`` processes) validation of the
multi-host path on one machine.

This is the executable evidence for SURVEY.md section 4 ("multi-node without
a cluster") and the BASELINE north star ("scaling measured at ... N>=2
hosts"): the reference's only parallel boundary is a shared-nothing MATLAB
``parfor`` trial loop (main_plot_snr_vs_angle_error.m:167); the equivalent
here is a mesh over multiple *processes* with the cross-process axis first
(parallel/multihost.py) and GSPMD collectives crossing the process
boundary. Real multi-host hardware is not required to exercise that
logic: N local processes with the CPU backend (Gloo cross-process
collectives) run the identical process-id / mesh-construction /
batch-slicing / collective code paths.

Orchestrator mode (default) spawns N worker processes of this same script,
each pinned to K virtual CPU devices, wired together through a localhost
coordinator via the standard JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
JAX_PROCESS_ID environment (exercising multihost.initialize()'s env
resolution). Every worker independently asserts parity, so a non-zero exit
from any worker fails the run.

Each worker validates four things against a process-local single-device
reference run (identical config, key, targets):

  1. stream-path frame pipeline sharded over a dp(xproc) x ch mesh —
     channel-sharded synthesis, psum DBF combine, pulses->gates all_to_all,
     all crossing the process boundary on the dp axis;
  2. lowrank perf-path frame pipeline over a dp(xproc) x cpi mesh;
  3. a dp-sharded Monte-Carlo trial batch fed with
     jax.make_array_from_process_local_data using
     multihost.local_batch_slice — each process materializes ONLY its own
     trials (the per-host batch-slicing contract);
  4. the perf-path dp composition (parallel/dp.py shard_map) with each
     device running the complete per-frame pipeline on its slice of a
     frame batch.

Run:  python scripts/run_multiprocess.py [--nproc 2] [--devices-per-proc 2]
Artifact: results/multiprocess_parity.json (written by process 0).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------------
# worker
# --------------------------------------------------------------------------

def worker_main(args) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")

    from radar_tpu.parallel import multihost

    # env-driven resolution path (JAX_COORDINATOR_ADDRESS etc.).
    # Plain statements, not asserts: the init is a required SIDE EFFECT
    # and the checks guard correctness — under `python -O` an assert
    # would skip both silently (advisor round-4 finding)
    if multihost.initialize() is not True:
        raise SystemExit("expected multi-process init")
    pid = jax.process_index()
    nproc = jax.process_count()
    k = jax.local_device_count()
    if nproc != args.nproc:
        raise SystemExit(f"process_count {nproc} != --nproc {args.nproc}")
    if len(jax.devices()) != nproc * k:
        raise SystemExit(f"global devices {len(jax.devices())} != "
                         f"{nproc}x{k}")

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radar_tpu.config.params import small_test_config
    from radar_tpu.parallel.mesh import AXIS_DP
    from radar_tpu.parallel.sharded import make_sharded_frame_processor
    from radar_tpu.pipeline.frame import make_frame_processor
    from radar_tpu.pipeline.montecarlo import make_trial_fn
    from radar_tpu.sim.scenario import TargetBatch
    from radar_tpu.waveform.precompute import precompute

    def log(msg):
        print(f"[proc {pid}] {msg}", flush=True)

    local0 = jax.local_devices()[0]
    cfg = small_test_config(channels=8, pulses=32)
    pre = precompute(cfg)
    tb = TargetBatch.make([3000.0, 9000.0], [10.0, 20.0], [10.0, 5.0],
                          [18.0, 15.0])
    with jax.default_device(local0):
        key_np = np.asarray(jax.random.PRNGKey(0))

    report = {"nproc": nproc, "devices_per_proc": k, "checks": []}

    def frame_parity(name, cfg_v, mesh):
        """Sharded-over-processes frame result == process-local result."""
        pre_v = precompute(cfg_v)
        with jax.default_device(local0):
            ref = make_frame_processor(cfg_v, pre_v)(key_np, tb)
            ref = jax.tree.map(np.asarray, ref)
        repl = NamedSharding(mesh, P())
        key_g = jax.device_put(key_np, repl)
        tb_g = jax.tree.map(lambda x: jax.device_put(x, repl), tb)
        proc = make_sharded_frame_processor(cfg_v, mesh, pre_v)
        out = jax.jit(lambda a, b: proc(a, b), out_shardings=repl)(key_g,
                                                                   tb_g)
        out = jax.tree.map(np.asarray, out)
        assert int(out.num_raw_detections) == int(ref.num_raw_detections), \
            (name, int(out.num_raw_detections), int(ref.num_raw_detections))
        assert int(out.num_final) == int(ref.num_final)
        v = ref.targets.valid.astype(bool)
        np.testing.assert_array_equal(v, out.targets.valid.astype(bool))
        np.testing.assert_allclose(out.targets.range_m[v],
                                   ref.targets.range_m[v], rtol=1e-4)
        np.testing.assert_allclose(out.targets.velocity_ms[v],
                                   ref.targets.velocity_ms[v], rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(out.targets.angle_deg[v],
                                   ref.targets.angle_deg[v], rtol=1e-3,
                                   atol=1e-3)
        n_final = int(out.num_final)
        log(f"{name}: PARITY OK ({n_final} final targets, "
            f"{int(out.num_raw_detections)} raw detections)")
        report["checks"].append({"name": name, "ok": True,
                                 "mesh": dict(mesh.shape),
                                 "num_final": n_final})

    # 1) stream path, dp across processes x ch within: the dp axis of the
    #    pulse sharding and the gates reshard both cross the process boundary
    mesh_ch = multihost.make_multihost_mesh(dp=nproc, ch=k)
    assert mesh_ch.shape[AXIS_DP] == nproc
    frame_parity("stream_dpxch", cfg, mesh_ch)

    # 2) lowrank perf path, dp across processes x cpi within
    cfg_lr = cfg.replace(fused_synth_dbf=True, lowrank_rdm=True)
    mesh_cpi = multihost.make_multihost_mesh(dp=nproc, cpi=k)
    frame_parity("lowrank_dpxcpi", cfg_lr, mesh_cpi)

    # 3) dp-sharded Monte-Carlo trials: each process feeds ONLY its slice of
    #    the global trial batch (make_array_from_process_local_data +
    #    local_batch_slice), the parfor-boundary analog (ref :167)
    n_trials = 2 * nproc * k
    mesh_dp = multihost.make_multihost_mesh(dp=nproc * k)
    with jax.default_device(local0):
        keys_np = np.asarray(
            jax.vmap(jax.random.fold_in, (None, 0))(
                jax.random.PRNGKey(7), jnp.arange(n_trials)))
    sl = multihost.local_batch_slice(n_trials, mesh_dp)
    expect = slice(pid * (n_trials // nproc), (pid + 1) * (n_trials // nproc))
    assert sl == expect, (sl, expect)
    sh = NamedSharding(mesh_dp, P(AXIS_DP))
    keys_g = jax.make_array_from_process_local_data(sh, keys_np[sl],
                                                    keys_np.shape)
    repl = NamedSharding(mesh_dp, P())
    tb_g = jax.tree.map(lambda x: jax.device_put(x, repl), tb)
    trial_fn = make_trial_fn(cfg, pre)
    angles, hits = jax.jit(lambda t, ks: trial_fn(t, ks),
                           out_shardings=repl)(tb_g, keys_g)
    angles, hits = np.asarray(angles), np.asarray(hits)
    with jax.default_device(local0):
        a_ref, h_ref = jax.tree.map(np.asarray, trial_fn(tb, keys_np))
    np.testing.assert_array_equal(hits, h_ref)
    np.testing.assert_allclose(angles, a_ref, rtol=1e-4, atol=1e-5,
                               equal_nan=True)
    log(f"trials_dp: PARITY OK ({n_trials} trials, local slice {sl.start}:"
        f"{sl.stop}, Pd={float(np.mean(hits)):.2f})")
    report["checks"].append({"name": "trials_dp", "ok": True,
                             "n_trials": n_trials,
                             "local_slice": [sl.start, sl.stop]})

    # 4) the PERF-path dp composition (parallel/dp.py shard_map) ACROSS
    #    the process boundary: each device — some owned by the other
    #    process — runs the complete perf pipeline for its frame of the
    #    batch.
    from radar_tpu.config.params import perf_config
    from radar_tpu.parallel.dp import make_dp_frame_processor

    cfg_pf = perf_config(small_test_config(channels=8, pulses=32))
    pre_pf = precompute(cfg_pf)
    mesh_pf = multihost.make_multihost_mesh(dp=nproc * k)
    n_frames = nproc * k
    with jax.default_device(local0):
        keys_np = np.asarray(
            jax.vmap(jax.random.fold_in, (None, 0))(
                jax.random.PRNGKey(21), jnp.arange(n_frames)))
    sl = multihost.local_batch_slice(n_frames, mesh_pf)
    sh = NamedSharding(mesh_pf, P(AXIS_DP))
    keys_g = jax.make_array_from_process_local_data(sh, keys_np[sl],
                                                    keys_np.shape)
    repl = NamedSharding(mesh_pf, P())
    tb_np_b = jax.tree.map(
        lambda x: np.ascontiguousarray(
            np.broadcast_to(np.asarray(x)[None],
                            (n_frames,) + np.shape(x))), tb)
    tb_b = jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(sh, x[sl],
                                                         x.shape), tb_np_b)
    proc_pf = make_dp_frame_processor(cfg_pf, mesh_pf, pre_pf)
    out = jax.jit(lambda a, b: proc_pf(a, b), out_shardings=repl)(keys_g,
                                                                  tb_b)
    out = jax.tree.map(np.asarray, out)
    with jax.default_device(local0):
        proc_1 = make_frame_processor(cfg_pf, pre_pf)
        for i in range(n_frames):
            ref_i = jax.tree.map(
                np.asarray,
                proc_1(keys_np[i], jax.tree.map(lambda x: x[i], tb_np_b)))
            assert int(out.num_raw_detections[i]) == \
                int(ref_i.num_raw_detections), ("perf_dp", i)
            assert int(out.num_final[i]) == int(ref_i.num_final)
    log(f"perf_dp: PARITY OK ({n_frames} perf-path frames (XLA "
        f"chain) across {nproc} processes)")
    report["checks"].append({"name": "perf_dp", "ok": True,
                             "n_frames": n_frames})

    if pid == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        log(f"wrote {args.out}")
    log("ALL PARITY CHECKS PASSED")
    return 0


def worker_bench(args) -> int:
    """Weak-scaling throughput arm: a FIXED per-process batch of
    Monte-Carlo trials, dp-sharded over all processes (each process
    materializes only its slice). With each worker pinned to one core,
    trials/s should scale ~linearly with process count — the measured
    'N>=2 hosts' scaling axis of BASELINE.md, on the one-machine stand-in
    for DCN (localhost Gloo)."""
    import time as _time

    import jax

    jax.config.update("jax_platforms", "cpu")

    from radar_tpu.parallel import multihost

    if multihost.initialize() is not True:   # side effect; -O-safe check
        raise SystemExit("expected multi-process init")
    pid = jax.process_index()
    nproc = jax.process_count()

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radar_tpu.config.params import small_test_config
    from radar_tpu.parallel.mesh import AXIS_DP
    from radar_tpu.pipeline.montecarlo import make_trial_fn
    from radar_tpu.sim.scenario import TargetBatch
    from radar_tpu.waveform.precompute import precompute

    cfg = small_test_config(channels=8, pulses=32)
    if args.perf:
        # the PERF configuration dp-sharded across the process boundary
        # via shard_map (parallel/dp.py)
        from radar_tpu.config.params import perf_config
        from radar_tpu.parallel.dp import make_dp_trial_fn

        cfg = perf_config(cfg)
    pre = precompute(cfg)
    tb = TargetBatch.make([3000.0], [10.0], [10.0], [18.0])
    n_trials = args.trials_per_proc * nproc
    mesh = multihost.make_multihost_mesh(dp=nproc * jax.local_device_count())
    with jax.default_device(jax.local_devices()[0]):
        keys_np = np.asarray(
            jax.vmap(jax.random.fold_in, (None, 0))(
                jax.random.PRNGKey(11), jnp.arange(n_trials)))
    sl = multihost.local_batch_slice(n_trials, mesh)
    sh = NamedSharding(mesh, P(AXIS_DP))
    keys_g = jax.make_array_from_process_local_data(sh, keys_np[sl],
                                                    keys_np.shape)
    repl = NamedSharding(mesh, P())
    tb_g = jax.tree.map(lambda x: jax.device_put(x, repl), tb)
    if args.perf:
        trial_fn = make_dp_trial_fn(cfg, mesh, pre)
        run = jax.jit(
            lambda t, ks: jnp.nansum(trial_fn(t, ks)[0]),
            out_shardings=repl)
    else:
        trial_fn = make_trial_fn(cfg, pre)
        run = jax.jit(lambda t, ks: jnp.sum(trial_fn(t, ks)[0]),
                      out_shardings=repl)
    for _ in range(2):   # warmup/compile
        float(run(tb_g, keys_g))
    reps = args.bench_reps
    t0 = _time.perf_counter()
    for _ in range(reps):
        float(run(tb_g, keys_g))
    dt = (_time.perf_counter() - t0) / reps
    rate = n_trials / dt
    print(f"[proc {pid}] bench: {n_trials} trials in {dt * 1e3:.1f} ms "
          f"-> {rate:.2f} trials/s", flush=True)
    if pid == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump({"nproc": nproc, "trials": n_trials,
                       "seconds_per_batch": dt, "trials_per_s": rate}, f)
    return 0


def worker_streaming(args) -> int:
    """BASELINE config 5 AS WRITTEN: the streaming many-target Monte-Carlo
    sharded across N coordinator-joined processes. Scenes stride across
    processes (scene s belongs to process s mod N) — the shared-nothing
    ``parfor`` trial boundary of main_plot_snr_vs_angle_error.m:167 mapped
    onto ``jax.distributed`` processes. Every process replays the identical
    scene-truth RNG stream (truth is a deterministic function of (seed,
    scene index)) but computes only its own scenes; the per-injected-target
    records are then gathered across the process boundary through the dp
    mesh (make_array_from_process_local_data + replicate = all_gather over
    the DCN stand-in), sorted by scene, and aggregated identically to the
    single-process runner — so the statistics are BIT-EXACT equal to the
    n=1 run at the same seed (the orchestrator asserts this across arms)."""
    import time as _time

    import jax

    jax.config.update("jax_platforms", "cpu")

    from radar_tpu.parallel import multihost

    if args.nproc > 1:
        if multihost.initialize() is not True:  # side effect; -O-safe
            raise SystemExit("expected multi-process init")
        pid, nproc = jax.process_index(), jax.process_count()
    else:
        pid, nproc = 0, 1

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radar_tpu.config.params import perf_config, small_test_config
    from radar_tpu.parallel.mesh import AXIS_DP
    from radar_tpu.pipeline.frame import make_frame_processor
    from radar_tpu.pipeline.streaming import (_match_rate, aggregate_stats,
                                              random_scene)
    from radar_tpu.waveform.precompute import precompute

    cfg = small_test_config(channels=8, pulses=32)
    if args.perf:
        cfg = perf_config(cfg)
    pre = precompute(cfg)
    trial_batch = jax.jit(jax.vmap(make_frame_processor(cfg, pre, jit=False),
                                   in_axes=(0, None)))

    snr_range = (-5.0, 20.0)
    s_count, k_targets, t_trials = args.scenes, args.targets_per_scene, \
        args.trials_per_scene
    if s_count % nproc:
        raise SystemExit(
            f"--scenes {s_count} must divide evenly over {nproc} processes")
    rng = np.random.default_rng(args.seed)
    key = jax.random.PRNGKey(args.seed)
    # every process replays the FULL truth stream (tiny host draws) so
    # scene truths match the single-process run draw for draw
    truths = [random_scene(rng, k_targets, cfg, snr_range)
              for _ in range(s_count)]
    mine = [s for s in range(s_count) if s % nproc == pid]

    # compile outside the timed loop (same shapes for every scene)
    k0 = jax.random.split(jax.random.fold_in(key, mine[0]), t_trials)
    jax.block_until_ready(trial_batch(
        k0, jax.tree.map(jnp.asarray, truths[mine[0]])))

    t0 = _time.perf_counter()
    results = {}
    for s in mine:
        keys = jax.random.split(jax.random.fold_in(key, s), t_trials)
        results[s] = jax.block_until_ready(trial_batch(
            keys, jax.tree.map(jnp.asarray, truths[s])))
    wall = _time.perf_counter() - t0

    rows = []   # [scene, snr, det, dr, dv] per injected target
    for s in mine:
        for t in range(t_trials):
            one = jax.tree.map(lambda x: x[t], results[s])
            det, dr, dv = _match_rate(one.targets, truths[s], 60.0, 3.0)
            rows.append(np.stack([np.full(k_targets, s), truths[s].snr_db,
                                  det.astype(float), dr, dv], axis=1))
    # f32 in BOTH arms: the cross-process gather rides a jax array (f32
    # without the global x64 flag), so the n=1 arm must quantize
    # identically for the exact-parity contract to hold
    local = np.concatenate(rows).astype(np.float32)  # [mine*T*K, 5]

    if nproc > 1:
        # gather the shared-nothing records ACROSS the process boundary
        # through the dp mesh (each process contributes only its slice)
        mesh = multihost.make_multihost_mesh(
            dp=nproc * jax.local_device_count())
        gshape = (local.shape[0] * nproc, local.shape[1])
        sh = NamedSharding(mesh, P(AXIS_DP))
        g = jax.make_array_from_process_local_data(sh, local, gshape)
        repl = NamedSharding(mesh, P())
        allrec = np.asarray(jax.jit(lambda x: x, out_shardings=repl)(g))
    else:
        allrec = local
    # single-process aggregation orders records by scene — reproduce it
    # exactly (np.argsort stable mergesort keeps within-scene order)
    allrec = allrec[np.argsort(allrec[:, 0], kind="stable")]
    stats = aggregate_stats(allrec[:, 1], allrec[:, 2].astype(bool),
                            allrec[:, 3], allrec[:, 4], snr_range)

    total = s_count * k_targets * t_trials
    print(f"[proc {pid}] {len(mine)} scenes in {wall:.1f}s; global rate "
          f"{stats.detection_rate:.4f}", flush=True)
    if args.out and pid == 0:
        with open(args.out, "w") as f:
            json.dump({
                "nproc": nproc,
                "scenes": s_count, "targets_per_scene": k_targets,
                "trials_per_scene": t_trials,
                "injected_targets": total,
                "perf_config": bool(args.perf),
                "seed": args.seed,
                "wall_s_compute_loop": round(wall, 2),
                "targets_per_s": round(total / wall, 1),
                "detection_rate": stats.detection_rate,
                "total_detected": stats.total_detected,
                "snr_bin_rate": [float(x) for x in stats.snr_bin_rate],
                "snr_bin_counts": [int(x) for x in stats.snr_bin_counts],
                "range_rmse_m": stats.range_rmse_m,
                "velocity_rmse_ms": stats.velocity_rmse_ms,
            }, f, indent=1)
    return 0


def streaming_orchestrate(args) -> int:
    """Run the scene-sharded streaming MC at n=1 and n=N (N>=2), assert the
    statistics are EXACTLY equal at identical seeds, and record aggregate
    throughput. Writes results/streaming_mc_multiproc.json."""
    arms = sorted({int(x) for x in args.arms.split(",")})
    arm_out = {}
    for nproc in arms:
        port = _free_port()
        procs, logs = [], []
        outp = f"{args.logdir}/mp_stream_{nproc}.json"
        for pid in range(nproc):
            env = dict(os.environ)
            env["JAX_PLATFORMS"] = "cpu"
            flags = [f for f in env.get("XLA_FLAGS", "").split()
                     if "xla_force_host_platform_device_count" not in f]
            flags.append("--xla_force_host_platform_device_count=1")
            env["XLA_FLAGS"] = " ".join(flags)
            if nproc > 1:
                env["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
                env["JAX_NUM_PROCESSES"] = str(nproc)
                env["JAX_PROCESS_ID"] = str(pid)
            else:
                for v in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                          "JAX_PROCESS_ID"):
                    env.pop(v, None)
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            cmd = ["taskset", "-c", str(pid % os.cpu_count()),
                   sys.executable, os.path.abspath(__file__), "--worker",
                   "--streaming", "--nproc", str(nproc),
                   "--scenes", str(args.scenes),
                   "--targets-per-scene", str(args.targets_per_scene),
                   "--trials-per-scene", str(args.trials_per_scene),
                   "--seed", str(args.seed),
                   "--out", outp if pid == 0 else ""]
            if args.perf:
                cmd.append("--perf")
            lf = open(f"{args.logdir}/mp_stream_{nproc}_{pid}.log", "w")
            logs.append(lf)
            procs.append(subprocess.Popen(cmd, env=env, stdout=lf,
                                          stderr=subprocess.STDOUT,
                                          cwd=REPO))
        rcs = [p.wait(timeout=args.timeout) for p in procs]
        for lf in logs:
            lf.close()
        if any(rcs):
            for pid in range(nproc):
                sys.stdout.write(open(
                    f"{args.logdir}/mp_stream_{nproc}_{pid}.log").read())
            return 1
        arm_out[nproc] = json.load(open(outp))
        # collect every worker's compute-loop wall from its log (worker 0's
        # JSON alone would hide imbalance); throughput = total / max wall
        walls = []
        for pid in range(nproc):
            for line in open(f"{args.logdir}/mp_stream_{nproc}_{pid}.log"):
                if "scenes in" in line:
                    walls.append(float(line.split("scenes in")[1]
                                       .split("s;")[0]))
        arm_out[nproc]["walls_per_worker_s"] = walls
        if walls:
            total = arm_out[nproc]["injected_targets"]
            arm_out[nproc]["targets_per_s"] = round(total / max(walls), 1)
        print(f"n={nproc}: {arm_out[nproc]['targets_per_s']:.0f} targets/s, "
              f"rate={arm_out[nproc]['detection_rate']:.4f} "
              f"walls={walls}")

    # statistics must be EXACTLY equal across arms (same seeds, same
    # per-scene programs; only WHERE each scene ran differs)
    stat_keys = ("detection_rate", "total_detected", "snr_bin_rate",
                 "snr_bin_counts", "range_rmse_m", "velocity_rmse_ms")
    base = arm_out[arms[0]]
    parity = all(arm_out[n][k] == base[k] for n in arms[1:]
                 for k in stat_keys)
    n1 = arms[0]
    out = {
        "parity_exact_across_arms": parity,
        "arms": arm_out,
        "pinning": "1 core + 1 CPU device per process (taskset)",
        "cpu_cores": os.cpu_count(),
        "speedup_vs_n1": {
            str(n): round(arm_out[n]["targets_per_s"]
                          / arm_out[n1]["targets_per_s"], 3)
            for n in arms},
        "note": ("scene-sharded shared-nothing trials, records gathered "
                 "across the jax.distributed process boundary via the dp "
                 "mesh; the reference's parfor boundary "
                 "(main_plot_snr_vs_angle_error.m:167) at BASELINE "
                 "config-5 scale"),
        "timing_caveat": ("single-core walls on this shared 2-core box "
                          "swing ~13% run-to-run for identical work, so "
                          "speedups carry that noise; values slightly "
                          "above the core count are variance, not magic"),
    }
    path = args.out or os.path.join(REPO, "results",
                                    "streaming_mc_multiproc.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"parity_exact_across_arms": parity,
                      "speedup_vs_n1": out["speedup_vs_n1"]}))
    print(f"wrote {path}")
    return 0 if parity else 1


# --------------------------------------------------------------------------
# orchestrator
# --------------------------------------------------------------------------

def orchestrate(args) -> int:
    port = _free_port()
    procs, logs = [], []
    for pid in range(args.nproc):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        flags = [f for f in env.get("XLA_FLAGS", "").split()
                 if "xla_force_host_platform_device_count" not in f]
        flags.append("--xla_force_host_platform_device_count="
                     f"{args.devices_per_proc}")
        env["XLA_FLAGS"] = " ".join(flags)
        env["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
        env["JAX_NUM_PROCESSES"] = str(args.nproc)
        env["JAX_PROCESS_ID"] = str(pid)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               "--nproc", str(args.nproc),
               "--devices-per-proc", str(args.devices_per_proc)]
        if pid == 0 and args.out:
            cmd += ["--out", args.out]
        lf = open(f"{args.logdir}/mp_worker_{pid}.log", "w")
        logs.append(lf)
        procs.append(subprocess.Popen(cmd, env=env, stdout=lf,
                                      stderr=subprocess.STDOUT, cwd=REPO))
    deadline = time.time() + args.timeout
    rcs = [None] * args.nproc
    try:
        while time.time() < deadline and any(r is None for r in rcs):
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    rcs[i] = p.poll()
            time.sleep(0.5)
    finally:
        for i, p in enumerate(procs):
            if rcs[i] is None:            # timed out: kill exact PIDs we own
                p.kill()
                rcs[i] = -9
        for lf in logs:
            lf.close()
    ok = all(r == 0 for r in rcs)
    for pid in range(args.nproc):
        path = f"{args.logdir}/mp_worker_{pid}.log"
        if not ok:
            print(f"----- worker {pid} (rc={rcs[pid]}) -----")
            sys.stdout.write(open(path).read())
        else:
            for line in open(path):
                if "PARITY" in line:
                    sys.stdout.write(line)
    print(json.dumps({"multiprocess_parity": ok, "nproc": args.nproc,
                      "devices_per_proc": args.devices_per_proc,
                      "rcs": rcs}))
    return 0 if ok else 1


def bench_orchestrate(args) -> int:
    """Weak-scaling arms over a process-count curve (default 1/2/4), one
    core and one CPU device per process (taskset-pinned so per-process
    compute is constant). Points beyond ``os.cpu_count()`` oversubscribe
    cores — their efficiency measures contention on this box, not the
    communication fabric; the artifact records the core count so the curve
    reads honestly. Writes results/multiprocess_scaling.json (or the
    perf-path artifact with --perf)."""
    results = {}
    arms = sorted({int(x) for x in args.arms.split(",")})
    for nproc in arms:
        port = _free_port()
        procs, logs = [], []
        outp = f"{args.logdir}/mp_bench_{nproc}.json"
        for pid in range(nproc):
            env = dict(os.environ)
            env["JAX_PLATFORMS"] = "cpu"
            flags = [f for f in env.get("XLA_FLAGS", "").split()
                     if "xla_force_host_platform_device_count" not in f]
            flags.append("--xla_force_host_platform_device_count="
                         f"{args.devices_per_proc}")
            env["XLA_FLAGS"] = " ".join(flags)
            env["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
            env["JAX_NUM_PROCESSES"] = str(nproc)
            env["JAX_PROCESS_ID"] = str(pid)
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH",
                                                            "")
            cmd = ["taskset", "-c", str(pid % os.cpu_count()),
                   sys.executable, os.path.abspath(__file__), "--worker",
                   "--bench", "--nproc", str(nproc),
                   "--trials-per-proc", str(args.trials_per_proc),
                   "--bench-reps", str(args.bench_reps),
                   "--out", outp if pid == 0 else ""]
            if args.perf:
                cmd.append("--perf")
            lf = open(f"{args.logdir}/mp_bench_{nproc}_{pid}.log", "w")
            logs.append(lf)
            procs.append(subprocess.Popen(cmd, env=env, stdout=lf,
                                          stderr=subprocess.STDOUT,
                                          cwd=REPO))
        rcs = [p.wait(timeout=args.timeout) for p in procs]
        for lf in logs:
            lf.close()
        if any(rcs):
            for pid in range(nproc):
                sys.stdout.write(
                    open(f"{args.logdir}/mp_bench_{nproc}_{pid}.log").read())
            return 1
        results[nproc] = json.load(open(outp))
        print(f"nproc={nproc}: {results[nproc]['trials_per_s']:.2f} "
              f"trials/s ({results[nproc]['trials']} trials/batch)")
    # per-process throughput of the smallest arm is the weak-scaling
    # baseline: efficiency_n = (trials_per_s_n / n) / that
    base = results[arms[0]]["trials_per_s"] / arms[0]
    curve = {n: {"trials_per_s": results[n]["trials_per_s"],
                 "speedup": results[n]["trials_per_s"] / (base * arms[0]),
                 "efficiency": (results[n]["trials_per_s"] / n) / base}
             for n in arms}
    ncores = os.cpu_count()
    out = {"arms": results,
           "pinning": f"1 core + {args.devices_per_proc} CPU device(s) "
                      "per process",
           "devices_per_proc": args.devices_per_proc,
           "per_proc_trials": args.trials_per_proc,
           "cpu_cores": ncores,
           "note": ("points with nproc > cpu_cores oversubscribe physical "
                    "cores; their efficiency measures core contention on "
                    "this box, not the communication fabric"),
           "config": "perf (XLA lowrank chain)" if args.perf
           else "stream small",
           "curve": {str(n): {k: round(v, 4) for k, v in c.items()}
                     for n, c in curve.items()}}
    print(json.dumps({str(n): round(curve[n]["efficiency"], 3)
                      for n in arms}))
    name = ("multiprocess_scaling_perf.json" if args.perf
            else "multiprocess_scaling.json")
    if args.devices_per_proc > 1:
        name = name.replace(".json",
                            f"_{args.devices_per_proc}dev.json")
    path = os.path.join(REPO, "results", name)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--bench", action="store_true",
                    help="weak-scaling throughput arms (1 vs N processes, "
                         "core-pinned) instead of the parity checks")
    ap.add_argument("--streaming", action="store_true",
                    help="BASELINE config 5: scene-sharded streaming "
                         "Monte-Carlo across coordinator-joined processes "
                         "(arms from --arms), exact-parity + throughput")
    ap.add_argument("--scenes", type=int, default=16)
    ap.add_argument("--targets-per-scene", type=int, default=8)
    ap.add_argument("--trials-per-scene", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--trials-per-proc", type=int, default=16)
    ap.add_argument("--arms", default="1,2,4",
                    help="comma-separated process counts for the --bench "
                         "weak-scaling curve")
    ap.add_argument("--perf", action="store_true",
                    help="--bench/--worker: run the fused-kernel PERF "
                         "config dp-sharded via shard_map instead of the "
                         "small stream config")
    ap.add_argument("--bench-reps", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--logdir", default="/tmp")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from radar_tpu.utils.device import setup_compile_cache

    setup_compile_cache()
    if args.out is None and not args.worker:
        # per-mode artifact defaults (workers get --out passed explicitly)
        args.out = os.path.join(
            REPO, "results",
            "streaming_mc_multiproc.json" if args.streaming
            else "multiprocess_parity.json")
    if args.worker and args.streaming:
        sys.exit(worker_streaming(args))
    if args.worker and args.bench:
        sys.exit(worker_bench(args))
    if args.worker:
        sys.exit(worker_main(args))
    if args.streaming:
        sys.exit(streaming_orchestrate(args))
    if args.bench:
        sys.exit(bench_orchestrate(args))
    sys.exit(orchestrate(args))


if __name__ == "__main__":
    main()
