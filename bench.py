"""End-to-end benchmark: full-frame radar pipeline on the GPU vs the
vectorized NumPy reference chain on the host CPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

Frame = the reference's full problem size (16 channels x 332 pulses x 5819
samples -> 332 x 3404 x 13 RDM -> 12-pair 2D GOCA-CFAR -> spline/monopulse
measurement -> two-stage clustering; main_simulate_echoes_with_array_v8_3.m:
71-84), through the perf configuration (config/params.py::PERF_OVERRIDES).

Frames run inside one on-device ``lax.fori_loop`` program and the per-frame
time is a slope between two trip counts (radar_tpu/bench/timing.py). With
no GPU the script exits non-zero instead of timing a CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

# Pin the NumPy baseline's BLAS threading BEFORE numpy loads its BLAS:
# the baseline frame time otherwise swings with ambient thread scheduling
# (23.9-36.4 s across BENCH_r01-r03), making vs_baseline the noisiest
# number in the artifact. Single-threaded + min-of-3 (below) makes the
# denominator reproducible to a few percent.
for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
           "NUMEXPR_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import numpy as np  # noqa: E402


def main() -> None:
    import jax
    import jax.numpy as jnp

    from radar_tpu.bench.baseline_np import frame_baseline_np
    from radar_tpu.bench.timing import frame_time_slope, make_frames_loop
    from radar_tpu.config.params import perf_config
    from radar_tpu.pipeline.frame import make_frame_processor
    from radar_tpu.sim.scenario import TargetBatch
    from radar_tpu.utils.device import (gpu_identity, require_gpu,
                                        setup_compile_cache)
    from radar_tpu.waveform.precompute import precompute

    dev = require_gpu()
    card, power_limit = gpu_identity()[0]
    setup_compile_cache()
    cfg = perf_config()
    precomp = precompute(cfg)
    process = make_frame_processor(cfg, precomp, dtype=jnp.complex64,
                                   jit=False)
    targets_np = TargetBatch.make([3000.0, 10000.0], [20.0, 25.0],
                                  [10.0, 10.0], [10.0, 15.0])
    targets = TargetBatch(*[jnp.asarray(x, jnp.float32)
                            for x in targets_np])
    dt, slopes = frame_time_slope(make_frames_loop(process, targets))
    frames_per_s = 1.0 / dt

    # baseline: vectorized numpy reference chain on host CPU. The
    # denominator is PINNED to a one-time measurement stored with
    # provenance (radar_tpu/bench/baseline_pin.json: seed 0, 1-thread
    # BLAS, min-of-runs on an idle host) — a live measurement swings with
    # ambient load (23.9-133 s observed across rounds/sessions), which
    # made vs_baseline the noisiest number in the artifact. Delete the
    # pin file (or run scripts/pin_baseline.py) to re-measure.
    import platform

    pin_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "radar_tpu", "bench", "baseline_pin.json")
    pin = None
    if os.path.exists(pin_path):
        with open(pin_path) as fh:
            pin = json.load(fh)
        # the pin was measured on ONE specific host; on any other machine
        # its denominator is meaningless — fall back to live measurement
        # there (advisor round-4 finding)
        pin_node = pin.get("node", pin.get("host", ""))
        if platform.node() not in (pin_node, pin_node.split(" ")[0]):
            print(f"# baseline pin is for host {pin_node!r}, this is "
                  f"{platform.node()!r}; measuring live", file=sys.stderr)
            pin = None
    if pin is not None:
        baseline_dt = pin["frame_ms"] / 1e3
        baseline_src = f"pinned {pin['date']} host={pin.get('node', '?')}"
    else:
        runs = []
        for _ in range(3):
            rng = np.random.default_rng(0)
            t0 = time.perf_counter()
            frame_baseline_np(rng, targets_np, precomp, cfg)
            runs.append(time.perf_counter() - t0)
        baseline_dt = min(runs)
        baseline_src = f"live min of {[round(1e3 * t) for t in runs]} ms"
    baseline_fps = 1.0 / baseline_dt

    print(json.dumps({
        "metric": "frames_per_s_e2e_16ch_332p",
        "value": round(frames_per_s, 3),
        "unit": "frames/s",
        "vs_baseline": round(frames_per_s / baseline_fps, 2),
        "baseline": baseline_src,
        "slope_spread_ms": [round(1e3 * s, 3) for s in sorted(slopes)],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "name": card,
                   "power_limit": power_limit},
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }))
    print(f"# device={dev.device_kind} "
          f"jax_frame={1e3 * dt:.2f}ms "
          f"slopes_ms={[round(1e3 * s, 2) for s in slopes]} "
          f"numpy_frame={1e3 * baseline_dt:.1f}ms "
          f"({baseline_src}, 1-thread BLAS, seed 0)", file=sys.stderr)


if __name__ == "__main__":
    main()
