"""Write results/frame_timing.json: end-to-end frame time on the GPU for the
full 16ch x 332p reference config, the 64ch x 256p and 128ch x 332p scaled
configs through the perf pipeline, and the exact reference-stream path at
64 ch (per-channel cube synthesis + AWGN + DBF + PC + MTD, no rank-K
shortcut). Slope-timed with bench.py's recipe (radar_tpu/bench/timing.py).

Usage: python scripts/bench_frame_timing.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp


def time_cfg(cfg, label):
    from radar_tpu.bench.timing import frame_time_slope, make_frames_loop
    from radar_tpu.pipeline.frame import make_frame_processor
    from radar_tpu.sim.scenario import TargetBatch

    process = make_frame_processor(cfg, dtype=jnp.complex64, jit=False)
    targets = TargetBatch(*[jnp.asarray(x, jnp.float32) for x in
                            TargetBatch.make([3000.0, 10000.0], [20.0, 25.0],
                                             [10.0, 10.0], [10.0, 15.0])])
    dt, slopes = frame_time_slope(make_frames_loop(process, targets))
    row = {"frame_ms": 1e3 * dt, "frames_per_s": 1.0 / dt,
           "slope_spread_ms": [1e3 * s for s in sorted(slopes)]}
    print(json.dumps({"config": label, **row}), flush=True)
    return row


def main():
    from radar_tpu.config.params import (full_config, perf_config,
                                         scaled_config)
    from radar_tpu.utils.device import (gpu_identity, require_gpu,
                                        setup_compile_cache)

    dev = require_gpu()
    name, power_limit = gpu_identity()[0]
    setup_compile_cache()
    data = {
        "device": {"kind": dev.device_kind, "name": name,
                   "power_limit": power_limit},
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "full_16ch_332p": time_cfg(perf_config(), "full_16ch_332p"),
        "scaled_64ch_256p": time_cfg(perf_config(scaled_config(64, 256)),
                                     "scaled_64ch_256p"),
        "scaled_128ch_332p": time_cfg(perf_config(scaled_config(128, 332)),
                                      "scaled_128ch_332p"),
        "scaled_64ch_256p_stream": time_cfg(scaled_config(64, 256),
                                            "scaled_64ch_256p_stream"),
        "full_16ch_332p_stream": time_cfg(full_config(),
                                          "full_16ch_332p_stream"),
    }
    path = os.path.join(os.path.dirname(__file__), "..", "results",
                        "frame_timing.json")
    with open(path, "w") as fh:
        json.dump(data, fh, indent=1)
    print("wrote", os.path.normpath(path))


if __name__ == "__main__":
    main()
