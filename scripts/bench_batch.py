"""Batched-frame throughput: vmap the perf-config frame processor over B
independent frames (B PRNG keys, same targets) and measure frames/s vs the
sequential loop.

Rationale: the detection tail is dozens of 512-element ops that do not
fill the device; batching frames amortizes that without touching any
stage. The per-frame arithmetic is IDENTICAL (vmap of the same program).

Same methodology as bench.py: on-device fori_loop, traced trip count, every
output consumed into the carry, slope between two trip counts.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp


def time_batch(batch: int, n1=4, n2=24):
    from radar_tpu.config.params import perf_config
    from radar_tpu.pipeline.frame import make_frame_processor
    from radar_tpu.sim.scenario import TargetBatch

    cfg = perf_config()
    process = make_frame_processor(cfg, dtype=jnp.complex64, jit=False)
    targets_np = TargetBatch.make([3000.0, 10000.0], [20.0, 25.0],
                                  [10.0, 10.0], [10.0, 15.0])
    targets = TargetBatch(*[jnp.asarray(x, jnp.float32)
                            for x in targets_np])

    def one(key):
        res = process(key, targets)
        t = res.targets
        return (jnp.sum(t.range_m) + jnp.sum(t.velocity_ms)
                + jnp.sum(t.angle_deg) + jnp.sum(t.power)
                + res.num_raw_detections.astype(jnp.float32))

    batched = jax.vmap(one) if batch > 1 else one

    def loop(n, k0):
        def body(i, acc):
            k = jax.random.fold_in(k0, i)
            if batch > 1:
                return acc + jnp.sum(batched(jax.random.split(k, batch)))
            return acc + batched(k)
        return jax.lax.fori_loop(0, n, body, jnp.float32(0))

    f = jax.jit(loop)
    key = jax.random.PRNGKey(0)
    for n in (n1, n1):
        float(f(n, key))

    def t(n, s):
        t0 = time.perf_counter()
        float(f(n, jax.random.PRNGKey(s)))
        return time.perf_counter() - t0

    dt = (min(t(n2, 1), t(n2, 2)) - min(t(n1, 3), t(n1, 4))) / (n2 - n1)
    per_frame = dt / batch
    print(json.dumps({"batch": batch,
                      "ms_per_frame": round(1e3 * per_frame, 3),
                      "frames_per_s": round(1.0 / per_frame, 1)}),
          flush=True)
    return per_frame


def main():
    argv = sys.argv[1:]
    batches = [int(a) for a in argv if not a.startswith("-")] or [1, 2, 4, 8]
    out = {}
    for b in batches:
        out[b] = time_batch(b)
    if len(out) > 1:
        base = out[batches[0]]
        print(json.dumps({"speedup_vs_batch1":
                          {b: round(base / v, 3) for b, v in out.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
