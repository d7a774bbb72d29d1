"""Device frame-time measurement shared by bench.py and chip_smoke.py.

Frames run inside ONE on-device ``lax.fori_loop`` program with a traced trip
count (one compile), every per-frame output consumed into the loop carry so
nothing is dead-code-eliminated, and a per-frame PRNG key so no stage can be
hoisted out of the loop. Per-frame time is the slope between a short and a
long run, which cancels the fixed dispatch and transfer cost; the median of
several interleaved (short, long) pairs resists a single disturbed pair.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp


def make_frames_loop(process, targets):
    """Jitted ``loop(n, key) -> f32 scalar`` running ``process`` (an un-jitted
    frame processor) on ``n`` frames with keys ``fold_in(key, i)``."""

    def frames_loop(n, key):
        def body(i, acc):
            res = process(jax.random.fold_in(key, i), targets)
            t = res.targets
            return (acc + jnp.sum(t.range_m) + jnp.sum(t.velocity_ms)
                    + jnp.sum(t.angle_deg) + jnp.sum(t.power)
                    + res.num_raw_detections.astype(jnp.float32))
        return jax.lax.fori_loop(0, n, body, jnp.float32(0))

    return jax.jit(frames_loop)


def frame_time_slope(loop, n_small: int = 5, n_large: int = 55,
                     pairs: int = 4) -> tuple[float, list[float]]:
    """(median per-frame seconds, per-pair slopes) of a :func:`make_frames_loop`
    program. Compiles and warms up first."""
    for _ in range(2):
        float(loop(2, jax.random.PRNGKey(0)))

    def timed(n, seed):
        t0 = time.perf_counter()
        float(loop(n, jax.random.PRNGKey(seed)))  # scalar readback drains
        return time.perf_counter() - t0

    slopes = []
    for i in range(pairs):
        t_s = timed(n_small, 10 * i + 1)
        t_l = timed(n_large, 10 * i + 2)
        slopes.append((t_l - t_s) / (n_large - n_small))
    valid = sorted(s for s in slopes if s > 0)
    if not valid:
        raise RuntimeError(f"no positive frame-time slope: {slopes}")
    m = len(valid)
    return (valid[(m - 1) // 2] + valid[m // 2]) / 2.0, slopes
