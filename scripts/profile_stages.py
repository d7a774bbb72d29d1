"""On-device per-stage profiler for the frame pipeline.

Methodology:
  - time an on-device ``lax.fori_loop`` running the stage N times inside ONE
    program (host-side per-call timing measures dispatch latency/caches);
  - regenerate the stage input from the PRNG **every iteration** — varying
    the input by a scalar factor is useless because every DSP stage is
    linear and XLA hoists the whole stage out of the loop as
    loop-invariant;
  - consume the full output with a NONLINEAR reduction sum(|y|): consuming
    one element lets XLA dead-code-eliminate the stage, and a plain sum of
    a linear stage gets algebraically factored through it;
  - subtract the input-generation cost measured with an identity stage;
  - force a scalar transfer after each timed call.

Writes results/stage_profile.json. Run on the accelerator to profile.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def ondevice_loop_time(stage_fn, gen_fn, consume_fn, n1=3, n2=23):
    key = jax.random.PRNGKey(0)

    def loop(n, k0):
        def body(i, acc):
            x = gen_fn(jax.random.fold_in(k0, i))
            return acc + consume_fn(stage_fn(x))
        return jax.lax.fori_loop(0, n, body, jnp.float32(0))

    f = jax.jit(loop)
    for n in (n1, n2):
        float(f(n, key))

    def t(n, s):
        # a scalar transfer drains the device
        t0 = time.perf_counter()
        float(f(n, jax.random.PRNGKey(s)))
        return time.perf_counter() - t0

    return (min(t(n2, 1), t(n2, 2)) - min(t(n1, 3), t(n1, 4))) / (n2 - n1)


def main() -> None:
    from radar_tpu.cluster.stages import cluster_stage1, cluster_stage2
    from radar_tpu.config.params import full_config
    from radar_tpu.measure.estimate import estimate_parameters
    from radar_tpu.ops.cfar import (extract_detections, goca_cfar_2d,
                                    pair_sum_maps)
    from radar_tpu.ops.dbf import dbf
    from radar_tpu.ops.mtd import mtd
    from radar_tpu.ops.pulse_compression import (make_matmul_plan,
                                                 make_plan, pulse_compress,
                                                 pulse_compress_matmul)
    from radar_tpu.pipeline.frame import measure_consts
    from radar_tpu.sim.echo import add_noise, synthesize_echoes
    from radar_tpu.sim.scenario import TargetBatch
    from radar_tpu.waveform.precompute import precompute

    cfg = full_config()
    pre = precompute(cfg)
    plan = make_plan(pre)
    mplan = make_matmul_plan(pre)
    mc = measure_consts(cfg, pre, jnp.float32)
    ip = cfg.interp
    dbf_w = np.asarray(pre.dbf_w)
    mtd_win = np.asarray(pre.mtd_win, np.float32)
    tb = TargetBatch(*[jnp.asarray(x, jnp.float32) for x in
                       TargetBatch.make([3000., 10000.], [20., 25.],
                                        [10., 10.], [10., 15.])])
    p, s, c, b, g = (cfg.sig.prt_num, cfg.sig.point_prt, cfg.sig.channel_num,
                     cfg.sig.beam_num, cfg.sig.n_total_gate)

    def cxgen(shape):
        def gen(k):
            a = jax.random.normal(k, shape + (2,), jnp.float32)
            return (a[..., 0] + 1j * a[..., 1]).astype(jnp.complex64)
        return gen

    # nonlinear consume: sum(|y|) — a plain sum of a linear stage gets
    # algebraically factored through the stage and the stage vanishes
    r_sum = lambda y: jnp.sum(jnp.abs(y))
    results = {"device": jax.devices()[0].device_kind}

    def record(name, stage_fn, gen, consume=r_sum):
        base = ondevice_loop_time(lambda x: x, gen,
                                  lambda y: jnp.real(y).ravel()[0])
        full = ondevice_loop_time(stage_fn, gen, consume)
        results[name] = round((full - base) * 1e3, 3)
        print(f"{name:14s} {results[name]:8.3f} ms  (gen {base*1e3:.3f})",
              flush=True)

    record("synth+noise",
           lambda k: add_noise(k, synthesize_echoes(tb, pre, cfg)),
           lambda k: k, r_sum)
    record("dbf", lambda x: dbf(x, dbf_w, "v8"), cxgen((p, s, c)))
    record("pulse_compress_matmul",
           lambda x: pulse_compress_matmul(x, mplan), cxgen((p, s, b)))
    record("pulse_compress_fft", lambda x: pulse_compress(x, pre, plan),
           cxgen((p, s, b)))
    record("mtd", lambda x: mtd(x, mtd_win, None), cxgen((p, g, b)))
    record("pair+cfar",
           lambda x: goca_cfar_2d(pair_sum_maps(x), cfg.cfar)[0],
           cxgen((p, g, b)), lambda y: jnp.sum(y.astype(jnp.float32)))

    def detection_tail(x):
        maps = pair_sum_maps(x)
        mask, _ = goca_cfar_2d(maps, cfg.cfar)
        dets = extract_detections(mask, maps, cfg.cfar.max_detections)
        params = estimate_parameters(dets, maps, x, mc, ip.extra_dots,
                                     ip.r_interp_times, ip.v_interp_times)
        s2 = cluster_stage2(cluster_stage1(params, cfg.cluster), cfg.cluster)
        return (dets.count + s2.count).astype(jnp.float32)

    record("cfar+tail", detection_tail, cxgen((p, g, b)),
           lambda y: y)

    os.makedirs("results", exist_ok=True)
    with open("results/stage_profile.json", "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
