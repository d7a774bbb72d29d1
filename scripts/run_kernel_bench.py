"""Per-kernel benchmarks on the available accelerator (BASELINE.json
metrics: "range-Doppler samples/s/chip" for the DBF matmul and matched-filter
kernels, MUSIC at 128 elements). Writes results/kernel_bench.json.

Methodology: each kernel runs inside one on-device fori_loop with its input regenerated
from the PRNG every iteration (a scaled input lets XLA hoist linear kernels
out of the loop entirely) and its full output consumed into the loop carry;
the generator-only loop cost is subtracted. Numbers are producer-fused
throughput: the input may stream from the RNG without a HBM round trip,
which matches how the kernels run inside the real fused pipeline.
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
    for n in (2, 2):
        float(f(n, key))

    def t(n, s):
        # a scalar transfer drains the device
        t0 = time.perf_counter()
        float(f(n, jax.random.PRNGKey(s)))
        return time.perf_counter() - t0

    return (min(t(n2, 1), t(n2, 2)) - min(t(n1, 3), t(n1, 4))) / (n2 - n1)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated kernel-name substrings to run "
                         "(others keep their recorded values)")
    args = ap.parse_args()
    from radar_tpu.utils.device import setup_compile_cache

    setup_compile_cache()
    only = args.only.split(",") if args.only else None

    from radar_tpu.config.params import full_config
    from radar_tpu.ops.dbf import dbf
    from radar_tpu.ops.mtd import mtd
    from radar_tpu.ops.pulse_compression import (make_matmul_plan,
                                                 pulse_compress_matmul)
    from radar_tpu.waveform.precompute import precompute

    # merge into the existing artifact (preserves the roofline block from
    # scripts/bench_roofline.py and any entries skipped via --only)
    results = {}
    if os.path.exists("results/kernel_bench.json"):
        with open("results/kernel_bench.json") as f:
            results = json.load(f)
    device = jax.devices()[0].device_kind
    if only is not None and results.get("device") not in (None, device):
        # a partial re-run on a DIFFERENT backend must not relabel the
        # kept entries; measured entries get their own device tag below
        print(f"note: kept entries remain attributed to "
              f"{results['device']}; new entries tagged {device}")
    else:
        results["device"] = device
    results["method"] = "on-device fori_loop, RNG input/iter, full consume"
    cfg = full_config()
    pre = precompute(cfg)
    mplan = make_matmul_plan(pre)
    p, s, c, b, g = (cfg.sig.prt_num, cfg.sig.point_prt, cfg.sig.channel_num,
                     cfg.sig.beam_num, cfg.sig.n_total_gate)
    w = np.asarray(pre.dbf_w)
    mtd_win = np.asarray(pre.mtd_win, np.float32)

    def cxgen(shape):
        def gen(k):
            a = jax.random.normal(k, shape + (2,), jnp.float32)
            return (a[..., 0] + 1j * a[..., 1]).astype(jnp.complex64)
        return gen

    # NB consume must be NONLINEAR in the kernel output: XLA's algebraic
    # simplifier factors sum(linear_op(x)) into linear_op(sum(x)) and the
    # kernel vanishes from the loop. sum(|y|) is not factorable.
    r_sum = lambda y: jnp.sum(jnp.abs(y))

    def record(name, fn, gen, extra):
        if only is not None and not any(s in name for s in only):
            print(f"{name}: kept recorded value (--only)", flush=True)
            return
        base = ondevice_loop_time(lambda x: x, gen,
                                  lambda y: jnp.real(y).ravel()[0])
        dt = ondevice_loop_time(fn, gen, r_sum) - base
        results[name] = {"ms": round(dt * 1e3, 3), **extra(dt)}
        if results.get("device") != device:
            results[name]["device"] = device   # partial cross-backend run
        print(name, results[name], flush=True)

    record("dbf_16ch_13beam", lambda x: dbf(x, w, "v8"), cxgen((p, s, c)),
           lambda dt: {"input_msamples_per_s": round(p * s * c / dt / 1e6, 1),
                       "gflops": round(8 * p * s * c * b / dt / 1e9, 1)})
    record("pulse_compression_matmul",
           lambda x: pulse_compress_matmul(x, mplan), cxgen((p, s, b)),
           lambda dt: {"output_msamples_per_s": round(p * g * b / dt / 1e6,
                                                      1)})
    record("mtd_332pt", lambda x: mtd(x, mtd_win, None), cxgen((p, g, b)),
           lambda dt: {"msamples_per_s": round(p * g * b / dt / 1e6, 1)})

    from radar_tpu.doa.music import (covariance, music_spectrum_1d,
                                     noise_subspace, regional_max_peaks_2d,
                                     steering_ura)

    d = cfg.sig.wavelength / 2
    scan = np.arange(-90.0, 90.0, 0.05)
    record("music_128el_1024snap_3600grid",
           lambda x: music_spectrum_1d(covariance(x), 3, scan, d,
                                       cfg.sig.wavelength),
           cxgen((128, 1024)), lambda dt: {})

    # MUSIC 2D at the 128-element BASELINE-4 aperture: 16x8 URA, 481x281
    # grid at 0.25 deg, spectrum + DEVICE-side regional-max peak picking
    # (MUSIC_2D.m:32-93,119-144 scaled; grid matmul [C-M,C]x[C,G])
    az2 = np.arange(-60.0, 60.0 + 1e-9, 0.25)
    el2 = np.arange(10.0, 80.0 + 1e-9, 0.25)
    a2 = steering_ura(az2, el2, 16, 8, 0.5).astype(np.complex64)

    def music2d(x):
        en = noise_subspace(covariance(x), 3)
        proj = jnp.conj(en.T) @ jnp.asarray(a2)
        spec = (1.0 / (jnp.sum(jnp.abs(proj) ** 2, axis=0)
                       + 1e-30)).reshape(len(az2), len(el2))
        idx, vals = regional_max_peaks_2d(spec, 3)
        return vals + idx.astype(jnp.float32)

    record("music2d_128el_16x8ura_481x281grid", music2d,
           cxgen((128, 512)),
           lambda dt: {"grid_points": len(az2) * len(el2)})

    os.makedirs("results", exist_ok=True)
    with open("results/kernel_bench.json", "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
