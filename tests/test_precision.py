"""bf16 complex-matmul variant (ops/precision.py, cfg.matmul_precision):
numeric error bounds vs the f32 path and end-to-end detection equivalence.
The statistical acceptance evidence (Pd/sigma sweep parity with f32) lives
in git show dc6ffd7:results/bf16_matmul.json."""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from radar_tpu.config.params import small_test_config
from radar_tpu.ops.mtd import make_mtd_matrix, mtd_matmul
from radar_tpu.ops.precision import einsum_complex_bf16
from radar_tpu.ops.pulse_compression import (make_matmul_plan,
                                             pulse_compress_matmul)
from radar_tpu.pipeline.frame import make_frame_processor
from radar_tpu.sim.scenario import TargetBatch
from radar_tpu.waveform.precompute import precompute


def test_einsum_complex_bf16_error_bound():
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(16, 64)) + 1j * rng.normal(size=(16, 64))
         ).astype(np.complex64)
    b = (rng.normal(size=(64, 24)) + 1j * rng.normal(size=(64, 24))
         ).astype(np.complex64)
    got = np.asarray(einsum_complex_bf16("ij,jk->ik", jnp.asarray(a),
                                         jnp.asarray(b)))
    want = a @ b
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 0.02
    # complex x real promotion path (two matmuls)
    br = np.real(b).astype(np.float32)
    got2 = np.asarray(einsum_complex_bf16("ij,jk->ik", jnp.asarray(a),
                                          jnp.asarray(br)))
    rel2 = np.abs(got2 - a @ br).max() / np.abs(a @ br).max()
    assert rel2 < 0.02


@pytest.mark.slow
def test_mtd_and_pc_bf16_close_to_f32():
    cfg = small_test_config(channels=8, pulses=32)
    pre = precompute(cfg)
    rng = np.random.default_rng(1)
    beams = (rng.normal(size=(32, cfg.sig.point_prt, 5))
             + 1j * rng.normal(size=(32, cfg.sig.point_prt, 5))
             ).astype(np.complex64)
    x = jnp.asarray(beams)
    mplan = make_matmul_plan(pre)
    # jit: the CPU backend's EAGER dot thunk does not support
    # bf16 x bf16 -> f32; the compiled path does
    pc_f = jax.jit(lambda y, p: pulse_compress_matmul(x, mplan, precision=p),
                   static_argnums=1)
    pc32 = np.asarray(pc_f(x, "f32"))
    pc16 = np.asarray(pc_f(x, "bf16"))
    assert (np.abs(pc16 - pc32).max() / np.abs(pc32).max()) < 0.02
    m = make_mtd_matrix(pre.mtd_win, cfg.sig.prt_num, None)
    mtd_f = jax.jit(lambda y, p: mtd_matmul(y, m, precision=p),
                    static_argnums=1)
    r32 = np.asarray(mtd_f(jnp.asarray(pc32), "f32"))
    r16 = np.asarray(mtd_f(jnp.asarray(pc32), "bf16"))
    assert (np.abs(r16 - r32).max() / np.abs(r32).max()) < 0.02


def test_bf16_pipeline_detects_truth():
    cfg = small_test_config().replace(fused_synth_dbf=True,
                                      matmul_precision="bf16")
    process = make_frame_processor(cfg, dtype=jnp.complex64)
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [20.0])
    res = process(jax.random.PRNGKey(0), tb)
    n = int(res.num_final)
    assert n >= 1
    pre = precompute(cfg)
    r = np.asarray(res.targets.range_m)[:n]
    assert np.min(np.abs(r - 3000.0)) < 2 * pre.delta_r
