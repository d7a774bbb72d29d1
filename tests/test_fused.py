"""Fused synthesis+DBF beam-space path (cfg.fused_synth_dbf).

Checks the two halves of the fusion independently:
  1. signal: synthesize_echo_beams == dbf(synthesize_echoes(...)) exactly
     (same algebra, different contraction order);
  2. noise: beam-space AWGN drawn from the Cholesky factor has the same
     first/second moments (covariance M M^H, zero pseudo-covariance) as
     per-channel AWGN passed through DBF (fun_process_single_frame.m:81-97);
then the full pipeline end-to-end on the small config.
"""

import jax
import jax.numpy as jnp
import numpy as np

from radar_tpu.config.params import small_test_config
from radar_tpu.ops.dbf import dbf, dbf_weights_effective
from radar_tpu.pipeline.frame import make_frame_processor
from radar_tpu.sim.echo import (add_noise, add_noise_beamspace,
                                beam_noise_factor, synthesize_echo_beams,
                                synthesize_echoes)
from radar_tpu.sim.scenario import TargetBatch
from radar_tpu.waveform.precompute import precompute


def _weff(pre, variant="v8"):
    return np.asarray(dbf_weights_effective(jnp.asarray(pre.dbf_w), variant))


def test_fused_signal_matches_unfused():
    cfg = small_test_config(channels=8, pulses=16)
    pre = precompute(cfg)
    tb = TargetBatch.make([3000.0, 8000.0], [12.0, -7.0], [10.0, 25.0],
                          [20.0, 10.0])
    w_eff = _weff(pre)
    want = np.asarray(dbf(synthesize_echoes(tb, pre, cfg,
                                            dtype=jnp.complex128),
                          jnp.asarray(pre.dbf_w), "v8"))
    got = np.asarray(synthesize_echo_beams(tb, pre, cfg, w_eff.T,
                                           dtype=jnp.complex128))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_beamspace_noise_covariance():
    cfg = small_test_config(channels=8, pulses=16)
    pre = precompute(cfg)
    w_eff = _weff(pre)
    n_beams = w_eff.shape[0]
    l_np = beam_noise_factor(w_eff)
    want_cov = w_eff @ w_eff.conj().T  # p_noise = 1

    # factor reproduces the covariance exactly
    np.testing.assert_allclose(l_np @ l_np.conj().T, want_cov,
                               rtol=1e-10, atol=1e-10)

    # empirical moments of the sampled beam noise
    zeros = jnp.zeros((200, 500, n_beams), jnp.complex128)
    y = np.asarray(add_noise_beamspace(jax.random.PRNGKey(3), zeros, l_np))
    flat = y.reshape(-1, n_beams)
    n = flat.shape[0]
    emp_cov = flat.T @ flat.conj() / n  # C[a,b] = E[y_a * conj(y_b)]
    emp_pseudo = flat.T @ flat / n
    scale = np.abs(np.diag(want_cov)).mean()
    np.testing.assert_allclose(emp_cov, want_cov,
                               atol=6 * scale / np.sqrt(n))
    np.testing.assert_allclose(emp_pseudo, 0.0 * emp_pseudo,
                               atol=6 * scale / np.sqrt(n))
    assert np.abs(flat.mean(0)).max() < 6 * np.sqrt(scale / n)

    # ... and they match channel-noise -> DBF moments empirically
    zeros_c = jnp.zeros((200, 500, cfg.sig.channel_num), jnp.complex128)
    ch = add_noise(jax.random.PRNGKey(4), zeros_c)
    via_dbf = np.asarray(dbf(ch, jnp.asarray(pre.dbf_w), "v8"))
    flat2 = via_dbf.reshape(-1, n_beams)
    emp_cov2 = flat2.T @ flat2.conj() / n
    np.testing.assert_allclose(emp_cov2, want_cov,
                               atol=6 * scale / np.sqrt(n))


def test_fused_pipeline_detects_truth():
    cfg = small_test_config().replace(fused_synth_dbf=True)
    process = make_frame_processor(cfg, dtype=jnp.complex64)
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [20.0])
    res = process(jax.random.PRNGKey(0), tb)
    n = int(res.num_final)
    assert n >= 1
    r = np.asarray(res.targets.range_m)[:n]
    v = np.asarray(res.targets.velocity_ms)[:n]
    pre = precompute(cfg)
    assert np.min(np.abs(r - 3000.0)) < 2 * pre.delta_r
    assert np.min(np.abs(v - 15.0)) < 2 * pre.delta_v


def test_fused_matches_unfused_statistics():
    """Same scene, fused vs unfused: the detected target parameters agree
    within measurement noise (different random streams, same distribution)."""
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [25.0])
    outs = []
    for fused in (False, True):
        cfg = small_test_config().replace(fused_synth_dbf=fused)
        process = make_frame_processor(cfg, dtype=jnp.complex64)
        res = process(jax.random.PRNGKey(7), tb)
        n = int(res.num_final)
        assert n >= 1
        i = int(np.argmax(np.asarray(res.targets.power)[:n]))
        outs.append((float(res.targets.range_m[i]),
                     float(res.targets.velocity_ms[i])))
    (r0, v0), (r1, v1) = outs
    pre = precompute(small_test_config())
    assert abs(r0 - r1) < 2 * pre.delta_r
    assert abs(v0 - v1) < 2 * pre.delta_v


def test_lowrank_rdm_matches_fused_exactly():
    """The lowrank path commutes PC/MTD past the beam mixing and collapses
    the signal to rank-K outer products — an exact linear identity. With
    the same key it draws the SAME white noise, so detections must agree
    with the fused path up to float reassociation."""
    tb = TargetBatch.make([3000.0, 8000.0], [15.0, -7.0], [10.0, 22.0],
                          [20.0, 14.0])
    outs = []
    for lowrank in (False, True):
        cfg = small_test_config().replace(fused_synth_dbf=True,
                                          lowrank_rdm=lowrank,
                                          compact_noise=False)
        process = make_frame_processor(cfg, dtype=jnp.complex64)
        outs.append(process(jax.random.PRNGKey(5), tb))
    a, b = outs
    assert int(a.num_raw_detections) == int(b.num_raw_detections)
    assert int(a.num_final) == int(b.num_final)
    av, bv = np.asarray(a.targets.valid), np.asarray(b.targets.valid)
    np.testing.assert_array_equal(av, bv)
    np.testing.assert_allclose(np.asarray(a.targets.range_m)[av],
                               np.asarray(b.targets.range_m)[bv], rtol=1e-4)
    np.testing.assert_allclose(np.asarray(a.targets.velocity_ms)[av],
                               np.asarray(b.targets.velocity_ms)[bv],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.targets.angle_deg)[av],
                               np.asarray(b.targets.angle_deg)[bv],
                               rtol=1e-3, atol=1e-3)


def test_compact_noise_plan_exact_remap():
    """Feeding the union-window slices of a full cube through the compacted
    plan must reproduce the full-plan PC output exactly (the remap is pure
    index bookkeeping)."""
    from radar_tpu.ops.pulse_compression import (compact_noise_plan,
                                                 make_matmul_plan,
                                                 pulse_compress_matmul)

    cfg = small_test_config(channels=8, pulses=8)
    pre = precompute(cfg)
    mplan = make_matmul_plan(pre)
    nplan, nlen = compact_noise_plan(mplan)
    assert nlen <= cfg.sig.point_prt
    rng = np.random.default_rng(2)
    full = (rng.normal(size=(8, cfg.sig.point_prt, 3))
            + 1j * rng.normal(size=(8, cfg.sig.point_prt, 3))
            ).astype(np.complex64)
    # build the compacted cube by copying the merged windows
    intervals = sorted((w0, w0 + wl) for w0, wl, _ in mplan.chunks)
    merged = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    compact = np.concatenate([full[:, a:b] for a, b in merged], axis=1)
    assert compact.shape[1] == nlen
    want = np.asarray(pulse_compress_matmul(jnp.asarray(full), mplan))
    got = np.asarray(pulse_compress_matmul(jnp.asarray(compact), nplan))
    np.testing.assert_array_equal(got, want)


def test_compact_noise_pipeline_detects_truth():
    cfg = small_test_config().replace(fused_synth_dbf=True, lowrank_rdm=True,
                                      compact_noise=True)
    process = make_frame_processor(cfg, dtype=jnp.complex64)
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [20.0])
    res = process(jax.random.PRNGKey(0), tb)
    n = int(res.num_final)
    assert n >= 1
    pre = precompute(cfg)
    r = np.asarray(res.targets.range_m)[:n]
    assert np.min(np.abs(r - 3000.0)) < 2 * pre.delta_r
