"""Monte-Carlo SNR sweep: monopulse angle-error sigma and detection
probability vs SNR (SURVEY.md section 3.3; reference
main_plot_snr_vs_angle_error.m).

The reference parallelizes trials with MATLAB ``parfor`` (its only parallel
construct, ref :167); here trials are a vmapped batch axis over PRNG keys —
the noiseless echo cube is synthesized once per SNR point and only the
noise+processing chain is batched, so a whole trial batch is one device
program (and shards over a data-parallel mesh axis, SURVEY.md section 2.3).

Per trial the recorded statistic follows the reference (:269-278): the
*first* final target's angle error vs truth, NaN when nothing is detected;
per SNR point: std('omitnan') of the errors and Pd = detection fraction.
The analytic reference bound is sigma = |k|*sqrt(2)/sqrt(SNR_lin) (:303-309).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config.params import RadarConfig
from ..sim.echo import (add_noise, add_noise_beamspace, beam_noise_factor,
                        synthesize_echo_beams, synthesize_echoes,
                        synthesize_factors, white_complex_noise)
from ..sim.scenario import TargetBatch
from ..waveform.precompute import Precomputed, precompute


class SweepResult(NamedTuple):
    snr_db: np.ndarray
    angle_error_std: np.ndarray   # [n_snr] degrees, std over detected trials
    detection_probability: np.ndarray
    errors: np.ndarray            # [n_snr, trials] raw errors (NaN = miss)
    theory_bound: np.ndarray      # |k|*sqrt(2)/sqrt(SNR_lin)


def _first_valid_angle(result):
    """Angle of the first valid final-target slot (the reference reads
    final_targets(1), ref :271-274); NaN if none."""
    t = result.targets
    has = jnp.any(t.valid)
    first = jnp.argmax(t.valid)  # first True
    return jnp.where(has, t.angle_deg[first], jnp.nan), has


def make_trial_fn(cfg: RadarConfig, precomp: Precomputed,
                  dtype=jnp.complex64):
    """Returns jitted ``trials(targets, keys) -> (angles [T], hits [T])``:
    one echo synthesis + the noise/processing chain vmapped over trial keys,
    all inside one program."""
    # reuse the frame pipeline minus echo synthesis
    from ..ops.dbf import dbf
    from ..ops.mtd import make_mtd_matrix, mtd, mtd_matmul
    from ..ops.pulse_compression import (make_matmul_plan, make_plan,
                                         pulse_compress, pulse_compress_matmul)
    from .frame import make_detection_tail

    plan = make_plan(precomp)
    mplan = make_matmul_plan(precomp) if cfg.pc_method == "matmul" else None
    real_dtype = jnp.finfo(dtype).dtype
    # host numpy constants, embedded in the compiled program at trace time
    dbf_w = np.asarray(precomp.dbf_w)
    mtd_win = np.asarray(precomp.mtd_win, real_dtype)
    mtd_mat = (make_mtd_matrix(precomp.mtd_win, cfg.sig.prt_num,
                               cfg.mtd_fft_len)
               if cfg.mtd_method == "matmul" else None)
    tail = make_detection_tail(cfg, precomp, real_dtype)
    if cfg.fused_synth_dbf:
        # beam-space noise factor (see sim/echo.beam_noise_factor): the
        # noiseless echo is synthesized directly in beam space once per SNR
        # point and each trial adds covariance-exact beam-space AWGN
        from ..ops.dbf import dbf_weights_effective_np

        w_eff = dbf_weights_effective_np(dbf_w, cfg.dbf_variant)
        mix_np = np.ascontiguousarray(w_eff.T)
        l_np = beam_noise_factor(w_eff)

    lowrank = cfg.lowrank_rdm and cfg.fused_synth_dbf
    if lowrank:
        from .lowrank import make_lowrank_stages

        lr = make_lowrank_stages(cfg, precomp, dtype)

    def _pc(x):
        return (pulse_compress_matmul(x, mplan,
                                      precision=cfg.matmul_precision)
                if mplan is not None else pulse_compress(x, precomp, plan))

    def _mtd(x):
        return (mtd_matmul(x, mtd_mat, precision=cfg.matmul_precision)
                if mtd_mat is not None else mtd(x, mtd_win, cfg.mtd_fft_len))

    def one_trial(echo, key):
        if lowrank:
            # echo here is the precomputed signal RDM (see trials below);
            # per trial: white beam noise -> PC -> MTD -> Cholesky mix
            rdm = lr.mix_add(echo, lr.mtd(lr.pc(lr.gen_noise(key))))
        else:
            if cfg.fused_synth_dbf:
                beams = add_noise_beamspace(key, echo, l_np)
            else:
                noisy = add_noise(key, echo)
                beams = dbf(noisy, dbf_w, cfg.dbf_variant)
            pc = _pc(beams)
            rdm = _mtd(pc)
        result, _ = tail(rdm)
        return _first_valid_angle(result)

    def trials(targets, keys):
        if lowrank:
            echo = lr.signal_rdm(targets)  # rank-K closed-form signal RDM
        elif cfg.fused_synth_dbf:
            echo = synthesize_echo_beams(targets, precomp, cfg, mix_np,
                                         dtype=dtype)
        else:
            echo = synthesize_echoes(targets, precomp, cfg, dtype=dtype)
        return jax.vmap(one_trial, in_axes=(None, 0))(echo, keys)

    return jax.jit(trials)


def snr_sweep(cfg: RadarConfig, snr_db_vector=None, num_trials: int = 100,
              truth: TargetBatch | None = None, true_pair_idx: int | None = None,
              seed: int = 0, batch_size: int = 16, dtype=jnp.complex64,
              precomp: Precomputed | None = None,
              progress: bool = False, mesh=None) -> SweepResult:
    """Run the sweep. Defaults mirror the reference: SNR -10..30 dB step 2,
    truth target R=10 km, V=20 m/s, El=10 deg (beam pair index 5, 0-based).

    ``mesh``: a :class:`jax.sharding.Mesh` with a ``dp`` axis to shard
    each trial batch over devices via :func:`parallel.dp.make_dp_trial_fn`
    (each device runs the COMPLETE per-trial pipeline on its slice; the reference's ``parfor`` boundary,
    main_plot_snr_vs_angle_error.m:167, mapped onto the device mesh).
    ``batch_size`` and ``num_trials`` must be multiples of the dp size."""
    if snr_db_vector is None:
        snr_db_vector = np.arange(-10.0, 30.0 + 1e-9, 2.0)
    snr_db_vector = np.asarray(snr_db_vector, np.float64)
    if precomp is None:
        precomp = precompute(cfg)
    if truth is None:
        truth = TargetBatch.make([10000.0], [20.0], [10.0], [0.0])
    if true_pair_idx is None:
        # pair whose beam interval contains the truth elevation
        a = precomp.beam_angles_deg
        true_pair_idx = int(np.clip(np.searchsorted(a, truth.elevation_deg[0])
                                    - 1, 0, len(a) - 2))
    k_slope = float(precomp.k_slopes_lut[true_pair_idx])

    if mesh is not None:
        from ..parallel.dp import make_dp_trial_fn
        from ..parallel.mesh import AXIS_DP

        n_dp = mesh.shape[AXIS_DP]
        if batch_size % n_dp or num_trials % n_dp:
            raise ValueError(
                f"batch_size={batch_size} and num_trials={num_trials} must "
                f"be multiples of the dp axis size {n_dp}")
        trials_fn = make_dp_trial_fn(cfg, mesh, precomp, dtype)
    else:
        trials_fn = make_trial_fn(cfg, precomp, dtype)
    key = jax.random.PRNGKey(seed)
    errors = np.full((len(snr_db_vector), num_trials), np.nan)
    for i, snr in enumerate(snr_db_vector):
        tb = TargetBatch(truth.range_m, truth.velocity_ms,
                         truth.elevation_deg,
                         np.full_like(truth.range_m, snr))
        skey = jax.random.fold_in(key, i)
        done = 0
        while done < num_trials:
            nb = min(batch_size, num_trials - done)
            keys = jax.random.split(jax.random.fold_in(skey, done), nb)
            angles, hits = jax.block_until_ready(trials_fn(tb, keys))
            angles = np.asarray(angles, np.float64)
            hits = np.asarray(hits)
            err = np.where(hits, angles - float(truth.elevation_deg[0]),
                           np.nan)
            errors[i, done:done + nb] = err
            done += nb
        if progress:
            pd = np.mean(~np.isnan(errors[i]))
            print(f"SNR {snr:+.0f} dB: Pd={pd:.2f} "
                  f"sigma={np.nanstd(errors[i], ddof=1):.4f} deg")

    with np.errstate(invalid="ignore"):
        sigma = np.array([np.nanstd(e, ddof=1) if np.sum(~np.isnan(e)) > 1
                          else np.nan for e in errors])
    pd = np.mean(~np.isnan(errors), axis=1)
    snr_lin = 10.0 ** (snr_db_vector / 10.0)
    theory = np.abs(k_slope) * np.sqrt(2.0) / np.sqrt(snr_lin)
    return SweepResult(snr_db_vector, sigma, pd, errors, theory)
