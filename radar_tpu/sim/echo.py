"""Device-side 16..128-channel echo synthesis (SURVEY.md L3 device part).

Array reformulation of the reference's triple loop
(fun_process_single_frame.m:45-88): instead of ``for m in pulses: for k in
targets: place pulse, phase, outer-product``, the whole raw-IQ cube is one
einsum over precomputed per-target factor vectors:

  raw[p, s, c] = sum_k  amp_k * dop_k[p] * base_k[s] * steer_k[c]

with
  base_k  = tx_pulse delayed by round(2R/c*fs) samples, zero-fill at the
            front, no wraparound (ref :66-69)
  dop_k   = exp(+j*2*pi*(2V/lambda)*p*PRT)                  (ref :57-58)
  amp_k   = sqrt(SNR_lin * P_noise / P_signal_unscaled)     (ref :61-63)
  steer_k = exp(+j*c_idx*2*pi*d*sin(El)/lambda)             (ref :71-74,163-169)

Complex AWGN with per-rail variance P_noise/2 is added over the full cube
from a single PRNG key folded per frame; JAX's counter-based RNG guarantees
the cross-channel independence the reference secures by per-channel randn
loops (ref :81-88; SURVEY.md section 5.2).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config.params import RadarConfig

_HIGHEST = jax.lax.Precision.HIGHEST  # full f32 (no TF32) on the GPU

P_NOISE_FLOOR = 1.0  # reference v8 noise floor (fun_process_single_frame.m:16)


def radar_equation_amplitude(range_m, rcs, wavelength: float,
                             gain: float = 1e8):
    """Historical v1 amplitude model (SURVEY.md section 2.1 "Amplitude
    models"): A = gain * sqrt(RCS * lambda^2) / (R^2 * (4*pi)^(3/2)), with
    the reference's fudge gain 1e8 (main_simulate_echoes_with_array.m:
    167-170). The v4 model is simply amplitude = 1 (_v4.m:157); the current
    SNR-referenced model (v7.5+) is the default inside the synthesizer."""
    import jax.numpy as jnp

    return (gain * jnp.sqrt(rcs * wavelength**2)
            / (range_m**2 * (4.0 * jnp.pi) ** 1.5))


def _target_factors(range_m, velocity_ms, elevation_deg, amp, tx_pulse,
                    num_pulses: int, num_channels: int,
                    element_spacing: float, wavelength: float, prt: float,
                    fs: float, c: float, dtype, nfft: int):
    """Per-target factor vectors (dop*amp [K,P], delayed base [K,S],
    steering [K,C]) shared by the channel-cube and fused-beam synthesizers."""
    num_samples = tx_pulse.shape[0]
    real_dtype = jnp.finfo(dtype).dtype

    delay_s = 2.0 * range_m / c
    delay_samples = jnp.round(delay_s * fs).astype(jnp.int32)  # [K]

    # Delayed base pulse per target: integer LINEAR shift applied in the
    # frequency domain on a power-of-2 grid: ifft(fft(tx, nfft) *
    # exp(-2pi*j*k*d/nfft))[:S]. Gather-free, and on the power-of-2 FFT
    # fast path (a length-S transform goes through Bluestein). ``nfft`` >=
    # S + tx support guarantees no wraparound for any delay < S, so this is
    # exactly the reference's zero-padded shift (ref :66-69). The phase
    # index k*d is reduced mod nfft with a bitwise AND so float32 phase
    # stays exact.
    sample_idx = jnp.arange(nfft)
    tx_f = jnp.fft.fft(tx_pulse, n=nfft)  # folded to a constant per program
    kd = (sample_idx[None, :] * delay_samples[:, None]) & (nfft - 1)  # [K,N]
    phase = (-2.0 * jnp.pi) * kd.astype(real_dtype) / nfft
    shift = jnp.exp(1j * phase).astype(dtype)
    rolled = jnp.fft.ifft(tx_f[None, :] * shift,
                          axis=-1)[..., :num_samples].astype(dtype)
    valid_delay = (delay_samples > 0) & (delay_samples < num_samples)
    mask = ((jnp.arange(num_samples)[None, :] >= delay_samples[:, None])
            & valid_delay[:, None])
    base = jnp.where(mask, rolled, 0.0).astype(dtype)

    # slow-time Doppler phasor per target
    doppler_freq = 2.0 * velocity_ms / wavelength  # [K]
    m = jnp.arange(num_pulses, dtype=real_dtype)
    dop = jnp.exp(1j * (2.0 * jnp.pi * prt)
                  * doppler_freq[:, None].astype(real_dtype) * m[None, :]
                  ).astype(dtype)  # [K,P]

    # channel steering phasors
    el = jnp.deg2rad(elevation_deg)  # [K]
    dphi = (2.0 * jnp.pi * element_spacing * jnp.sin(el) / wavelength)
    n = jnp.arange(num_channels, dtype=real_dtype)
    steer = jnp.exp(1j * dphi[:, None].astype(real_dtype) * n[None, :]
                    ).astype(dtype)  # [K,C]

    dop_amp = dop * amp[:, None].astype(dtype)
    return dop_amp, base, steer


@partial(jax.jit, static_argnames=("num_pulses", "num_channels",
                                   "element_spacing", "wavelength", "prt",
                                   "fs", "c", "dtype", "nfft"))
def _synthesize(range_m, velocity_ms, elevation_deg, amp, tx_pulse,
                num_pulses: int, num_channels: int, element_spacing: float,
                wavelength: float, prt: float, fs: float, c: float, dtype,
                nfft: int):
    dop_amp, base, steer = _target_factors(
        range_m, velocity_ms, elevation_deg, amp, tx_pulse, num_pulses,
        num_channels, element_spacing, wavelength, prt, fs, c, dtype, nfft)
    return jnp.einsum("kp,ks,kc->psc", dop_amp, base, steer,
                      precision=_HIGHEST, preferred_element_type=dtype)


@partial(jax.jit, static_argnames=("num_pulses", "num_channels",
                                   "element_spacing", "wavelength", "prt",
                                   "fs", "c", "dtype", "nfft"))
def _synthesize_beams(range_m, velocity_ms, elevation_deg, amp, tx_pulse,
                      mix, num_pulses: int, num_channels: int,
                      element_spacing: float, wavelength: float, prt: float,
                      fs: float, c: float, dtype, nfft: int):
    """Fused synthesis + DBF: contracts the channel axis with ``mix`` [C,B]
    per target (a [K,C]x[C,B] matmul) BEFORE the big outer product, so the
    [pulses, samples, channels] raw cube never exists:

      beams[p,s,b] = sum_k dop_amp[k,p] * base[k,s] * (steer[k,:] @ mix)[b]

    Algebraically identical to einsum('kp,ks,kc->psc') followed by
    einsum('psc,cb->psb') — the DBF of fun_process_single_frame.m:90-97
    applied to the noise-free echo of :45-77 — but with K*P*S*B MACs instead
    of K*P*S*C + P*S*C*B and no HBM round trip of the raw cube."""
    dop_amp, base, steer = _target_factors(
        range_m, velocity_ms, elevation_deg, amp, tx_pulse, num_pulses,
        num_channels, element_spacing, wavelength, prt, fs, c, dtype, nfft)
    steer_b = jnp.matmul(steer, mix.astype(dtype),
                         precision=_HIGHEST)  # [K,B]
    return jnp.einsum("kp,ks,kb->psb", dop_amp, base, steer_b,
                      precision=_HIGHEST, preferred_element_type=dtype)


def _synth_args(targets, precomp, cfg: RadarConfig, dtype, amplitudes):
    sig = cfg.sig
    tx = jnp.asarray(precomp.tx_pulse, dtype)
    # smallest power of 2 covering S + tx support: linear-shift FFT grid
    import numpy as _np

    support = int(_np.max(_np.nonzero(_np.abs(
        _np.asarray(precomp.tx_pulse)) > 0)[0])) + 1
    nfft = 1
    while nfft < sig.point_prt + support:
        nfft *= 2
    if amplitudes is None:
        snr_lin = 10.0 ** (jnp.asarray(targets.snr_db) / 10.0)
        amplitudes = jnp.sqrt(snr_lin * P_NOISE_FLOOR
                              / precomp.p_signal_unscaled)
    pos = (jnp.asarray(targets.range_m), jnp.asarray(targets.velocity_ms),
           jnp.asarray(targets.elevation_deg), jnp.asarray(amplitudes), tx)
    kw = dict(num_pulses=sig.prt_num, num_channels=sig.channel_num,
              element_spacing=cfg.array.element_spacing,
              wavelength=sig.wavelength, prt=sig.prt, fs=sig.fs, c=sig.c,
              dtype=dtype, nfft=nfft)
    return pos, kw


def synthesize_echoes(targets, precomp, cfg: RadarConfig,
                      dtype=jnp.complex64, amplitudes=None):
    """Raw IQ cube [prt_num, point_prt, channel_num] for one frame.

    ``amplitudes`` overrides the default SNR-referenced amplitude model
    (amp = sqrt(SNR_lin*P_noise/P_signal_unscaled), ref :61-63) with
    explicit per-target amplitudes — e.g. radar_equation_amplitude (v1
    model) or ones (v4 model)."""
    pos, kw = _synth_args(targets, precomp, cfg, dtype, amplitudes)
    return _synthesize(*pos, **kw)


def synthesize_echo_beams(targets, precomp, cfg: RadarConfig, mix,
                          dtype=jnp.complex64, amplitudes=None):
    """Noise-free beam cube [prt_num, point_prt, beams]: synthesis and DBF
    fused so the raw channel cube never materializes. ``mix`` is the [C,B]
    effective weight matrix (ops.dbf.dbf_weights_effective(w, variant).T);
    bit-equivalent (up to float reassociation) to
    ``dbf(synthesize_echoes(...), w, variant)``."""
    pos, kw = _synth_args(targets, precomp, cfg, dtype, amplitudes)
    return _synthesize_beams(*pos, jnp.asarray(mix), **kw)


@partial(jax.jit, static_argnames=("num_pulses", "num_channels",
                                   "element_spacing", "wavelength", "prt",
                                   "fs", "c", "dtype", "nfft"))
def _factors_beams(range_m, velocity_ms, elevation_deg, amp, tx_pulse,
                   mix, num_pulses: int, num_channels: int,
                   element_spacing: float, wavelength: float, prt: float,
                   fs: float, c: float, dtype, nfft: int):
    dop_amp, base, steer = _target_factors(
        range_m, velocity_ms, elevation_deg, amp, tx_pulse, num_pulses,
        num_channels, element_spacing, wavelength, prt, fs, c, dtype, nfft)
    return dop_amp, base, jnp.matmul(steer, mix.astype(dtype),
                                     precision=_HIGHEST)


def synthesize_factors(targets, precomp, cfg: RadarConfig, mix,
                       dtype=jnp.complex64, amplitudes=None):
    """Rank-K factorization of the noise-free beam cube:
    ``(dop_amp [K,P], base [K,S], steer_b [K,B])`` with
    ``beams[p,s,b] = sum_k dop_amp[k,p]*base[k,s]*steer_b[k,b]``.

    Because pulse compression acts on fast time only, MTD on slow time only
    and DBF on channels only, the ENTIRE deterministic pipeline through the
    RDM stays rank-K: apply the PC operator to ``base`` rows, the MTD matrix
    to ``dop_amp`` rows, and recombine with one tiny outer-product einsum —
    the full-size deterministic cubes never exist (pipeline/frame.py
    lowrank path)."""
    pos, kw = _synth_args(targets, precomp, cfg, dtype, amplitudes)
    return _factors_beams(*pos, jnp.asarray(mix), **kw)


def beam_noise_factor(dbf_w_effective, p_noise: float = P_NOISE_FLOOR):
    """Host-side Cholesky factor L [B,B] (numpy) such that ``z @ L.T`` with
    z iid CN(0,1) has exactly the distribution of per-channel AWGN passed
    through DBF.

    The reference draws iid complex noise per channel with per-rail variance
    p_noise/2 (fun_process_single_frame.m:81-88) and beamforms it; the beam-
    space noise is then circular complex Gaussian with covariance
    ``p_noise * M @ M^H`` (M = effective weights [B,C]) and zero pseudo-
    covariance. Drawing it directly in beam space from the Cholesky factor of
    that covariance is distribution-identical (not stream-identical) and
    skips generating + beamforming the [P,S,C] channel-noise cube."""
    import numpy as _np

    m = _np.asarray(dbf_w_effective)
    cov = p_noise * (m @ m.conj().T)
    try:
        return _np.linalg.cholesky(cov)
    except _np.linalg.LinAlgError:
        # rank-deficient weight banks (synthetic configs): eigh square root
        vals, vecs = _np.linalg.eigh(cov)
        return vecs * _np.sqrt(_np.clip(vals, 0.0, None))[None, :]


def _as_impl_key(key: jax.Array, impl: str) -> jax.Array:
    """Convert a (possibly raw uint32) threefry key to another PRNG family.

    ``rbg`` is XLA's RngBitGenerator. Distinct threefry keys map to
    distinct rbg keys (the 128-bit rbg key is the 64-bit threefry key
    doubled)."""
    if impl == "threefry":
        return key
    data = (jax.random.key_data(key)
            if jnp.issubdtype(key.dtype, jax.dtypes.prng_key) else key)
    return jax.random.wrap_key_data(jnp.tile(data.ravel()[:2], 2), impl=impl)


def white_complex_noise(key: jax.Array, shape, dtype=jnp.complex64,
                        impl: str = "threefry"):
    """iid CN(0,1) cube (unit complex variance) — the un-mixed beam noise of
    the lowrank path; the Cholesky mixing is applied post-MTD where the cube
    is 35% smaller (exact linear commutation)."""
    real_dtype = jnp.finfo(dtype).dtype
    g = jax.random.normal(_as_impl_key(key, impl), tuple(shape) + (2,),
                          dtype=real_dtype)
    return ((g[..., 0] + 1j * g[..., 1])
            * jnp.asarray(np.sqrt(0.5), real_dtype)).astype(dtype)


def add_noise_beamspace(key: jax.Array, beams: jax.Array,
                        l_factor) -> jax.Array:
    """Add beam-space AWGN with covariance ``L @ L^H`` (see
    beam_noise_factor): distribution-identical to
    ``dbf(add_noise(key, raw) - raw, w) + beams``."""
    dtype = beams.dtype
    real_dtype = jnp.finfo(dtype).dtype
    g = jax.random.normal(key, beams.shape + (2,), dtype=real_dtype)
    z = (g[..., 0] + 1j * g[..., 1]) * jnp.asarray(
        np.sqrt(0.5), real_dtype)  # iid CN(0,1) per (p,s,b)
    return beams + jnp.einsum("psj,bj->psb", z.astype(dtype),
                              jnp.asarray(l_factor).astype(dtype),
                              precision=_HIGHEST,
                              preferred_element_type=dtype)


def add_noise(key: jax.Array, raw_iq: jax.Array,
              p_noise: float = P_NOISE_FLOOR) -> jax.Array:
    """Independent complex AWGN on every (pulse, sample, channel) cell,
    sqrt(p_noise/2) per rail (fun_process_single_frame.m:81-88)."""
    dtype = raw_iq.dtype
    real_dtype = jnp.finfo(dtype).dtype
    shape = raw_iq.shape + (2,)
    g = jax.random.normal(key, shape, dtype=real_dtype)
    noise = (g[..., 0] + 1j * g[..., 1]) * jnp.sqrt(
        jnp.asarray(p_noise / 2.0, real_dtype))
    return raw_iq + noise.astype(dtype)
