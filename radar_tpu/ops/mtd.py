"""MTD: slow-time Doppler FFT (SURVEY.md L4, component "MTD").

Reference (fun_process_single_frame.m:129-136): per beam, multiply the PC
cube by a kaiser(prt_num, 4.5) column window and take an fftshift'ed FFT over
slow time. The v7_7 variant zero-pads to a 512-point FFT
(main_simulate_echoes_with_array_v7_7.m:150,495-503); selected via
``fft_len``.

Here the whole [pulses, gates, beams] cube is windowed and FFT'd along axis 0
in one call. ``mtd_matmul`` is the default formulation: the window, the DFT
and the fftshift folded into one constant [n_dop, pulses] matrix.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def mtd(pc: jnp.ndarray, mtd_win: jnp.ndarray,
        fft_len: int | None = None) -> jnp.ndarray:
    """[pulses, gates, beams] -> [fft_len or pulses, gates, beams] RDM."""
    w = mtd_win.astype(pc.dtype)
    x = pc * w[:, None, None]
    y = jnp.fft.fft(x, n=fft_len, axis=0)
    return jnp.fft.fftshift(y, axes=0)


def make_mtd_matrix(mtd_win, num_pulses: int,
                    fft_len: int | None = None) -> "np.ndarray":
    """Constant [n_dop, pulses] matrix M with the kaiser window, the
    slow-time DFT and the fftshift row reordering folded in:
    ``rdm = einsum('vp,pgb->vgb', M, pc)`` == ``mtd(pc, win, fft_len)``.

    One matmul against a host-precomputed constant instead of an FFT."""
    import numpy as np

    n = fft_len or num_pulses
    p = np.arange(num_pulses)
    v = np.arange(n)
    dft = np.exp(-2j * np.pi * np.outer(v, p) / n)         # [n, P]
    m = dft * np.asarray(mtd_win)[None, :]
    return np.fft.fftshift(m, axes=0).astype(np.complex128)


def mtd_matmul(pc: jnp.ndarray, mtd_matrix,
               precision: str = "f32") -> jnp.ndarray:
    """MTD via the folded constant matrix (see make_mtd_matrix)."""
    if precision == "bf16":
        from .precision import einsum_complex_bf16

        return einsum_complex_bf16("vp,pgb->vgb", jnp.asarray(mtd_matrix),
                                   pc, out_dtype=pc.dtype)
    m = jnp.asarray(mtd_matrix, pc.dtype)
    return jnp.einsum("vp,pgb->vgb", m, pc, precision=lax.Precision.HIGHEST,
                      preferred_element_type=pc.dtype)


def zero_velocity_suppress(rdm: jnp.ndarray, velocity_axis: jnp.ndarray,
                           v_half_width_ms: float) -> jnp.ndarray:
    """Zero out Doppler bins within +/- v_half_width_ms of zero velocity —
    the real-data path's DC clutter suppression (``fun_0v_pressing``,
    inline copy at debug_simulated_data_processing_v2.m:259-405; half-width
    from ``config.mtd.MTD_V=3 m/s``)."""
    mask = jnp.abs(velocity_axis) <= v_half_width_ms
    return jnp.where(mask[:, None, None], 0.0, rdm)
