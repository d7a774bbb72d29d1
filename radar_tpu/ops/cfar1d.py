"""Real-data-style segmented 1D CA-GO/SO CFAR (SURVEY.md section 2.1
"CFAR detector (real-data style)").

Reconstructed from the inline copies in the reference's debug harness (the
adapter scripts call functions missing from the repo, SURVEY.md section 2.4):

  - ``local_execute_cfar`` (debug_simulated_data_processing_v2.m:419-440):
    split the 3404 range gates back into the three pulse segments
    [228 | 723 | 2453] and CFAR each independently.
  - ``executeCFAR_2D`` (:442-462): mask a zero-velocity clutter band of
    +/- MTD_0v_num Doppler rows around the (1-based) center row
    round(V/2)+1; masked rows never detect.
  - ``Function_CFAR1D_sub`` (:467-511): per range column, mean over
    ``ref`` cells beyond ``guard`` ("save") cells on each side; when a side's
    window runs off the segment edge, reuse the other side's window
    (edge fallback); combine GO (max, method 0) or SO (min); detect on
    ``x >= T * noise`` (>=, unlike the sim path's >).

Array formulation: the per-column loop becomes statically-unrolled shifted
adds per segment + where-selects for the edge fallback — one fused
elementwise program over the whole [V, G, pairs] cube.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config.params import Cfar1DParams
from .cfar import _shifted


def _segment_noise_1d(x: jnp.ndarray, guard: int, ref: int, method: str,
                      axis: int = 1) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Edge-fallback 1D CFAR noise estimate along ``axis`` plus the
    interior mask (True where BOTH windows are fully in range, i.e. no
    fallback happened). Exposed for Pfa calibration
    (ops/cfar_analysis.py)."""
    lead = jnp.zeros_like(x)
    trail = jnp.zeros_like(x)
    for k in range(guard + 1, guard + ref + 1):
        lead = lead + _shifted(x, k, axis)
        trail = trail + _shifted(x, -k, axis)
    lead = lead / ref
    trail = trail / ref

    n = x.shape[axis]
    idx = jnp.arange(n)
    left_ok = idx >= guard + ref          # full left window in range
    right_ok = idx < n - guard - ref      # full right window in range
    shape = [1] * x.ndim
    shape[axis] = n
    left_ok = left_ok.reshape(shape)
    right_ok = right_ok.reshape(shape)

    # edge fallback: a side whose window is clipped borrows the other side
    ref_l = jnp.where(left_ok, lead, trail)
    ref_r = jnp.where(right_ok, trail, lead)
    if method == "GO":
        noise = jnp.maximum(ref_l, ref_r)
    elif method == "SO":
        noise = jnp.minimum(ref_l, ref_r)
    elif method == "CA":
        noise = 0.5 * (ref_l + ref_r)
    else:
        raise ValueError(f"unknown 1D CFAR method: {method}")
    return noise, jnp.broadcast_to(left_ok & right_ok, x.shape)


def _segment_cfar_1d(x: jnp.ndarray, guard: int, ref: int, t_cfar: float,
                     method: str, axis: int = 1) -> tuple[jnp.ndarray,
                                                          jnp.ndarray]:
    """1D CFAR along ``axis`` of one segment; returns (flags, threshold)."""
    noise, _ = _segment_noise_1d(x, guard, ref, method, axis)
    threshold = t_cfar * noise
    return x >= threshold, threshold


def zero_velocity_mask(num_v: int, num_suppress: int) -> jnp.ndarray:
    """Boolean [V]: True where detection is allowed. Clutter band =
    +/- num_suppress rows around the 1-based center round(V/2)+1
    (executeCFAR_2D, ref :448-452)."""
    # 0-based equivalent of MATLAB's 1-based round(V/2)+1. MATLAB round()
    # is half-AWAY-from-zero; Python round() is banker's (half-to-even),
    # which disagrees for odd V with even floor(V/2) (e.g. V=333:
    # MATLAB 167 vs Python 166) — (V+1)//2 reproduces the MATLAB value
    # for every V (self-review round 5; latent at the shipped even
    # prt_num=332).
    center = (num_v + 1) // 2
    idx = jnp.arange(num_v)
    return ~((idx >= center - num_suppress) & (idx <= center + num_suppress))


def segmented_cfar_1d(maps: jnp.ndarray, params: Cfar1DParams,
                      gate_splits: tuple, delta_v_bin: float,
                      threshold_factor=None
                      ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full real-data CFAR on [V, G(, pairs)] amplitude maps.

    ``delta_v_bin``: velocity per Doppler bin (wavelength*prf/(2*prtNum)),
    used to size the clutter band: MTD_0v_num = floor(MTD_V/deltaV)
    (main_test_with_simulated_data.m:120-123).
    Returns (flags bool, threshold) of the same shape; clutter-band rows are
    always False with zero threshold.

    ``threshold_factor``: optional override of ``params.threshold_factor``;
    may be a TRACED scalar (the threshold enters the compare linearly), so
    an operating-curve sweep compiles once (scripts/run_roc_realdata.py).
    """
    num_v = maps.shape[0]
    n0v = int(params.mtd_zero_vel_ms / delta_v_bin)
    vmask = zero_velocity_mask(num_v, n0v)
    vshape = [1] * maps.ndim
    vshape[0] = num_v
    vmask_b = vmask.reshape(vshape)

    t_cfar = (params.threshold_factor if threshold_factor is None
              else threshold_factor)
    flags = []
    thresholds = []
    start = 0
    for width in gate_splits:
        seg = maps[:, start:start + width]
        f, t = _segment_cfar_1d(seg, params.guard_cells, params.ref_cells,
                                t_cfar, params.method,
                                axis=1)
        flags.append(f)
        thresholds.append(t)
        start += width
    flags = jnp.concatenate(flags, axis=1) & vmask_b
    thresholds = jnp.concatenate(thresholds, axis=1) * vmask_b
    return flags, thresholds
