"""Per-detection parameter estimation: spline peak refinement + amplitude
monopulse (SURVEY.md L5, component "Parameter estimation").

Reference (fun_process_single_frame.m:226-299): for each CFAR detection,

  - range: take the +/-extraDots(=2) cell stencil of the pair-sum RDM row,
    upsample 8x with MATLAB 'spline' (not-a-knot cubic) interpolation, find
    the peak; refined range = range_axis[r_idx] + (peak_offset)*deltaR
  - velocity: same with a 4x upsample along Doppler
  - angle: amplitude monopulse on the two member beams *at the integer
    indices* (a documented reference flaw kept for parity, ref :280-283):
    ratio = (S_A - S_B)/(S_A + S_B + eps),
    est = (angle_A + angle_B)/2 + K_pair * real(ratio).
    The v7.6 variant uses the complex RDM values instead of magnitudes
    (main_plot_snr_vs_angle_error.m:455-458) — ``monopulse_complex=True``.

Array formulation: spline interpolation is linear in the data, so the
whole upsample collapses to one small precomputed matrix (utils.signal.
spline_upsample_matrix) applied to all detections' stencils at once — two
[cap, 5] x [5, Q] matmuls and an argmax replace the reference's per-detection
interp1 calls. Everything is fixed-shape and mask-carried.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ..ops.cfar import Detections

_HIGHEST = lax.Precision.HIGHEST  # full f32 (no TF32) on the GPU


class ParamDetections(NamedTuple):
    """Refined measurements per detection slot (ref
    ``parameterized_detections`` struct array)."""

    range_m: jnp.ndarray
    velocity_ms: jnp.ndarray
    angle_deg: jnp.ndarray
    power: jnp.ndarray
    pair_idx: jnp.ndarray
    valid: jnp.ndarray


def _stencil_gather(maps: jnp.ndarray, v_idx, r_idx, pair_idx, extra: int,
                    axis: str) -> jnp.ndarray:
    """Gather the +/-extra cell stencil along range ('r') or Doppler ('v')
    of the [V, G, pairs] pair-sum cube -> [cap, 2*extra+1].

    Edge handling: range stencils CLIP to the map edge, Doppler stencils
    WRAP (the fftshifted Doppler axis is circular — row 0's true
    neighbor is row V-1). On the sim path both are no-ops: the 2D CFAR's
    border exclusion keeps every detection ref+guard >= extra cells from
    any edge. On the real-data path (1D CFAR with edge FALLBACK, no
    border exclusion) edge detections do occur: the wrap gives the
    physically-correct Doppler stencil, while a range stencil clipped at
    a segment edge carries a documented up-to-~1-cell refinement bias
    (the reference's own interp1 behaves no better there)."""
    offs = jnp.arange(-extra, extra + 1)
    if axis == "r":
        cells = jnp.clip(r_idx[:, None] + offs[None, :], 0,
                         maps.shape[1] - 1)
        return maps[v_idx[:, None], cells, pair_idx[:, None]]
    cells = jnp.mod(v_idx[:, None] + offs[None, :], maps.shape[0])
    return maps[cells, r_idx[:, None], pair_idx[:, None]]


def _stencil_gather_rdm(rdm: jnp.ndarray, v_idx, r_idx, pair_idx,
                        extra: int, axis: str) -> jnp.ndarray:
    """Pair-sum stencil gathered pointwise from the complex [V, G, beams]
    RDM: |rdm[.., p]| + |rdm[.., p+1]| at the same cells
    :func:`_stencil_gather` would read from the materialized maps — the
    identical values (cfg.tail_from_rdm keeps the full pair-sum cube out
    of the tail entirely)."""
    offs = jnp.arange(-extra, extra + 1)
    if axis == "r":
        cells = jnp.clip(r_idx[:, None] + offs[None, :], 0,
                         rdm.shape[1] - 1)
        a = rdm[v_idx[:, None], cells, pair_idx[:, None]]
        b = rdm[v_idx[:, None], cells, pair_idx[:, None] + 1]
    else:
        cells = jnp.mod(v_idx[:, None] + offs[None, :], rdm.shape[0])
        a = rdm[cells, r_idx[:, None], pair_idx[:, None]]
        b = rdm[cells, r_idx[:, None], pair_idx[:, None] + 1]
    return jnp.abs(a) + jnp.abs(b)


def _spline_peak_offset(stencil: jnp.ndarray, q: jnp.ndarray,
                        times: int, extra: int):
    """Peak offset (in cells, in [-extra, +extra]) of the spline-upsampled
    stencil, plus the integer index of that peak on the upsampled grid
    (consumed by the refined-index monopulse). q is the
    [(2*extra)*times+1, 2*extra+1] upsample matrix."""
    up = jnp.matmul(stencil, q.T, precision=_HIGHEST)  # [cap, Q]
    i = jnp.argmax(up, axis=1)
    return i.astype(stencil.dtype) / times - extra, i


def _stencil_gather_2d(rdm: jnp.ndarray, beam, v_idx, r_idx,
                       extra: int) -> jnp.ndarray:
    """[cap, 2e+1 (v), 2e+1 (r)] stencil of one beam's complex RDM around
    each detection (range clipped / Doppler wrapped like the 1D
    gathers)."""
    offs = jnp.arange(-extra, extra + 1)
    vc = jnp.mod(v_idx[:, None] + offs[None, :], rdm.shape[0])
    rc = jnp.clip(r_idx[:, None] + offs[None, :], 0, rdm.shape[1] - 1)
    return rdm[vc[:, :, None], rc[:, None, :], beam[:, None, None]]


def _value_at_refined(st2: jnp.ndarray, q_r: jnp.ndarray, q_v: jnp.ndarray,
                      i_r: jnp.ndarray, i_v: jnp.ndarray) -> jnp.ndarray:
    """Evaluate the separable-spline surface of a [cap, 5v, 5r] stencil at
    the refined upsampled-grid indices (i_v, i_r) found on the SUM map —
    the same not-a-knot cubic the range/velocity refinement uses, applied
    to each beam (spline interpolation is linear in the data, so the 2D
    evaluation is two small matmuls + gathers)."""
    cap = st2.shape[0]
    rows = jnp.einsum("cvr,qr->cvq", st2, q_r,
                      precision=_HIGHEST)             # upsample along r
    at_r = rows[jnp.arange(cap)[:, None],
                jnp.arange(st2.shape[1])[None, :], i_r[:, None]]  # [cap, 5v]
    cols = jnp.matmul(at_r, q_v.T, precision=_HIGHEST)  # upsample along v
    return cols[jnp.arange(cap), i_v]


def estimate_parameters(dets: Detections, pair_maps: jnp.ndarray,
                        rdm: jnp.ndarray, precomp_dev,
                        extra_dots: int, r_times: int, v_times: int,
                        monopulse_complex: bool = False,
                        monopulse_refined: bool = False) -> ParamDetections:
    """dets: CFAR output; pair_maps: [V,G,pairs] real sum maps, or None to
    gather the stencils from the RDM (cfg.tail_from_rdm); rdm: [V,G,beams]
    complex; precomp_dev: DevicePrecomputed arrays."""
    from_rdm = pair_maps is None
    # consts may arrive as host numpy (embedded as XLA constants at trace
    # time); coerce so tracer-indexed gathers work
    rx = jnp.asarray(precomp_dev.range_axis)
    vx = jnp.asarray(precomp_dev.velocity_axis)
    k_lut = jnp.asarray(precomp_dev.k_slopes_lut)
    ang = jnp.asarray(precomp_dev.beam_angles_deg)
    # estimates are computed at >= f32 even when the bulk maps arrive in a
    # storage dtype like bf16 (the gathered stencils are only [cap, 5] —
    # upcasting them is free; doing the spline/ratio math in bf16 would
    # quantize range to ~16 m steps)
    real_dtype = jnp.promote_types(
        jnp.float32 if from_rdm else pair_maps.dtype, jnp.float32)

    def gather(axis):
        if from_rdm:
            return _stencil_gather_rdm(rdm, dets.v_idx, dets.r_idx,
                                       dets.pair_idx, extra_dots, axis)
        return _stencil_gather(pair_maps, dets.v_idx, dets.r_idx,
                               dets.pair_idx, extra_dots, axis)

    q_r = jnp.asarray(precomp_dev.q_range, real_dtype)
    q_v = jnp.asarray(precomp_dev.q_vel, real_dtype)
    st_r = gather("r").astype(real_dtype)
    off_r, i_r = _spline_peak_offset(st_r, q_r, r_times, extra_dots)
    est_range = rx[dets.r_idx] + off_r * precomp_dev.delta_r

    st_v = gather("v").astype(real_dtype)
    off_v, i_v = _spline_peak_offset(st_v, q_v, v_times, extra_dots)
    est_vel = vx[dets.v_idx] + off_v * precomp_dev.delta_v

    if monopulse_refined:
        # monopulse at the spline-REFINED subcell position: each member
        # beam's surface interpolated (separably, same not-a-knot cubic)
        # at the sum-map peak found above — the flaw-fixed variant
        # (cfg.monopulse_refined; SURVEY 7.1 "optionally at refined
        # indices"; A/B delta in git show
        # dc6ffd7:results/monopulse_refined_ab.json)
        st_a = _stencil_gather_2d(rdm, dets.pair_idx, dets.v_idx,
                                  dets.r_idx, extra_dots)
        st_b = _stencil_gather_2d(rdm, dets.pair_idx + 1, dets.v_idx,
                                  dets.r_idx, extra_dots)
        if not monopulse_complex:
            st_a, st_b = jnp.abs(st_a), jnp.abs(st_b)
        st_a = st_a.astype(real_dtype if not monopulse_complex
                           else st_a.dtype)
        st_b = st_b.astype(st_a.dtype)
        s_a = _value_at_refined(st_a, q_r.astype(st_a.dtype),
                                q_v.astype(st_a.dtype), i_r, i_v)
        s_b = _value_at_refined(st_b, q_r.astype(st_b.dtype),
                                q_v.astype(st_b.dtype), i_r, i_v)
    else:
        # monopulse at integer indices (reference flaw preserved)
        s_a = rdm[dets.v_idx, dets.r_idx, dets.pair_idx]
        s_b = rdm[dets.v_idx, dets.r_idx, dets.pair_idx + 1]
        if not monopulse_complex:
            s_a, s_b = jnp.abs(s_a), jnp.abs(s_b)
    eps = jnp.finfo(real_dtype).eps
    ratio = (s_a - s_b) / (s_a + s_b + eps)
    k = k_lut[dets.pair_idx]
    mid = 0.5 * (ang[dets.pair_idx] + ang[dets.pair_idx + 1])
    est_angle = mid + k * jnp.real(ratio)

    zero = jnp.zeros((), real_dtype)
    w = lambda x: jnp.where(dets.valid, x.astype(real_dtype), zero)
    return ParamDetections(
        range_m=w(est_range), velocity_ms=w(est_vel), angle_deg=w(est_angle),
        power=w(dets.amp), pair_idx=dets.pair_idx, valid=dets.valid)
