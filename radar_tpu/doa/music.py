"""MUSIC super-resolution DoA (SURVEY.md section 2.2: MUSIC_1D.m,
MUSIC_2D.m, run_music_algorithm.m).

Array formulation: covariance as one (optionally snapshot-sharded, see
parallel/collectives.covariance_snapshot_sharded) X@X^H matmul,
``jnp.linalg.eigh`` for the subspace split, and the spectrum scan as a single
[grid, C] x [C, C-M] matmul instead of the reference's per-angle loop
(run_music_algorithm.m:60-70) — scales to 128 elements (BASELINE.json
config 4).

Reference models covered:
  - 1D ULA (MUSIC_1D.m:20-48: 10-element lambda/2 array, eig -> noise
    subspace, spectrum 1/sum|Qn^H a|^2, peak picking)
  - radar geometry (run_music_algorithm.m:7-70: 16 channels, d=13.8 mm,
    fc=9.45 GHz, 256 snapshots, conventional-DBF comparison)
  - 2D URA (MUSIC_2D.m:32-93: steering exp(jk(x cos(el)cos(az) +
    y cos(el)sin(az))), vectorized grid spectrum, regional-max picking)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class MusicResult(NamedTuple):
    scan_deg: np.ndarray        # [G] (1D) or tuple of axes (2D)
    spectrum: jnp.ndarray       # [G] or [G_az, G_el]
    peaks_deg: np.ndarray       # [M] estimated DoAs — 1D path: ascending
    #                             angle; 2D pickers: descending power


def covariance(x: jnp.ndarray) -> jnp.ndarray:
    """Sample covariance X@X^H/K for X [C, K] (run_music_algorithm.m:45)."""
    return x @ jnp.conj(x.T) / x.shape[1]


def noise_subspace(r: jnp.ndarray, num_sources: int) -> jnp.ndarray:
    """[C, C-M] noise-subspace basis from the covariance (ascending-eigh:
    the first C-M columns span the noise subspace; reference sorts
    descending and drops the first M, run_music_algorithm.m:48-57)."""
    _, vecs = jnp.linalg.eigh(r)
    return vecs[:, : r.shape[0] - num_sources]


def music_spectrum_1d(r: jnp.ndarray, num_sources: int,
                      scan_deg: np.ndarray, element_spacing: float,
                      wavelength: float) -> jnp.ndarray:
    """P(theta) = 1 / ||En^H a(theta)||^2 over the scan grid, one matmul."""
    en = noise_subspace(r, num_sources)
    c = r.shape[0]
    n = np.arange(c)[:, None]
    phase = (2.0 * np.pi * element_spacing / wavelength
             * np.sin(np.deg2rad(np.asarray(scan_deg)))[None, :])
    a = jnp.asarray(np.exp(1j * n * phase), r.dtype)  # [C, G]
    proj = jnp.conj(en.T) @ a                         # [C-M, G]
    denom = jnp.sum(jnp.abs(proj) ** 2, axis=0)
    return 1.0 / (denom + jnp.finfo(denom.dtype).eps)


def find_peaks_1d(scan_deg: np.ndarray, spectrum: np.ndarray,
                  num_sources: int) -> np.ndarray:
    """Top-M local maxima by height (MUSIC_1D.m findpeaks idiom),
    returned in ASCENDING ANGLE order. NB: like MATLAB findpeaks, may
    return FEWER than ``num_sources`` angles when the spectrum has fewer
    strict local maxima (e.g. two sources merged into one lobe) —
    callers indexing a fixed count should check ``len()``; the
    search-free estimators (doa/superres.py) resolve such pairs."""
    s = np.asarray(spectrum)
    interior = (s[1:-1] > s[:-2]) & (s[1:-1] > s[2:])
    idx = np.nonzero(interior)[0] + 1
    if len(idx) == 0:
        idx = np.array([int(np.argmax(s))])
    order = np.argsort(s[idx])[::-1][:num_sources]
    return np.sort(np.asarray(scan_deg)[idx[order]])


def music_1d(x: jnp.ndarray, num_sources: int, element_spacing: float,
             wavelength: float, scan_deg: np.ndarray | None = None
             ) -> MusicResult:
    """Full 1D MUSIC from snapshots X [C, K]."""
    if scan_deg is None:
        scan_deg = np.arange(-90.0, 90.0 + 1e-9, 0.1)
    r = covariance(x)
    spec = music_spectrum_1d(r, num_sources, scan_deg, element_spacing,
                             wavelength)
    peaks = find_peaks_1d(scan_deg, np.asarray(spec), num_sources)
    return MusicResult(np.asarray(scan_deg), spec, peaks)


def conventional_beam_spectrum(x: jnp.ndarray, scan_deg: np.ndarray,
                               element_spacing: float,
                               wavelength: float) -> jnp.ndarray:
    """Hamming-weighted conventional DBF power spectrum for comparison
    (run_music_algorithm.m:80-85)."""
    c = x.shape[0]
    r = covariance(x)
    n = np.arange(c)[:, None]
    phase = (2.0 * np.pi * element_spacing / wavelength
             * np.sin(np.deg2rad(np.asarray(scan_deg)))[None, :])
    a = np.exp(1j * n * phase) * np.hamming(c)[:, None]
    a = jnp.asarray(a, r.dtype)
    return jnp.real(jnp.sum(jnp.conj(a) * (r @ a), axis=0))


def steering_ura(az_deg, el_deg, nx: int, ny: int, spacing_wavelengths: float
                 ) -> np.ndarray:
    """2D URA steering vectors [nx*ny, G_az*G_el] on the MUSIC_2D.m model:
    phase = 2*pi*d/lambda * (x*cos(el)cos(az) + y*cos(el)sin(az))."""
    az = np.deg2rad(np.atleast_1d(az_deg))[None, :, None]
    el = np.deg2rad(np.atleast_1d(el_deg))[None, None, :]
    xi = np.arange(nx)
    yi = np.arange(ny)
    gx, gy = np.meshgrid(xi, yi, indexing="ij")
    pos = np.stack([gx.ravel(), gy.ravel()], axis=1)  # [C, 2]
    u = np.cos(el) * np.cos(az)   # [1, Gaz, Gel]
    v = np.cos(el) * np.sin(az)
    phase = (2.0 * np.pi * spacing_wavelengths
             * (pos[:, 0][:, None, None] * u + pos[:, 1][:, None, None] * v))
    c = pos.shape[0]
    return np.exp(1j * phase).reshape(c, -1)


def regional_max_peaks_2d(spec: jnp.ndarray, num_sources: int
                          ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """DEVICE-SIDE 8-neighborhood regional maxima + top-M selection.

    The 8-neighbor comparison is a stencil (eight statically-shifted
    ``jnp.maximum``s over an -inf-padded plane, elementwise) and the
    ranking one ``lax.top_k`` over the masked flat spectrum — no host
    transfer of the [G_az, G_el] plane, which matters at the fine-grid
    128-element scale (BASELINE.json config 4). Returns ``(flat_idx [M],
    values [M])`` descending; unravel on host. Matches MUSIC_2D.m:119-144's
    imregionalmax + sort semantics (>= every neighbor, ties broken by
    value order)."""
    h, w = spec.shape
    pad = jnp.pad(spec, 1, constant_values=-jnp.inf)
    neigh = jnp.full_like(spec, -jnp.inf)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            neigh = jnp.maximum(neigh, pad[1 + di:1 + di + h,
                                           1 + dj:1 + dj + w])
    masked = jnp.where(spec >= neigh, spec, -jnp.inf)
    vals, idx = jax.lax.top_k(masked.ravel(), num_sources)
    return idx, vals


def refine_peaks_zoom(en: jnp.ndarray, peaks_coarse: np.ndarray,
                      nx: int, ny: int, spacing_wavelengths: float,
                      daz: float, del_: float, factor: int = 20
                      ) -> np.ndarray:
    """Two-stage zoom refinement: around each coarse (az, el) peak,
    re-evaluate the MUSIC spectrum on a dense +-1-cell local grid
    (step = cell/``factor``) with the SAME noise subspace, and take its
    maximum — sub-grid accuracy to cell/factor without the fragility of
    parabola fits on a reciprocal-pole surface. One small
    [C-M, C] x [C, (2f+1)^2] matmul per peak (M is tiny), device-side."""
    out = []
    nloc = 2 * factor + 1
    for azc, elc in peaks_coarse:
        az_l = np.linspace(azc - daz, azc + daz, nloc)
        el_l = np.linspace(elc - del_, elc + del_, nloc)
        a_l = jnp.asarray(steering_ura(az_l, el_l, nx, ny,
                                       spacing_wavelengths), en.dtype)
        d = jnp.sum(jnp.abs(jnp.conj(en.T) @ a_l) ** 2, axis=0)
        k = int(jnp.argmin(d))          # min of the null spectrum
        out.append((az_l[k // nloc], el_l[k % nloc]))
    return np.asarray(out)


def music_2d(x: jnp.ndarray, num_sources: int, nx: int, ny: int,
             spacing_wavelengths: float = 0.5,
             az_deg: np.ndarray | None = None,
             el_deg: np.ndarray | None = None,
             peak_impl: str = "device", refine: bool = False,
             mesh=None, snapshot_axis: str = "cpi") -> MusicResult:
    """2D MUSIC over an (azimuth, elevation) grid; peaks by regional max
    (MUSIC_2D.m:119-144).

    Scales to the 128-element BASELINE-4 aperture: pass ``mesh=`` to
    accumulate the covariance via the snapshot-sharded psum path
    (parallel/collectives.covariance_snapshot_sharded — X's snapshot axis
    sharded over ``snapshot_axis``), and ``peak_impl="device"`` (default)
    ranks regional maxima on device (:func:`regional_max_peaks_2d`);
    ``"host"`` keeps the numpy picker (the original 8x8 formulation).
    ``refine=True`` (device picker only) adds two-stage zoom refinement
    (:func:`refine_peaks_zoom`: dense local re-evaluation at step/20
    around each coarse peak, same noise subspace) — beyond the
    reference's grid-quantized imregionalmax."""
    if az_deg is None:
        az_deg = np.arange(-90.0, 90.0 + 1e-9, 1.0)
    if el_deg is None:
        el_deg = np.arange(0.0, 90.0 + 1e-9, 1.0)
    if mesh is not None:
        from ..parallel.collectives import covariance_snapshot_sharded

        r = covariance_snapshot_sharded(mesh, snapshot_axis)(x)
    else:
        r = covariance(x)
    en = noise_subspace(r, num_sources)
    a = jnp.asarray(steering_ura(az_deg, el_deg, nx, ny,
                                 spacing_wavelengths), r.dtype)
    proj = jnp.conj(en.T) @ a
    denom = jnp.sum(jnp.abs(proj) ** 2, axis=0)
    spec = (1.0 / (denom + jnp.finfo(denom.dtype).eps)).reshape(
        len(az_deg), len(el_deg))

    if refine and peak_impl != "device":
        # refuse rather than silently returning grid-quantized peaks —
        # the caller asked for ~cell/20 accuracy and would get ~1 cell
        raise ValueError("refine=True is implemented on the device "
                         "picker only (peak_impl='device')")
    if peak_impl == "device":
        idx, vals = regional_max_peaks_2d(spec, num_sources)
        # fewer regional maxima than num_sources: the masked top_k fills
        # the tail with -inf entries pointing at arbitrary cells — drop
        # them (the host/reference imregionalmax picker also returns
        # fewer peaks there) instead of reporting fabricated corners
        keep = np.isfinite(np.asarray(vals))
        idx = np.asarray(idx)[keep]
        ii, jj = np.unravel_index(idx, spec.shape)
        az0, el0 = np.asarray(az_deg), np.asarray(el_deg)
        peaks = np.stack([az0[ii], el0[jj]], axis=1)
        if refine:
            daz = az0[1] - az0[0] if len(az0) > 1 else 1.0
            del_ = el0[1] - el0[0] if len(el0) > 1 else 1.0
            peaks = refine_peaks_zoom(en, peaks, nx, ny,
                                      spacing_wavelengths, daz, del_)
        return MusicResult((np.asarray(az_deg), np.asarray(el_deg)), spec,
                           peaks)

    s = np.asarray(spec)
    # 8-neighborhood regional maxima (host reference picker)
    pad = np.pad(s, 1, constant_values=-np.inf)
    is_max = np.ones_like(s, bool)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            is_max &= s >= pad[1 + di:1 + di + s.shape[0],
                               1 + dj:1 + dj + s.shape[1]]
    ii, jj = np.nonzero(is_max)
    order = np.argsort(s[ii, jj])[::-1][:num_sources]
    peaks = np.stack([np.asarray(az_deg)[ii[order]],
                      np.asarray(el_deg)[jj[order]]], axis=1)
    return MusicResult((np.asarray(az_deg), np.asarray(el_deg)), spec, peaks)


def simulate_snapshots(key, angles_deg, num_elements: int,
                       element_spacing: float, wavelength: float,
                       num_snapshots: int, snr_db: float = 10.0,
                       dtype=jnp.complex64) -> jnp.ndarray:
    """Random-signal ULA snapshot model X = A S + N
    (run_music_algorithm.m:24-39)."""
    from .steering import steering_vector

    a = jnp.asarray(steering_vector(np.asarray(angles_deg), num_elements,
                                    element_spacing, wavelength), dtype)
    m = len(np.atleast_1d(angles_deg))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    real_dtype = jnp.finfo(dtype).dtype
    s = (jax.random.normal(k1, (m, num_snapshots), real_dtype)
         + 1j * jax.random.normal(k2, (m, num_snapshots), real_dtype))
    s = s.astype(dtype) * jnp.sqrt(jnp.asarray(0.5, real_dtype))
    amp = 10.0 ** (snr_db / 20.0)
    n = (jax.random.normal(k3, (num_elements, num_snapshots), real_dtype)
         + 1j * jax.random.normal(k4, (num_elements, num_snapshots),
                                  real_dtype)) * jnp.sqrt(
        jnp.asarray(0.5, real_dtype))
    return amp * (a @ s) + n.astype(dtype)
