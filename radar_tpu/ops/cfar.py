"""2D GOCA-CFAR on adjacent-beam sum RDMs (SURVEY.md L5, component "CFAR
detector (sim path)").

Reference (fun_process_single_frame.m:172-223): for each of the beam_num-1
adjacent beam pairs, the detection map is |RDM_A| + |RDM_B|; a cross-shaped
two-dimensional greatest-of cell-averaging detector estimates noise as

  noise_R = max(mean(leading ref_R cells), mean(trailing ref_R cells))   (range)
  noise_V = max(mean(leading ref_V cells), mean(trailing ref_V cells))   (Doppler)
  noise   = max(noise_R, noise_V);   threshold = T_CFAR * noise

with guard_R/guard_V guard cells, and border cells (closer than ref+guard to
any edge) never tested.

Array formulation: the reference's per-cell window loops are O(window)
shift-and-add reductions over the whole cube — every cell's leading/trailing
window mean is computed with ``ref`` statically-unrolled shifted adds (exact
fp-order-stable, unlike a cumsum-difference formulation), so the entire
detector is elementwise work with no data-dependent control flow.

Detections leave the device as a fixed-capacity index list
(``extract_detections``) ordered (pair, range, velocity)-major — the same
order MATLAB's column-major ``find`` produces per pair (ref :215-221).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config.params import CfarParams


def _shifted(x: jnp.ndarray, k: int, axis: int) -> jnp.ndarray:
    """x[i - k] along ``axis`` with zero fill (static shift)."""
    n = x.shape[axis]
    if k == 0:
        return x
    pad = [(0, 0)] * x.ndim
    if k > 0:
        pad[axis] = (k, 0)
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, n)
    else:
        pad[axis] = (0, -k)
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(-k, n - k)
    return jnp.pad(x, pad)[tuple(sl)]


def lead_trail_means(x: jnp.ndarray, guard: int, ref: int,
                     axis: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Mean over the ``ref`` cells before/after the guard band, per cell.

    lead[i]  = mean(x[i-guard-ref : i-guard])
    trail[i] = mean(x[i+guard+1 : i+guard+ref+1])
    Border positions see zero-filled cells; callers mask them out.
    """
    lead = jnp.zeros_like(x)
    trail = jnp.zeros_like(x)
    for k in range(guard + 1, guard + ref + 1):
        lead = lead + _shifted(x, k, axis)
        trail = trail + _shifted(x, -k, axis)
    return lead / ref, trail / ref


def _banded_means_matrix(guard: int, ref: int, tile: int) -> "np.ndarray":
    """[tile + 2*halo, 2*tile] banded stencil: columns 0..tile-1 produce the
    lead window means, tile..2*tile-1 the trail means, for one ``tile``-wide
    output block whose input window carries ``halo = guard + ref`` extra
    cells on each side."""
    halo = guard + ref
    # f64 master copy; cast to the map dtype at use (so the f64 parity
    # tests see full precision and the f32 pipeline sees f32 constants)
    w = np.zeros((tile + 2 * halo, 2 * tile), np.float64)
    inv = 1.0 / ref
    for j in range(tile):
        for k in range(guard + 1, guard + ref + 1):
            w[j + halo - k, j] = inv              # lead:  x[i - k]
            w[j + halo + k, tile + j] = inv       # trail: x[i + k]
    return w


def lead_trail_means_matmul(x: jnp.ndarray, guard: int, ref: int, axis: int,
                            tile: int = 128) -> tuple[jnp.ndarray,
                                                      jnp.ndarray]:
    """Matmul formulation of :func:`lead_trail_means`: the window-sum box
    filters as a blocked banded-stencil matmul (the same restructuring
    ops/pulse_compression.py uses for the matched filter, applied to the
    CFAR reference windows; ref fun_process_single_frame.m:192-213 computes
    these means with per-cell loops).

    Each ``tile``-wide output block contracts a ``tile + 2*(guard+ref)``
    input window against one constant [window, 2*tile] matrix — both lead
    and trail means of a block come out of a single matmul pass. Cost is
    ``2 * (tile + 2*halo)`` MACs per cell (~4.3 GMAC at the full frame
    size with tile=128), traded against :func:`lead_trail_means`'s
    ``2*ref`` elementwise add-passes over the whole cube.

    Equal to :func:`lead_trail_means` up to f32 summation order: the matmul
    accumulates each window in one pass, the shift-add formulation in
    ``ref`` ordered adds. Zero fill at the borders is identical, and the
    summation-order difference is Pfa-invisible (measured on identical
    draws, results/pfa_matmul_recheck.json).

    The blocked-window ``jnp.stack`` materializes a
    (tile+2*halo)/tile-amplified copy of the whole cube before the einsum,
    which is why the default stays "shift"; this formulation ships as
    ``CfarParams.means_impl="matmul"``.
    """
    halo = guard + ref
    xm = jnp.moveaxis(x, axis, -1)
    n = xm.shape[-1]
    n_tiles = -(-n // tile)
    pad_r = n_tiles * tile - n + halo
    xp = jnp.pad(xm, [(0, 0)] * (xm.ndim - 1) + [(halo, pad_r)])
    blocks = jnp.stack(
        [jax.lax.slice_in_dim(xp, t * tile, t * tile + tile + 2 * halo,
                              axis=-1) for t in range(n_tiles)], axis=-2)
    w = _banded_means_matrix(guard, ref, tile)
    y = jnp.einsum("...tm,ml->...tl", blocks, jnp.asarray(w, x.dtype),
                   precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=x.dtype)   # [..., n_tiles, 2*tile]
    flat = xm.shape[:-1] + (n_tiles * tile,)
    lead = y[..., :tile].reshape(flat)[..., :n]
    trail = y[..., tile:].reshape(flat)[..., :n]
    return (jnp.moveaxis(lead, -1, axis), jnp.moveaxis(trail, -1, axis))


def _combine(lead: jnp.ndarray, trail: jnp.ndarray, method: str) -> jnp.ndarray:
    if method == "GOCA":
        return jnp.maximum(lead, trail)
    if method == "SOCA":
        return jnp.minimum(lead, trail)
    if method == "CA":
        return 0.5 * (lead + trail)
    raise ValueError(f"unknown CFAR method: {method}")


def pair_sum_maps(rdm: jnp.ndarray) -> jnp.ndarray:
    """|RDM| adjacent-beam sums: [V, G, B] complex -> [V, G, B-1] real
    (ref :184-187)."""
    mag = jnp.abs(rdm)
    return mag[:, :, :-1] + mag[:, :, 1:]


def goca_noise_and_valid(maps: jnp.ndarray, params: CfarParams
                         ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The 2D cross noise estimate max(noise_R, noise_V) and the
    border-validity mask (True = testable cell), before the threshold
    factor is applied. Exposed separately so Pfa calibration
    (ops/cfar_analysis.py) can sweep threshold factors over one noise
    computation. ``maps`` are [V, G, pairs]."""
    r_axis, v_axis = 1, 0
    if params.means_impl == "matmul":
        lead_r, trail_r = lead_trail_means_matmul(
            maps, params.guard_cells_r, params.ref_cells_r, axis=r_axis)
    else:
        lead_r, trail_r = lead_trail_means(maps, params.guard_cells_r,
                                           params.ref_cells_r, axis=r_axis)
    noise_r = _combine(lead_r, trail_r, params.method)
    lead_v, trail_v = lead_trail_means(maps, params.guard_cells_v,
                                       params.ref_cells_v, axis=v_axis)
    noise_v = _combine(lead_v, trail_v, params.method)
    noise = jnp.maximum(noise_r, noise_v)

    num_v, num_r = maps.shape[v_axis], maps.shape[r_axis]
    border_r = params.ref_cells_r + params.guard_cells_r
    border_v = params.ref_cells_v + params.guard_cells_v
    r_ok = (jnp.arange(num_r) >= border_r) & (jnp.arange(num_r)
                                              < num_r - border_r)
    v_ok = (jnp.arange(num_v) >= border_v) & (jnp.arange(num_v)
                                              < num_v - border_v)
    valid = v_ok[:, None, None] & r_ok[None, :, None]
    return noise, valid


def goca_cfar_2d(maps: jnp.ndarray, params: CfarParams
                 ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Detection mask and threshold map for [V, G, pairs] pair-sum maps.

    Returns (mask bool, threshold); border cells are always False in the
    mask (threshold map holds garbage there).
    """
    noise, valid = goca_noise_and_valid(maps, params)
    threshold = params.threshold_factor * noise
    mask = (maps > threshold) & valid
    return mask, threshold


class Detections(NamedTuple):
    """Fixed-capacity raw detection list (ref ``all_raw_detections`` rows
    [v_idx, r_idx, pair_idx, amplitude], 0-based here)."""

    v_idx: jnp.ndarray     # int32 [cap]
    r_idx: jnp.ndarray     # int32 [cap]
    pair_idx: jnp.ndarray  # int32 [cap]
    amp: jnp.ndarray       # real [cap]
    valid: jnp.ndarray     # bool [cap]
    count: jnp.ndarray     # int32 scalar (true number found, may exceed cap)


def first_k_true_indices(flat: jnp.ndarray, capacity: int,
                         row_width: int = 4096) -> tuple[jnp.ndarray,
                                                         jnp.ndarray]:
    """Ascending flat indices of the first ``capacity`` True entries of a
    large boolean vector, plus a validity mask.

    Equivalent to ``jnp.nonzero(flat, size=capacity)`` but gather-free: a
    plain nonzero lowers to a giant 1-D scan and ``top_k`` over negated
    indices lowers to a full 13M-element sort — both dominate frame time.
    Here the vector is tiled into rows; per-slot binary search over the
    row-count prefix sum finds each hit's row, a one-hot matmul
    fetches the 512 relevant rows, and a lane-axis cumsum locates the hit
    inside its row. All pieces are O(n) elementwise or tiny.
    """
    n = flat.shape[0]
    num_rows = -(-n // row_width)
    padded = jnp.zeros((num_rows * row_width,), bool).at[:n].set(flat)
    m2 = padded.reshape(num_rows, row_width)
    row_counts = jnp.sum(m2, axis=1).astype(jnp.int32)          # [R]
    row_off = jnp.cumsum(row_counts) - row_counts               # exclusive
    slots = jnp.arange(capacity, dtype=jnp.int32)
    total = row_off[-1] + row_counts[-1]
    valid = slots < jnp.minimum(total, capacity)
    # row of the s-th global hit: last r with row_off[r] <= s
    r_s = (jnp.searchsorted(row_off, slots, side="right",
                            method="compare_all") - 1).astype(jnp.int32)
    r_s = jnp.clip(r_s, 0, num_rows - 1)
    # fetch the selected rows with a one-hot matmul (gather-free). bf16
    # multiply planes are EXACT here: both operands are 0/1 (representable
    # in bf16) and the f32 accumulation of <= row_width ones is exact.
    onehot = jax.nn.one_hot(r_s, num_rows, dtype=jnp.bfloat16)  # [cap, R]
    rows_sel = jnp.einsum("cr,rw->cw", onehot, m2.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)   # [cap, W]
    within = jnp.cumsum(rows_sel, axis=1) - rows_sel            # exclusive
    want = (slots - row_off[r_s]).astype(jnp.float32)
    hit = (jnp.abs(within - want[:, None]) < 0.5) & (rows_sel > 0.5)
    pos_c = jnp.argmax(hit, axis=1).astype(jnp.int32)
    idx = r_s * row_width + pos_c
    return jnp.where(valid, idx, 0), valid


def first_k_true_vgq(mask: jnp.ndarray, capacity: int
                     ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Ascending (pair, range, velocity)-major flat indices of the first
    ``capacity`` True cells of a [V, G, pairs] mask — bit-identical to
    ``first_k_true_indices`` on the transposed ravel, but computed in the
    PRODUCER layout: no 13.6M-bool transpose relayout, no padded copy.

    Rows are (pair, gate) pairs of width V: the per-row counts reduce over
    the leading mask axis (fusable into the CFAR elementwise graph), the
    ≤cap hit rows are fetched with a gate-axis one-hot contraction
    straight against the [V, G, Q] cube (the layout permutation folds into
    the dot's dimension numbers), and the within-row position is a cumsum
    over just V lanes instead of a 4096-wide padded row."""
    num_v, num_g, num_q = mask.shape
    rc = jnp.sum(mask, axis=0).astype(jnp.int32)          # [G, Q]
    row_counts = rc.T.ravel()                              # [Q*G]
    row_off = jnp.cumsum(row_counts) - row_counts          # exclusive
    slots = jnp.arange(capacity, dtype=jnp.int32)
    total = row_off[-1] + row_counts[-1]
    valid = slots < jnp.minimum(total, capacity)
    num_rows = num_q * num_g
    r_s = (jnp.searchsorted(row_off, slots, side="right",
                            method="compare_all") - 1).astype(jnp.int32)
    r_s = jnp.clip(r_s, 0, num_rows - 1)
    q_s = r_s // num_g
    g_s = r_s % num_g
    # fetch the selected V-columns: contract the gate axis as a matmul
    # (bf16 0/1 operands, f32 accumulation of <= num_g ones: exact), then
    # the tiny pair axis elementwise
    onehot_g = jax.nn.one_hot(g_s, num_g, dtype=jnp.bfloat16)   # [cap, G]
    sel_g = jnp.einsum("cg,vgq->cvq", onehot_g,
                       mask.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)      # [cap,V,Q]
    onehot_q = jax.nn.one_hot(q_s, num_q, dtype=jnp.float32)    # [cap, Q]
    rows_sel = jnp.einsum("cvq,cq->cv", sel_g, onehot_q)        # [cap, V]
    within = jnp.cumsum(rows_sel, axis=1) - rows_sel            # exclusive
    want = (slots - row_off[r_s]).astype(jnp.float32)
    hit = (jnp.abs(within - want[:, None]) < 0.5) & (rows_sel > 0.5)
    v_c = jnp.argmax(hit, axis=1).astype(jnp.int32)
    idx = r_s * num_v + v_c        # (q*G + g)*V + v: (q, r, v)-major
    return jnp.where(valid, idx, 0), valid


def extract_detections(mask: jnp.ndarray, maps: jnp.ndarray | None,
                       capacity: int, native_scan: bool = False,
                       impl: str = "rowfetch",
                       rdm: jnp.ndarray | None = None) -> Detections:
    """Turn a boolean [V, G, pairs] detection cube into a fixed-capacity
    index list ordered (pair, range, velocity)-major.

    ``native_scan`` scans the cube in its native [V, G, pairs]
    layout (no 13.6M-element transposed relayout) and argsorts the <=
    capacity hits into the same (pair, range, velocity)-major order
    afterwards — identical output whenever the true count fits the capacity
    (beyond capacity the two variants keep a different — equally arbitrary —
    subset; the reference has no capacity at all).

    ``impl="direct"`` uses :func:`first_k_true_vgq` — same
    output bit for bit in ALL cases including over-capacity, computed in
    the producer layout with (pair, gate)-rows of width V.

    ``rdm`` (direct only): gather the detection amplitude pointwise
    from the complex RDM (|rdm[v,r,p]| + |rdm[v,r,p+1]| — the same values
    the maps hold) so the caller never has to materialize the full
    pair-sum cube for this stage (cfg.tail_from_rdm)."""
    if impl == "direct" and not native_scan:
        num_v, num_r, num_q = mask.shape
        safe, valid = first_k_true_vgq(mask, capacity)
        pair = safe // (num_r * num_v)
        rem = safe % (num_r * num_v)
        r = rem // num_v
        v = rem % num_v
        if rdm is not None:
            amp = (jnp.abs(rdm[v, r, pair])
                   + jnp.abs(rdm[v, r, pair + 1])).astype(
                       jnp.float32 if maps is None else maps.dtype)
        else:
            amp = maps[v, r, pair]
        zero = jnp.zeros((), amp.dtype)
        return Detections(
            v_idx=jnp.where(valid, v, 0).astype(jnp.int32),
            r_idx=jnp.where(valid, r, 0).astype(jnp.int32),
            pair_idx=jnp.where(valid, pair, 0).astype(jnp.int32),
            amp=jnp.where(valid, amp, zero),
            valid=valid,
            count=jnp.sum(mask).astype(jnp.int32),
        )
    num_v, num_r, num_q = mask.shape
    if native_scan:
        flat = mask.ravel()  # [V, G, Q] native order
        safe, valid = first_k_true_indices(flat, capacity)
        v = safe // (num_r * num_q)
        rem = safe % (num_r * num_q)
        r = rem // num_q
        pair = rem % num_q
        # reorder to (pair, range, velocity)-major; invalid slots sort last
        key = (pair * num_r + r) * num_v + v
        key = jnp.where(valid, key, jnp.iinfo(jnp.int32).max)
        order = jnp.argsort(key)
        v, r, pair = v[order], r[order], pair[order]
        valid = valid[order]
    else:
        flat = jnp.transpose(mask, (2, 1, 0)).ravel()
        safe, valid = first_k_true_indices(flat, capacity)
        pair = safe // (num_r * num_v)
        rem = safe % (num_r * num_v)
        r = rem // num_v
        v = rem % num_v
    amp = maps[v, r, pair]
    zero = jnp.zeros((), maps.dtype)
    return Detections(
        v_idx=jnp.where(valid, v, 0).astype(jnp.int32),
        r_idx=jnp.where(valid, r, 0).astype(jnp.int32),
        pair_idx=jnp.where(valid, pair, 0).astype(jnp.int32),
        amp=jnp.where(valid, amp, zero),
        valid=valid,
        count=jnp.sum(mask).astype(jnp.int32),
    )
