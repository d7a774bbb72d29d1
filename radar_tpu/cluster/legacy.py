"""Historical v5 single-stage index-space clustering (SURVEY.md section 2.1
"Clustering (historical single-stage)"; main_simulate_echoes_with_array_v5.m:
491-560).

The v5 driver clusters raw CFAR cell hits of ONE sum RDM directly in index
space — BFS connected components under cell-count gates (|dv| <= 3 cells,
|dr| <= 5 cells), then a power-weighted centroid of the *fractional* cell
indices, converted to physical units by linear interpolation of the axes
(MATLAB ``interp1(1:N, axis, centroid_idx)``). No angle estimation and no
second anti-ghost stage existed yet at v5.

Array formulation: the BFS stack becomes the same fixed-capacity
min-label propagation used by the staged clusterers (cluster/connected.py);
the centroid + interp are masked segment reductions."""

from __future__ import annotations

import jax.numpy as jnp

from .connected import connected_labels, gate_adjacency, merge_weighted_mean
from .stages import ClusteredTargets


def cluster_single_stage_v5(v_idx, r_idx, power, valid,
                            range_axis, velocity_axis,
                            max_range_sep_cells: int = 5,
                            max_vel_sep_cells: int = 3) -> ClusteredTargets:
    """Cluster raw CFAR hits ``(v_idx, r_idx)`` (0-based cell indices, any
    float/int dtype) with powers taken from the RDM at those cells.

    Gates are in CELLS (v5:497-498), unlike the physical-unit gates of the
    staged clusterers. Returns fixed-capacity ``ClusteredTargets`` whose
    range/velocity come from linear interpolation of the axes at the
    power-weighted fractional centroid index (v5:555-557); ``angle_deg`` is
    zero (v5 predates monopulse integration, v5:559)."""
    dtype = jnp.asarray(power).dtype
    vf = jnp.asarray(v_idx, dtype)
    rf = jnp.asarray(r_idx, dtype)
    adj = gate_adjacency([(rf, float(max_range_sep_cells)),
                          (vf, float(max_vel_sep_cells))], valid)
    labels = connected_labels(adj, valid)
    merged, wsum, rep_valid = merge_weighted_mean(
        labels, valid, power, {"v": vf, "r": rf})
    range_axis = jnp.asarray(range_axis, dtype)
    velocity_axis = jnp.asarray(velocity_axis, dtype)
    n_r = range_axis.shape[0]
    n_v = velocity_axis.shape[0]
    rng = jnp.interp(merged["r"], jnp.arange(n_r, dtype=dtype), range_axis)
    vel = jnp.interp(merged["v"], jnp.arange(n_v, dtype=dtype),
                     velocity_axis)
    zero = jnp.zeros((), dtype)
    w = lambda x: jnp.where(rep_valid, x, zero)
    return ClusteredTargets(range_m=w(rng), velocity_ms=w(vel),
                            angle_deg=jnp.zeros_like(w(rng)), power=w(wsum),
                            valid=rep_valid)
