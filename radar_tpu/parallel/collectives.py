"""Explicit shard_map collectives for the radar pipeline's communication
patterns (SURVEY.md sections 2.3 / 5.7-5.8).

These are the hand-scheduled counterparts of what GSPMD inserts for the
annotated pipeline (parallel/sharded.py); they exist both as documentation
of the communication structure and as building blocks where explicit
scheduling wins:

  - ``dbf_channel_sharded``: channel-sharded DBF — local partial einsum +
    psum over the channel axis (the beamformer partial-sum reduction).
  - ``pulse_compress_range_sharded``: range-sharded overlap-save fast
    convolution — each shard needs the last ``filter_len-1`` samples of its
    left neighbor; the halo rides a ppermute ring (the ring-attention
    analog for fast time).
  - ``mtd_cpi_sharded``: CPI-sharded MTD — pulses are gathered per gate
    block via all_to_all (Ulysses-style axis swap: shard range while
    FFT-ing slow time), FFT'd locally, and re-transposed.
  - ``covariance_snapshot_sharded``: snapshot-sharded covariance
    accumulation X@X^H via psum (MUSIC at scale).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.dbf import dbf_weights_effective


def dbf_channel_sharded(mesh: Mesh, axis: str = "ch", variant: str = "v8"):
    """Returns jitted ``f(iq [P,S,C], w [B,C]) -> [P,S,B]`` with the channel
    axis sharded over ``axis``: each device contracts its channel block and
    the partial beams are psum-reduced (cf. fun_process_single_frame.m:95's
    full matmul)."""

    def local(iq, w):
        m = dbf_weights_effective(w.astype(iq.dtype), variant)
        partial_beams = jnp.einsum("psc,bc->psb", iq, m,
                                   preferred_element_type=iq.dtype)
        return jax.lax.psum(partial_beams, axis)

    f = shard_map(local, mesh=mesh,
                  in_specs=(P(None, None, axis), P(None, axis)),
                  out_specs=P())
    return jax.jit(f)


def _local_overlap_save(seg, h, halo_left, nfft):
    """Fast convolution of [rows, L_local] given the left-neighbor halo
    [rows, len(h)-1]; returns the causal output aligned to this shard's
    samples."""
    lh = h.shape[0]
    x = jnp.concatenate([halo_left, seg], axis=-1)
    xf = jnp.fft.fft(x, n=nfft, axis=-1)
    hf = jnp.fft.fft(h, n=nfft)
    y = jnp.fft.ifft(xf * hf, n=nfft, axis=-1)
    # drop the halo warm-up: output col k of x corresponds to col k-(lh-1)
    # of the shard
    return y[..., lh - 1: lh - 1 + seg.shape[-1]]


def pulse_compress_range_sharded(mesh: Mesh, filter_taps, nfft: int,
                                 axis: str = "cpi"):
    """Returns jitted ``f(x [rows, S]) -> [rows, S]`` computing the causal
    linear convolution with ``filter_taps`` along fast time, with fast time
    sharded over ``axis``. Each shard sends its trailing ``len(h)-1``
    samples to its right neighbor as the overlap-save halo (halo exchange of
    SURVEY.md section 5.7a) through ``lax.ppermute``, which XLA hands to
    the collective library of the backend (NCCL on GPUs); the first shard's
    halo is zeros (causal edge).
    """
    h = np.asarray(filter_taps)
    lh = h.shape[0]

    def local(x):
        n_shards = jax.lax.axis_size(axis)
        halo_src = x[..., -(lh - 1):]
        perm = [(i, i + 1) for i in range(n_shards - 1)]
        halo = jax.lax.ppermute(halo_src, axis, perm)  # from shard i-1
        return _local_overlap_save(x, h.astype(x.dtype), halo, nfft)

    f = shard_map(local, mesh=mesh, in_specs=(P(None, axis),),
                  out_specs=P(None, axis))
    return jax.jit(f)


def mtd_cpi_sharded(mesh: Mesh, mtd_win, axis: str = "cpi"):
    """Returns jitted ``f(pc [P, G, B]) -> rdm [P, G, B]`` with the pulse
    axis sharded over ``axis``: window locally, all_to_all swaps the sharded
    axis from pulses to gates so each device FFTs full slow-time columns for
    its gate block, then swaps back (the distributed-FFT transpose of
    SURVEY.md section 5.7b)."""
    win = np.asarray(mtd_win)

    def local(pc):
        # pc local: [P/n, G, B]
        n = jax.lax.axis_size(axis)
        p_loc = pc.shape[0]
        i = jax.lax.axis_index(axis)
        w = jax.lax.dynamic_slice_in_dim(win.astype(pc.dtype), i * p_loc,
                                         p_loc)
        x = pc * w[:, None, None]
        # gather pulses / scatter gates: [P/n, G, B] -> [P, G/n, B]
        x = jax.lax.all_to_all(x, axis, split_axis=1, concat_axis=0,
                               tiled=True)
        y = jnp.fft.fftshift(jnp.fft.fft(x, axis=0), axes=0)
        # scatter pulses / gather gates back: [P, G/n, B] -> [P/n, G, B]
        return jax.lax.all_to_all(y, axis, split_axis=0, concat_axis=1,
                                  tiled=True)

    f = shard_map(local, mesh=mesh, in_specs=(P(axis, None, None),),
                  out_specs=P(axis, None, None))
    return jax.jit(f)


def covariance_snapshot_sharded(mesh: Mesh, axis: str = "cpi"):
    """Returns jitted ``f(x [C, K]) -> [C, C]`` computing X@X^H/K with the
    snapshot axis sharded: local outer-product accumulation + psum (the MUSIC
    covariance cross-shard reduction, SURVEY.md section 5.7c)."""

    def local(x):
        k_total = x.shape[1] * jax.lax.axis_size(axis)
        r = x @ jnp.conj(x.T)
        return jax.lax.psum(r, axis) / k_total

    f = shard_map(local, mesh=mesh, in_specs=(P(None, axis),), out_specs=P())
    return jax.jit(f)
