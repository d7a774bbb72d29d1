"""Segmented pulse compression (SURVEY.md L4, component "Pulse compression").

The reference (fun_process_single_frame.m:99-127) processes three range
segments independently and splices them into ``n_total_gate`` gates:

  - narrow simple pulse: 35-tap real FIR run causally along fast time, then
    advanced by the filter group delay (ref :111-112); gates [0, 228)
  - medium LFM: matched filter fliplr(conj(pulse*kaiser(4.5))) applied as
    FFT-domain fast convolution (ref :114-116); gates [228, 951)
  - long LFM: same with the long matched filter (ref :118-120); gates
    [951, 3404)

Each segment's output is indexed with *global gate indices* into that
segment's own causal-convolution output (ref :123-126) — a reference
convention preserved exactly.

Array formulation: all (pulse, beam) rows are batched into single rFFT-
sized complex FFTs; segments are pre-trimmed to the minimal sample span that
influences their spliced gates (linear-convolution values are independent of
FFT length, so trimming changes nothing numerically while cutting FFT cost;
the reference's 2^nextpow2 full-segment sizes are available via
``trim=False`` for bit-parity experiments).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.signal import next_pow2


class PCPlan(NamedTuple):
    """Static splice/FFT plan derived from Precomputed (host side)."""

    seg_start_narrow: int
    seg_start_medium: int
    seg_start_long: int
    fir_delay: int
    n_taps: int
    n_mf_med: int
    n_mf_long: int
    gate_narrow_end: int     # 228
    gate_medium_end: int     # 951
    n_total_gate: int        # 3404
    # trimmed segment lengths and FFT sizes
    narrow_len: int
    med_len: int
    long_len: int
    nfft_narrow: int
    nfft_med: int
    nfft_long: int


def make_plan(precomp, trim: bool = True) -> PCPlan:
    g1, g2, g3 = precomp.gate_splits
    gate_narrow_end = g1
    gate_medium_end = g1 + g2
    n_total = precomp.n_total_gate
    n_taps = len(precomp.mf_narrow)
    n_mf_med = len(precomp.mf_medium_win)
    n_mf_long = len(precomp.mf_long_win)
    full_med = precomp.n_fft_med // 1  # reference sizes
    full_long = precomp.n_fft_long
    # minimal spans: causal conv output col n depends on inputs [0, n]
    narrow_len = gate_narrow_end + precomp.fir_delay
    med_len = gate_medium_end if trim else None
    long_len = n_total if trim else None
    # (untrimmed = full remaining PRT; caller passes sample count)
    return PCPlan(
        seg_start_narrow=precomp.seg_start_narrow,
        seg_start_medium=precomp.seg_start_medium,
        seg_start_long=precomp.seg_start_long,
        fir_delay=precomp.fir_delay,
        n_taps=n_taps,
        n_mf_med=n_mf_med,
        n_mf_long=n_mf_long,
        gate_narrow_end=gate_narrow_end,
        gate_medium_end=gate_medium_end,
        n_total_gate=n_total,
        narrow_len=narrow_len,
        med_len=med_len if trim else -1,
        long_len=long_len if trim else -1,
        nfft_narrow=next_pow2(narrow_len + n_taps - 1),
        nfft_med=(next_pow2(gate_medium_end + n_mf_med - 1)
                  if trim else full_med),
        nfft_long=(next_pow2(n_total + n_mf_long - 1)
                   if trim else full_long),
    )


class MatmulPlan(NamedTuple):
    """Banded-Toeplitz matmul plan: the causal convolutions become chunked
    [window, out_chunk] matmuls against host-precomputed filter matrices —
    matmuls with constant operands instead of FFTs. Numerically this is
    exact direct convolution.

    chunks: list of (seg_start_sample, window_len, M [window_len, out_len])
    in splice order; concatenating the chunk outputs yields the full
    [pulses, n_total_gate, beams] PC cube."""

    chunks: tuple


def _toeplitz_chunks(h: np.ndarray, seg_start: int, out_lo: int, out_hi: int,
                     gate_offset: int, chunk: int) -> list:
    """Chunks for causal-conv outputs [out_lo, out_hi) of a segment whose
    samples start at ``seg_start`` in the PRT; gate_offset unused (outputs
    are already emitted in splice order)."""
    lh = len(h)
    del gate_offset
    out = []
    o0 = out_lo
    while o0 < out_hi:
        o1 = min(o0 + chunk, out_hi)
        w0 = max(o0 - (lh - 1), 0)
        wlen = o1 - w0
        m = np.zeros((wlen, o1 - o0), dtype=np.complex128)
        for j in range(o1 - o0):
            # y[o0+j] = sum_m h[(o0+j) - (w0+m)] * x[w0+m]
            k = (o0 + j) - (w0 + np.arange(wlen))
            sel = (k >= 0) & (k < lh)
            m[sel, j] = h[k[sel]]
        out.append((seg_start + w0, wlen, m))
        o0 = o1
    return out


def make_matmul_plan(precomp, chunk: int = 256) -> MatmulPlan:
    # ``chunk`` is the output-gate block of each banded-Toeplitz matmul:
    # smaller chunks waste fewer dense MACs on the 700-tap long-segment
    # band, larger ones give bigger matmuls. 256 is a plan parameter still
    # to be re-tuned on the GPU (ROADMAP.md).
    g1, g2, _ = precomp.gate_splits
    gate_medium_end = g1 + g2
    n_total = precomp.n_total_gate
    fir = np.asarray(precomp.mf_narrow, np.complex128)
    fd = precomp.fir_delay
    chunks = []
    # narrow: causal FIR outputs [fd, fd + g1) of the narrow segment
    chunks += _toeplitz_chunks(fir, precomp.seg_start_narrow, fd, fd + g1,
                               0, chunk)
    # medium: outputs [g1, g1+g2) of the medium segment
    chunks += _toeplitz_chunks(np.asarray(precomp.mf_medium_win),
                               precomp.seg_start_medium, g1, gate_medium_end,
                               0, chunk)
    # long: outputs [g1+g2, n_total) of the long segment
    chunks += _toeplitz_chunks(np.asarray(precomp.mf_long_win),
                               precomp.seg_start_long, gate_medium_end,
                               n_total, 0, chunk)
    return MatmulPlan(chunks=tuple(chunks))


def compact_noise_plan(mplan: MatmulPlan) -> tuple[MatmulPlan, int]:
    """Remap the plan's chunk read windows into a compacted sample space.

    PC reads ONLY the chunk windows (74% of the PRT at the default config);
    white noise in the gaps never reaches any output, so the lowrank noise
    path can generate a [pulses, compact_len, beams] cube instead of the
    full PRT and feed it through the returned plan — distribution-exact
    (every generated sample is iid either way), 26% fewer PRNG draws.
    Returns (plan with w0 remapped to compact coordinates, compact_len)."""
    intervals = sorted((w0, w0 + wlen) for w0, wlen, _ in mplan.chunks)
    merged: list = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    offset = {}
    pos = 0
    for a, b in merged:
        offset[a] = (a, pos)
        pos += b - a
    starts = sorted(offset)

    def remap(w0: int) -> int:
        import bisect

        i = bisect.bisect_right(starts, w0) - 1
        a, p = offset[starts[i]]
        return p + (w0 - a)

    chunks = tuple((remap(w0), wlen, m) for w0, wlen, m in mplan.chunks)
    return MatmulPlan(chunks=chunks), pos


def pulse_compress_matmul(iq_beams: jnp.ndarray, mplan: MatmulPlan,
                          precision: str = "f32") -> jnp.ndarray:
    """[pulses, samples, beams] -> [pulses, n_total_gate, beams] via the
    banded-Toeplitz matmul plan."""
    dtype = iq_beams.dtype
    if precision == "bf16":
        from .precision import einsum_complex_bf16
    pieces = []
    for w0, wlen, m in mplan.chunks:
        seg = jax.lax.slice_in_dim(iq_beams, w0, w0 + wlen, axis=1)
        if precision == "bf16":
            pieces.append(einsum_complex_bf16("pwb,wj->pjb", seg,
                                              jnp.asarray(m),
                                              out_dtype=dtype))
        else:
            mm = jnp.asarray(m, dtype)
            pieces.append(jnp.einsum("pwb,wj->pjb", seg, mm,
                                     precision=jax.lax.Precision.HIGHEST,
                                     preferred_element_type=dtype))
    return jnp.concatenate(pieces, axis=1)


def _fft_causal_conv(x: jnp.ndarray, h: jnp.ndarray, nfft: int,
                     out_slice: slice) -> jnp.ndarray:
    """Causal linear convolution of x (last axis) with filter h via FFT,
    returning output columns ``out_slice``. Output col n = sum_k h[k]*x[n-k].
    """
    xf = jnp.fft.fft(x, n=nfft, axis=-1)
    hf = jnp.fft.fft(h, n=nfft)
    y = jnp.fft.ifft(xf * hf, n=nfft, axis=-1)
    return y[..., out_slice]


def pulse_compress(iq_beams: jnp.ndarray, precomp, plan: PCPlan | None = None,
                   trim: bool = True) -> jnp.ndarray:
    """[pulses, samples, beams] -> [pulses, n_total_gate, beams]."""
    if plan is None:
        plan = make_plan(precomp, trim=trim)
    dtype = iq_beams.dtype
    num_samples = iq_beams.shape[1]

    # move fast time last for batched row FFTs: [P, B, S]
    x = jnp.swapaxes(iq_beams, 1, 2)

    # --- narrow: causal FIR + group-delay advance -> gates [0, g1)
    n_end = plan.narrow_len + plan.n_taps  # small safety margin
    seg_n = x[..., plan.seg_start_narrow:plan.seg_start_narrow + n_end]
    h_n = jnp.asarray(precomp.mf_narrow, dtype)
    piece1 = _fft_causal_conv(
        seg_n, h_n, plan.nfft_narrow,
        slice(plan.fir_delay, plan.fir_delay + plan.gate_narrow_end))

    # --- medium LFM: FFT matched filter -> gates [g1, g1+g2)
    med_stop = (plan.seg_start_medium + plan.med_len
                if plan.med_len > 0 else num_samples)
    seg_m = x[..., plan.seg_start_medium:med_stop]
    h_m = jnp.asarray(precomp.mf_medium_win, dtype)
    piece2 = _fft_causal_conv(
        seg_m, h_m, plan.nfft_med,
        slice(plan.gate_narrow_end, plan.gate_medium_end))

    # --- long LFM -> gates [g1+g2, n_total)
    long_stop = (plan.seg_start_long + plan.long_len
                 if plan.long_len > 0 else num_samples)
    seg_l = x[..., plan.seg_start_long:long_stop]
    h_l = jnp.asarray(precomp.mf_long_win, dtype)
    piece3 = _fft_causal_conv(
        seg_l, h_l, plan.nfft_long,
        slice(plan.gate_medium_end, plan.n_total_gate))

    pc = jnp.concatenate([piece1, piece2, piece3], axis=-1)
    return jnp.swapaxes(pc, 1, 2).astype(dtype)
