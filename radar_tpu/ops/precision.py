"""Mixed-precision complex contraction.

A complex64 einsum is four real einsums. Casting the real and imaginary
planes to bf16 and accumulating in f32 lets the matrix units run at their
bf16 rate, at the cost of input quantization only (~2^-9 relative). On the
GPU complex64 is stored interleaved (re, im, re, im, ...), so the
``real``/``imag`` splits and the ``lax.complex`` recombine are each a pass
over the operand, not free relabelings; XLA may fuse them into the
neighbouring producer or consumer. Used by the MTD DFT matmul and the
banded-Toeplitz pulse-compression matmul when
``cfg.matmul_precision == "bf16"``. Detection statistics validated in
``git show dc6ffd7:results/bf16_matmul.json`` (detections are threshold
crossings with factor 8; a 0.2% RDM perturbation is statistically
invisible).

The ``"f32"`` branches of those sites pass ``lax.Precision.HIGHEST``, so a
float32 contraction is a float32 contraction on the GPU too, not TF32.

No reference counterpart (the reference is float64 MATLAB end to end); this
is an accuracy/throughput tradeoff exposed as an explicit config variant.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def einsum_complex_bf16(subscripts: str, a: jnp.ndarray, b: jnp.ndarray,
                        out_dtype=jnp.complex64) -> jnp.ndarray:
    """``einsum(subscripts, a, b)`` for complex operands with bf16 multiply
    planes and f32 accumulation. Real operands are promoted with a zero
    imaginary plane skipped (two matmuls instead of four)."""
    f32 = jnp.float32
    a_c = jnp.iscomplexobj(a)
    b_c = jnp.iscomplexobj(b)
    ar = jnp.real(a).astype(jnp.bfloat16)
    br = jnp.real(b).astype(jnp.bfloat16)
    ee = lambda x, y: jnp.einsum(subscripts, x, y,
                                 preferred_element_type=f32)
    if a_c and b_c:
        ai = jnp.imag(a).astype(jnp.bfloat16)
        bi = jnp.imag(b).astype(jnp.bfloat16)
        rr = ee(ar, br) - ee(ai, bi)
        ri = ee(ar, bi) + ee(ai, br)
    elif a_c:
        ai = jnp.imag(a).astype(jnp.bfloat16)
        rr, ri = ee(ar, br), ee(ai, br)
    elif b_c:
        bi = jnp.imag(b).astype(jnp.bfloat16)
        rr, ri = ee(ar, br), ee(ar, bi)
    else:
        return ee(ar, br).astype(out_dtype)
    return lax.complex(rr, ri).astype(out_dtype)
