"""Digital beamforming (SURVEY.md L4, component "DBF").

One batched complex matmul: the reference's per-pulse loop
``single_pulse_16ch * DBF_coeffs' `` (fun_process_single_frame.m:93-97)
collapses to a single einsum over the whole [pulses, samples, channels] cube.

Two channel-order/conjugation conventions exist in the reference and are
exposed as variants (SURVEY.md section 2.1 "DBF"):
  - "v8":   y[s,b] = sum_c x[s,c] * conj(W[b,c])      (x @ W'), the current
            path (fun_process_single_frame.m:95)
  - "v7_7": y[s,b] = sum_c x[s,c] * fliplr(W)[b,c]    (x @ fliplr(W).'),
            (main_simulate_echoes_with_array_v7_7.m:341,346)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def dbf_weights_effective_np(w, variant: str = "v8") -> np.ndarray:
    """Host-numpy twin of dbf_weights_effective — for build-time constants
    embedded in the compiled program."""
    w = np.asarray(w)
    if variant == "v8":
        return np.conj(w)
    if variant == "v7_7":
        return np.flip(w, axis=1)
    if variant == "realdata":
        return w
    raise ValueError(f"unknown DBF variant: {variant}")


def dbf_weights_effective(w: jnp.ndarray, variant: str = "v8") -> jnp.ndarray:
    """Effective weight matrix M [beams, channels] such that
    ``y = einsum('...c,bc->...b', x, M)`` reproduces the chosen variant."""
    if variant == "v8":
        return jnp.conj(w)
    if variant == "v7_7":
        return jnp.flip(w, axis=1)
    if variant == "realdata":
        # real-data adapter: iq * W.' — plain transpose, no conjugation
        # (main_test_with_simulated_data.m:210-214)
        return jnp.asarray(w)
    raise ValueError(f"unknown DBF variant: {variant}")


def dbf(raw_iq: jnp.ndarray, w: jnp.ndarray,
        variant: str = "v8") -> jnp.ndarray:
    """[pulses, samples, channels] x [beams, channels] -> [pulses, samples,
    beams]."""
    m = dbf_weights_effective(w.astype(raw_iq.dtype), variant)
    return jnp.einsum("psc,bc->psb", raw_iq, m,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=raw_iq.dtype)
