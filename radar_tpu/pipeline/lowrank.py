"""Shared stage callables for the rank-K closed-form RDM pipeline
(cfg.lowrank_rdm): the deterministic signal RDM as K outer products, white
beam noise through PC+MTD, and the post-MTD Cholesky beam mixing — exact
linear commutation with the fused beam-space path (tests/test_fused.py).

Factored out so the single-device processor (pipeline/frame.py), the
Monte-Carlo trial fn (pipeline/montecarlo.py) and the GSPMD-sharded
processor (parallel/sharded.py) compose the SAME stages; the sharded
version just inserts sharding constraints between them."""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config.params import RadarConfig
from ..ops.dbf import dbf_weights_effective_np
from ..ops.mtd import make_mtd_matrix, mtd, mtd_matmul
from ..ops.pulse_compression import (compact_noise_plan, make_matmul_plan,
                                     make_plan, pulse_compress,
                                     pulse_compress_matmul)
from ..sim.echo import (beam_noise_factor, synthesize_factors,
                        white_complex_noise)


class LowrankStages(NamedTuple):
    signal_rdm: Callable    # targets -> [V, G, B] complex (rank-K closed form)
    gen_noise: Callable     # key -> white z [P, S(_compact), B]
    pc: Callable            # z -> [P, G, B] (compact plan when enabled)
    mtd: Callable           # pc -> [V, G, B]
    mix_add: Callable       # (rdm_sig, rdm_z) -> final RDM [V, G, B]
    rdm: Callable           # (key, targets) -> final RDM [V, G, B]


def make_lowrank_stages(cfg: RadarConfig, precomp,
                        dtype=jnp.complex64) -> LowrankStages:
    plan = make_plan(precomp)
    mplan = make_matmul_plan(precomp) if cfg.pc_method == "matmul" else None
    mtd_win = np.asarray(precomp.mtd_win, jnp.finfo(dtype).dtype)
    mtd_mat = (make_mtd_matrix(precomp.mtd_win, cfg.sig.prt_num,
                               cfg.mtd_fft_len)
               if cfg.mtd_method == "matmul" else None)
    dbf_w = np.asarray(precomp.dbf_w)
    w_eff = dbf_weights_effective_np(dbf_w, cfg.dbf_variant)
    mix_np = np.ascontiguousarray(w_eff.T)        # [C, B]
    l_np = beam_noise_factor(w_eff)               # [B, B]
    nplan, nlen = (None, 0)
    if cfg.compact_noise and mplan is not None:
        nplan, nlen = compact_noise_plan(mplan)
    num_b = dbf_w.shape[0]

    def _pc_full(x):
        return (pulse_compress_matmul(x, mplan,
                                      precision=cfg.matmul_precision)
                if mplan is not None else pulse_compress(x, precomp, plan))

    def _mtd(x):
        return (mtd_matmul(x, mtd_mat, precision=cfg.matmul_precision)
                if mtd_mat is not None else mtd(x, mtd_win, cfg.mtd_fft_len))

    def signal_rdm(targets):
        dop_amp, base, steer_b = synthesize_factors(targets, precomp, cfg,
                                                    mix_np, dtype=dtype)
        pc_base = _pc_full(base[:, :, None])[:, :, 0]          # [K, gates]
        dop_v = _mtd(dop_amp.T[:, None, :])[:, 0, :].T         # [K, n_dop]
        return jnp.einsum("kv,kj,kb->vjb", dop_v, pc_base, steer_b,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=dtype)

    def gen_noise(key):
        s = nlen if nplan is not None else cfg.sig.point_prt
        return white_complex_noise(key, (cfg.sig.prt_num, s, num_b), dtype,
                                   impl=cfg.noise_prng)

    def pc(z):
        if nplan is not None:
            return pulse_compress_matmul(z, nplan,
                                         precision=cfg.matmul_precision)
        return _pc_full(z)

    def mix_add(rdm_sig, rdm_z):
        return rdm_sig + jnp.einsum(
            "vgj,bj->vgb", rdm_z, jnp.asarray(l_np).astype(dtype),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=dtype)

    def rdm(key, targets):
        # PC contracts fast time, MTD slow time, the Cholesky mix beams —
        # disjoint axes, so all three commute (exact up to float
        # reassociation)
        return mix_add(signal_rdm(targets), _mtd(pc(gen_noise(key))))

    return LowrankStages(signal_rdm=signal_rdm, gen_noise=gen_noise, pc=pc,
                         mtd=_mtd, mix_add=mix_add, rdm=rdm)
