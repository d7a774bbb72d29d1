"""The GPU bring-up surface that runs on the CPU: the config without the
removed kernel flags, float32 matmuls at Precision.HIGHEST, the device and
compile-cache helpers, the vectorized CFAR oracle, and the import footprint
of the main path."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radar_tpu.config.params import (PERF_OVERRIDES, perf_config,
                                     small_test_config)
from radar_tpu.sim.scenario import TargetBatch
from radar_tpu.utils import device
from radar_tpu.waveform.precompute import precompute

from oracle import goca_cfar_oracle, goca_cfar_ratio_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the config fields that only selected the removed kernels
REMOVED_FLAGS = ("noise_rdm_impl", "noise_dist", "kernel_maps",
                 "beams_major_tail", "kernel_out_bf16", "use_pallas_cfar",
                 "noise_impl")


@pytest.mark.parametrize("flag", REMOVED_FLAGS)
def test_removed_kernel_flag_is_rejected(flag):
    with pytest.raises(TypeError):
        small_test_config().replace(**{flag: True})


def test_perf_config_is_the_xla_chain():
    cfg = perf_config(small_test_config())
    assert PERF_OVERRIDES == dict(fused_synth_dbf=True, lowrank_rdm=True,
                                  matmul_precision="bf16", noise_prng="rbg")
    for k, v in PERF_OVERRIDES.items():
        assert getattr(cfg, k) == v
    with pytest.raises(TypeError):
        perf_config(small_test_config(), pallas=False)


# ---------------------------------------------------------------- precision
def _dot_precisions(jaxpr) -> list:
    """Precision params of every dot_general in a jaxpr, sub-jaxprs too."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for p in eqn.params.values():
            sub = getattr(p, "jaxpr", p)
            if hasattr(sub, "eqns"):
                out.extend(_dot_precisions(sub))
    return out


def _is_highest(prec) -> bool:
    hi = jax.lax.Precision.HIGHEST
    if isinstance(prec, tuple):
        return all(p == hi for p in prec)
    return prec == hi


def _f32_sites():
    """(name, fn, args) for every float32 matmul site of the pipeline."""
    from radar_tpu.measure import estimate
    from radar_tpu.ops.cfar import lead_trail_means_matmul
    from radar_tpu.ops.dbf import dbf
    from radar_tpu.ops.mtd import make_mtd_matrix, mtd_matmul
    from radar_tpu.ops.pulse_compression import (make_matmul_plan,
                                                 pulse_compress_matmul)
    from radar_tpu.pipeline.lowrank import make_lowrank_stages
    from radar_tpu.sim import echo

    cfg = small_test_config()
    pre = precompute(cfg)
    p, s, c, b = (cfg.sig.prt_num, cfg.sig.point_prt, cfg.sig.channel_num,
                  cfg.sig.beam_num)
    g = pre.n_total_gate
    cube = jnp.zeros((p, s, b), jnp.complex64)
    tb = jax.tree.map(jnp.asarray, TargetBatch.make([3000.0], [10.0], [5.0],
                                                    [10.0]))
    mix = np.zeros((c, b), np.complex64)
    lr = make_lowrank_stages(cfg, pre)
    rdm = jnp.zeros((p, g, b), jnp.complex64)
    q = jnp.zeros((17, 5), jnp.float32)
    return {
        "pulse_compress_matmul": (
            lambda x: pulse_compress_matmul(x, make_matmul_plan(pre), "f32"),
            (cube,)),
        "mtd_matmul": (lambda x: mtd_matmul(
            x, make_mtd_matrix(pre.mtd_win, p), "f32"), (rdm,)),
        "dbf": (lambda x: dbf(x, jnp.asarray(pre.dbf_w)),
                (jnp.zeros((p, s, c), jnp.complex64),)),
        "synthesize_echoes": (
            lambda t: echo.synthesize_echoes(t, pre, cfg), (tb,)),
        "synthesize_echo_beams": (
            lambda t: echo.synthesize_echo_beams(t, pre, cfg, mix), (tb,)),
        "synthesize_factors": (
            lambda t: echo.synthesize_factors(t, pre, cfg, mix), (tb,)),
        "add_noise_beamspace": (lambda x: echo.add_noise_beamspace(
            jax.random.PRNGKey(0), x, np.eye(b)), (cube,)),
        "lowrank_signal_rdm": (lr.signal_rdm, (tb,)),
        "lowrank_mix_add": (lr.mix_add, (rdm, rdm)),
        "spline_peak_offset": (lambda st: estimate._spline_peak_offset(
            st, q, 4, 2), (jnp.zeros((8, 5), jnp.float32),)),
        "value_at_refined": (lambda st: estimate._value_at_refined(
            st, q, q, jnp.zeros(8, jnp.int32), jnp.zeros(8, jnp.int32)),
            (jnp.zeros((8, 5, 5), jnp.float32),)),
        "cfar_means_matmul": (lambda m: lead_trail_means_matmul(
            m, 10, 5, axis=1), (jnp.zeros((p, g, b - 1), jnp.float32),)),
    }


F32_SITES = ["pulse_compress_matmul", "mtd_matmul", "dbf",
             "synthesize_echoes", "synthesize_echo_beams",
             "synthesize_factors", "add_noise_beamspace",
             "lowrank_signal_rdm", "lowrank_mix_add", "spline_peak_offset",
             "value_at_refined", "cfar_means_matmul"]


@pytest.mark.parametrize("site", F32_SITES)
def test_f32_matmul_site_lowers_at_highest_precision(site):
    """On the GPU a default-precision float32 matmul may run in TF32; every
    float32 contraction of the pipeline asks for HIGHEST explicitly."""
    fn, args = _f32_sites()[site]
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precs, f"{site}: no dot_general traced"
    assert all(_is_highest(p) for p in precs), (site, precs)


# ----------------------------------------------------------- device helpers
def test_compile_cache_dir_env_set_wins(tmp_path):
    env = {device.CACHE_ENV: str(tmp_path)}
    assert device.compile_cache_dir(env) == str(tmp_path)


def test_compile_cache_dir_unset_is_fixed_checkout_path():
    got = device.compile_cache_dir({})
    assert got == os.path.join(REPO, ".jax_cache")
    assert got == device.compile_cache_dir({device.CACHE_ENV: ""})
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_setup_compile_cache_leaves_env_choice_alone(tmp_path):
    """With the variable set the helper sets nothing; unset, it points
    JAX at the checkout's cache (run in a child so this process's JAX
    config stays untouched)."""
    code = ("import jax; from radar_tpu.utils.device import "
            "setup_compile_cache as s; print(s()); "
            "print(jax.config.jax_compilation_cache_dir)")
    for env_dir in (str(tmp_path), None):
        env = {k: v for k, v in os.environ.items()
               if k != device.CACHE_ENV}
        env["JAX_PLATFORMS"] = "cpu"
        if env_dir:
            env[device.CACHE_ENV] = env_dir
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             check=True).stdout.split()
        want = env_dir or os.path.join(REPO, ".jax_cache")
        assert out[0] == want
        assert out[1] == (env_dir if env_dir else want)


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "500.00 W"),
      ("NVIDIA H100 80GB HBM3", "700.00 W")]),
])
def test_parse_gpu_identity(text, want):
    assert device.parse_gpu_identity(text) == want


@pytest.mark.parametrize("text", ["", "\n", "NVIDIA H100 80GB HBM3\n",
                                  "NVIDIA H100 80GB HBM3, [N/A]\n",
                                  ", 700.00 W\n"])
def test_parse_gpu_identity_rejects_missing_reading(text):
    with pytest.raises(ValueError):
        device.parse_gpu_identity(text)


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit):
        device.require_gpu()


# ------------------------------------------------------------------ oracle
@pytest.mark.parametrize("method", ["GOCA", "SOCA", "CA"])
def test_vectorized_cfar_oracle_matches_loop_oracle(method):
    rng = np.random.default_rng(4)
    maps = rng.exponential(size=(36, 90, 3))
    want = goca_cfar_oracle(maps, 4, 3, 3, 2, 3.0, method)
    got, stat = goca_cfar_ratio_oracle(maps, 4, 3, 3, 2, 3.0, method)
    np.testing.assert_array_equal(got, want)
    assert want.any()
    np.testing.assert_array_equal(np.nan_to_num(stat) > 1.0, want)


# ------------------------------------------------------------------ imports
def test_main_path_imports_neither_matplotlib_nor_orbax():
    code = (
        "import sys, chip_smoke, bench\n"
        "import radar_tpu.pipeline.frame, radar_tpu.pipeline.driver\n"
        "import radar_tpu.pipeline.lowrank, radar_tpu.parallel.dp\n"
        "import radar_tpu.parallel.sharded, radar_tpu.native\n"
        "import radar_tpu.pipeline.track_metrics, radar_tpu.bench.timing\n"
        "sys.path.insert(0, 'tests'); import oracle\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'matplotlib', 'orbax'}))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout
