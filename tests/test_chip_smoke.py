"""chip_smoke.py's phases at small sizes on the CPU (the card-only parts —
the device phase and the timings' meaning — are exercised on the GPU), and
its refusal to report anything without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from radar_tpu.config.params import perf_config, small_test_config
from radar_tpu.sim.scenario import TargetBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

# the small configs resolve the 3 km target (chip_smoke.TWO_TARGETS' 10 km
# one needs the full aperture)
ONE_TARGET = ([3000.0], [20.0], [10.0], [15.0])


def test_phase_flagship_small():
    out = chip_smoke.phase_flagship(perf_config(small_test_config()),
                                    n_frames=2, truth=ONE_TARGET)
    assert out["compile_s"] > 0


def test_phase_flagship_fails_on_a_missed_target():
    ghost = ([3000.0, 7000.0], [20.0, 12.0], [10.0, 10.0], [15.0, -80.0])
    with pytest.raises(AssertionError, match="not found"):
        chip_smoke.phase_flagship(perf_config(small_test_config()),
                                  n_frames=1, truth=ghost)


def test_phase_parity_exact_small_against_oracle():
    out = chip_smoke.phase_parity_exact(small_test_config(), truth=ONE_TARGET)
    assert out["rdm_err"] <= chip_smoke.EXACT_RDM_TOL
    assert out["cfar_diff"] == 0


@pytest.mark.parametrize("cfg", [
    small_test_config(),
    small_test_config(channels=8, pulses=32, beams=8),
], ids=["8ch_5beams", "8ch_8beams"])
def test_perf_path_matches_f32_path(cfg):
    """perf_config()'s bf16 planes against the same config at f32 on one
    key: RDM within the bf16 tolerance, same final targets."""
    out = chip_smoke.phase_parity_perf(perf_config(cfg), truth=ONE_TARGET)
    assert 0 < out["rdm_err"] <= chip_smoke.PERF_RDM_TOL
    assert out["n_final"] >= 1


def test_phase_stages_small():
    out = chip_smoke.phase_stages(perf_config(small_test_config()),
                                  truth=ONE_TARGET, reps=1,
                                  loop_frames=(1, 2))
    assert set(out) == {"gen_noise", "pc", "mtd", "signal_rdm", "mix_add",
                        "detection_tail", "frame"}
    assert out["pc"]["flops"] > out["mtd"]["flops"] > 0


def test_stage_costs_match_shapes():
    cfg = perf_config(small_test_config())
    from radar_tpu.waveform.precompute import precompute

    pre = precompute(cfg)
    costs = chip_smoke.stage_costs(cfg, pre, 3)
    v, g, b = cfg.sig.prt_num, pre.n_total_gate, cfg.sig.beam_num
    assert costs["signal_rdm"] == (v * g * b * 8, 8 * 3 * v * g * b)
    assert costs["mix_add"] == (3 * v * g * b * 8, 8 * v * g * b * b)


def test_phase_served_small():
    scene = TargetBatch.make(*ONE_TARGET)
    out = chip_smoke.phase_served(perf_config(small_test_config()),
                                  n_frames=3, scene=scene)
    assert out["confirmed"] == 1


def test_phase_four_small():
    """The --four-gpus phase on four of the CPU test devices."""
    assert len(jax.devices()) >= 4
    chip_smoke.phase_four(perf_config(small_test_config()),
                          small_test_config(), n_frames=4, truth=ONE_TARGET)


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("argv", [[], ["--four-gpus"]],
                         ids=["one_gpu", "four_gpus"])
def test_chip_smoke_refuses_the_cpu(argv):
    out = _run(["chip_smoke.py"] + argv, REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_refuses_the_cpu():
    out = _run(["bench.py"], REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_check_truth_found_tolerances():
    """A final target 1 m/s off passes, 4 m/s off fails."""
    from radar_tpu.cluster.stages import ClusteredTargets
    from radar_tpu.pipeline.frame import FrameResult

    def result(v):
        t = ClusteredTargets(
            range_m=np.asarray([3001.0]), velocity_ms=np.asarray([v]),
            angle_deg=np.asarray([10.5]), power=np.asarray([1.0]),
            valid=np.asarray([True]))
        return FrameResult(targets=t, num_raw_detections=np.int32(1),
                           num_final=np.int32(1))

    chip_smoke.check_truth_found(result(21.0), ONE_TARGET, 6.0)
    with pytest.raises(AssertionError):
        chip_smoke.check_truth_found(result(24.0), ONE_TARGET, 6.0)
