"""Smoke tests for the tracking-layer artifact generators — the scripts
behind results/headline_5target.json and results/tracking_mc*.json (the
earlier records are in git history, git show dc6ffd7:results/).
Tiny CPU runs; guards the scenario plumbing, scoring, and artifact
schema against regressions (the same guardrail test_roc_scripts.py
gives the detection-layer artifacts)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, extra, out):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script), "--cpu",
         "--small", "--out", str(out)] + extra,
        cwd=REPO, capture_output=True, text=True, timeout=560,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, (
        f"{script} failed\nstdout:\n{proc.stdout[-3000:]}\n"
        f"stderr:\n{proc.stderr[-3000:]}")
    return json.loads(out.read_text())


@pytest.mark.slow
def test_headline_5target_smoke(tmp_path):
    rep = _run("run_headline_5target.py",
               ["--frames", "6", "--seeds", "2"],
               tmp_path / "h5.json")
    assert rep["frames"] == 6
    assert len(rep["per_target"]) == 5
    # reference scene values ride through to the artifact (v8_2.m:28-51)
    assert [t["truth"]["range_m"] for t in rep["per_target"]] == \
        [3000.0, 5000.0, 6500.0, 8000.0, 10000.0]
    # every target detectable even at small scale (integration gain)
    assert rep["track_pd"] == 1.0
    assert rep["robustness"]["seeds"] == 2
    assert (tmp_path / "h5_ppi.png").exists()


@pytest.mark.slow
def test_tracking_mc_smoke(tmp_path):
    rep = _run("run_tracking_mc.py",
               ["--scenes", "3", "--frames", "6"],
               tmp_path / "mc.json")
    assert rep["scenes"] == 3
    assert set(rep["by_scene_type"]) == {"random", "close", "crossing"}
    ov = rep["overall"]
    for key in ("track_pd", "false_tracks_per_scene",
                "ghost_tracks_per_scene", "fragmentation",
                "switched_tracks_total", "mean_purity"):
        assert key in ov, key
    assert 0.0 <= ov["track_pd"] <= 1.0


@pytest.mark.slow
def test_monopulse_ab_smoke(tmp_path):
    rep = _run("run_monopulse_ab.py",
               ["--snrs=-10", "--trials", "4", "--batch", "4"],
               tmp_path / "ab.json")
    assert {r["variant"] for r in rep["rows"]} == {"integer_flaw",
                                                   "refined"}
    assert len(rep["deltas"]) == 1
