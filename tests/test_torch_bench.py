"""tpu_vo_torch.tools.bench (the port of bench.py), the reference's committed
speed (tools/reference_band --speed, data/reference_speed.json) and
tools/run_benchmarks' reference-speed fields, on the CPU at cut sizes.

bench.main prints exactly one stdout line with bench.py's keys, its ratio
consistent with its value and baseline, against a committed entry written
for the cut frames and against a live ReferenceVO run (cv2 is installed
here); a committed entry of other frames or sizes raises, as does a run
with no device and no card. The committed entries hash as the frames the
port renders (bench: the first 32 of make_sequence(64, 1241, 376, seed=0);
config1 and config3: their legs in data/reference_trajectories.json)."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_vo_torch.tools import bench, reference_band, run_benchmarks
from tpu_vo_torch.utils import synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = dict(T=4, width=160, height=120, features=200, hyps=16, repeats=1)
KEYS = {"metric", "value", "unit", "vs_baseline", "cpu_baseline_fps"}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _entry(T=4, W=160, H=120, fps=50.0, frames=None):
    frames = bench.scene(T, W, H)[0] if frames is None else frames
    return {"T": T, "W": W, "H": H, "seed": 0, "scene": "planes",
            "frames_sha256": synthetic.frames_sha256(frames[:reference_band.BENCH_TIMED]),
            "timed_frames": min(T, reference_band.BENCH_TIMED), "cpu_baseline_fps": fps,
            "samples_fps": [fps], "host": {"cpu": "test"}, "date": "test"}


@pytest.fixture
def committed(tmp_path, monkeypatch):
    """Point the committed file at a temporary one; returns a writer of
    its `bench` entry."""
    path = tmp_path / "reference_speed.json"
    monkeypatch.setattr(reference_band, "SPEED_PATH", str(path))

    def write(**kw):
        path.write_text(json.dumps({"entries": {"bench": _entry(**kw)}}))
    return write


def _run(**kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line = bench.main(device="cpu", **kw)
    return line, buf.getvalue().splitlines()


def _check_line(line, lines):
    assert len(lines) == 1 and json.loads(lines[0]) == line
    assert set(line) == KEYS | {"e2e_decode_fps"} and line["e2e_decode_fps"] > 0
    assert line["metric"] == "VO frames/sec/chip (1241x376, 1200 kps, 5pt RANSAC)"
    assert line["unit"] == "frames/sec/chip" and line["value"] > 0
    rec = bench.last_run()
    assert line["value"] == round(rec["fps"], 2)
    assert line["cpu_baseline_fps"] == round(rec["cpu_baseline_fps"], 2)
    assert line["vs_baseline"] == round(rec["fps"] / rec["cpu_baseline_fps"], 2)
    assert abs(line["vs_baseline"] - line["value"] / line["cpu_baseline_fps"]) <= 0.01
    assert rec["expected_launches"] == {"select_maps": 0, "extract_patches": 0}
    assert rec["poses"].t.shape == (CUT["T"], 3) and bool(torch.isfinite(rec["poses"].t).all())


def test_main_prints_one_line_against_a_committed_entry(committed):
    committed(fps=50.0)
    line, lines = _run(**CUT)
    _check_line(line, lines)
    assert line["cpu_baseline_fps"] == 50.0


def test_main_prints_one_line_against_a_live_reference(monkeypatch):
    pytest.importorskip("cv2")
    monkeypatch.setattr(reference_band, "SPEED_PATH", os.devnull)  # never read
    line, lines = _run(reference="live", **CUT)
    _check_line(line, lines)


@pytest.mark.parametrize("wrong", ["frames", "T", "W"])
def test_committed_entry_of_other_frames_raises(committed, wrong):
    other = bench.scene(5, 160, 120)[0][1:]   # frames 1-4 of another sequence
    committed(**{"frames": dict(frames=other), "T": dict(T=5), "W": dict(W=200)}[wrong])
    with pytest.raises(ValueError, match="committed baseline"):
        bench.committed_baseline(bench.scene(4, 160, 120)[0])
    with pytest.raises(ValueError, match="committed baseline"):
        _run(**CUT)


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(**CUT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "tpu_vo_torch.tools.bench", "--T", "4"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_environment_knobs_set_the_sizes(monkeypatch):
    for k, v in (("BENCH_FRAMES", "16"), ("BENCH_REPEATS", "2"), ("BENCH_FRAME_CHUNK", "4"),
                 ("BENCH_PAIR_CHUNK", "5")):
        monkeypatch.setenv(k, v)
    d = bench.defaults()
    assert (d["T"], d["repeats"], d["fc"], d["pc"]) == (16, 2, 4, 5)
    assert (d["width"], d["height"], d["features"], d["hyps"]) == (1241, 376, 1200, 256)
    with pytest.raises(ValueError, match="reference"):
        bench.main(device="cpu", reference="cv2", **CUT)


def test_committed_bench_entry_is_the_ports_frames():
    rec = reference_band.load_speed()["bench"]
    scene, T, W, H, seed = reference_band.BENCH
    assert (rec["T"], rec["W"], rec["H"], rec["seed"], rec["scene"]) == (T, W, H, seed, scene)
    assert (T, W, H) == (bench.defaults()["T"], 1241, 376)
    frames = synthetic.render_range(scene, T, W, H, seed, 0, reference_band.BENCH_TIMED)[0]
    assert rec["frames_sha256"] == synthetic.frames_sha256(frames)
    assert len(rec["samples_fps"]) == reference_band.BENCH_SAMPLES
    assert rec["cpu_baseline_fps"] == float(np.median(rec["samples_fps"]))
    assert os.path.getsize(reference_band.SPEED_PATH) < 10_000


@pytest.mark.parametrize("name", reference_band.SPEED_LEGS)
def test_committed_leg_entries_hash_their_legs(name):
    rec = reference_band.load_speed()[name]
    leg = reference_band.load()[name]
    assert rec["frames_sha256"] == leg["frames_sha256"]
    assert (rec["scene"], rec["T"], rec["W"], rec["H"], rec["seed"]) == reference_band.LEGS[name]
    assert len(rec["samples_fps"]) == reference_band.LEG_SAMPLES
    assert rec["fps"] == float(np.median(rec["samples_fps"])) > 0
    for k in ("cpu", "cpu_count", "cv2", "cv2_threads", "platform"):
        assert k in rec["host"], k


def test_run_benchmarks_config_1_at_other_frames_has_null_reference_speed(tmp_path,
                                                                          monkeypatch):
    """`--configs 1 --frames 3 --device cpu`, the config cut to 160x120 and
    200 keypoints (its size does not enter the fields' logic) and one
    timed run: other frames than the committed leg's, so no reference."""
    monkeypatch.setitem(run_benchmarks.CONFIGS, 1, (96, 160, 120, 200, 1, "config1"))
    monkeypatch.setattr(run_benchmarks, "REPS", 1)
    out = tmp_path / "lines.jsonl"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run_benchmarks.main(["--configs", "1", "--frames", "3", "--device", "cpu",
                                    "--workers", "1", "--out", str(out)]) == 0
    res = json.loads(buf.getvalue().splitlines()[-1])
    assert res["config"] == "1_short_mono_640x480_1k" and res["device"] == "cpu"
    assert res["frames_per_sec_chip"] > 0 and res["one_shot_wall_fps"] > 0
    assert res["vs_opencv_reference"] is None
    assert res["reference"].startswith("none: ")
    assert json.loads(out.read_text().splitlines()[-1]) == res


@pytest.mark.parametrize("n", [1, 2, 3])
def test_run_config_reference_speed_fields(n, tmp_path, monkeypatch):
    """Configs 1-3 cut to 160x120, T 4, their committed speed entry (for
    configs 1 and 3) written for the cut frames: config 1's ratio and
    config 3's seconds a frame come from it."""
    B, leg = run_benchmarks.CONFIGS[n][4], run_benchmarks.CONFIGS[n][5]
    monkeypatch.setitem(run_benchmarks.CONFIGS, n, (4, 160, 120, 200, B, leg))
    frames, Rs, ts, K = synthetic.render(*run_benchmarks.scene_spec(n, 0))
    speed = tmp_path / "reference_speed.json"
    speed.write_text(json.dumps({"entries": {leg: {
        "frames_sha256": synthetic.frames_sha256(frames), "fps": 8.0}}}))
    monkeypatch.setattr(reference_band, "SPEED_PATH", str(speed))
    legs = {leg: {"frames_sha256": synthetic.frames_sha256(frames),
                  "t": np.stack(ts).tolist(), "R": np.stack(Rs).tolist(), "band": 0.01}}
    res = run_benchmarks.run_config(n, [(frames, Rs, ts, K)], torch.device("cpu"), legs, "cpu")
    assert res["frames_per_sec_chip"] > 0 and res["one_shot_wall_fps"] > 0
    assert "frames_per_sec" in res and "reference" not in res
    assert ("vs_opencv_reference" in res) == (n == 1)
    assert ("ref_seconds_per_frame" in res) == (n == 3)
    if n == 1:
        assert res["vs_opencv_reference"] == res["frames_per_sec_chip"] / 8.0
    if n == 3:
        assert res["ref_seconds_per_frame"] == round(1.0 / 8.0, 3)
