"""Config 6's degradation on the port against tpu_vo's (cv2) on the CPU:

  - image/filters.filter2d equals cv2.filter2D bit for bit on the very
    calls tpu_vo's apply_photometric_nuisances makes at config 6's levels
    (float64 frames after the exposure gain, float32 without it), at
    config 6's widths (640, 320) and at widths with a tail (323, 23); a
    kernel on cv2's DFT path raises;
  - utils/synthetic.apply_photometric_nuisances equals tpu_vo's for every
    subset of its nuisances, on 64x48 frames, and is seeded and bounded
    (the port of tests/test_metrics.py's test);
  - the pan's four config6_* legs hold the sha256 of the port's degraded
    frames (the corridor's are checked on the card by chip_smoke.py);
  - utils/synthetic.write_dataset's files decode, in both packages'
    load_frame, to the pixels of tpu_vo's;
  - tools/run_benchmarks' config 6 at a cut size gives the JAX harness's
    fields for every scene and level.
"""

import itertools

import numpy as np
import pytest
import torch

from tpu_vo.io import dataset as jdataset
from tpu_vo.utils import synthetic as jsynthetic
from tpu_vo_torch.image.filters import filter2d
from tpu_vo_torch.io import dataset
from tpu_vo_torch.tools import reference_band, run_benchmarks
from tpu_vo_torch.utils import synthetic
from _torch_threads import _one_thread  # noqa: F401

NUISANCES = ("noise", "exposure", "blur", "jpeg")
SUBSETS = [w for r in range(1, 5) for w in itertools.combinations(NUISANCES, r)]


def _frames(n, h, w, seed):
    """Smooth frames with texture, like a render."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.integers(-6, 7, (n, h, w)), -1)
    return [np.clip(f - f.min() + 20, 0, 255).astype(np.uint8) for f in base]


@pytest.mark.parametrize("width", [640, 320, 323, 23])
def test_filter2d_equals_cv2_on_config_6s_calls(monkeypatch, width):
    """Record each cv2.filter2D call of tpu_vo's degradation (its image,
    kernel and result) at every level, with and without the exposure
    gain, and replay it through filter2d."""
    import cv2

    calls = []
    real = cv2.filter2D

    def recording(img, ddepth, kern):
        out = real(img, ddepth, kern)
        calls.append((img.copy(), kern.copy(), out))
        return out

    monkeypatch.setattr(jsynthetic.cv2, "filter2D", recording)
    frames = _frames(12, 9, width, width)
    for level in ("mild", "full", "harsh"):
        kw = synthetic.NUISANCE_LEVELS[level]
        for which in (("exposure", "blur"), ("blur",)):
            jsynthetic.apply_photometric_nuisances(frames, seed=17, which=which, **kw)
    monkeypatch.undo()
    assert {c[0].dtype for c in calls} == {np.dtype(np.float32), np.dtype(np.float64)}
    assert len({c[1].shape for c in calls}) >= 3  # 3x3, 5x5 and 7x7 kernels
    for img, kern, want in calls:
        got = filter2d(img, kern)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"{img.dtype} {kern.shape}")


def test_filter2d_refuses_cv2s_dft_path():
    img = np.zeros((8, 8), np.float64)
    filter2d(img, np.ones((7, 7), np.float32))
    with pytest.raises(ValueError, match="DFT"):
        filter2d(img, np.ones((9, 9), np.float32))
    with pytest.raises(ValueError, match="DFT"):
        filter2d(img.astype(np.float32), np.ones((13, 13), np.float32))


@pytest.mark.parametrize("which", SUBSETS, ids=["+".join(w) for w in SUBSETS])
def test_nuisances_equal_tpu_vos(which):
    frames = synthetic.render("corridor", 5, 64, 48, 0)[0]
    for level in ("mild", "full", "harsh"):
        kw = synthetic.NUISANCE_LEVELS[level]
        want = jsynthetic.apply_photometric_nuisances(frames, seed=17, which=which, **kw)
        got = synthetic.apply_photometric_nuisances(frames, seed=17, which=which, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=f"{which} {level}")


def test_photometric_nuisances_seeded_and_bounded():
    """The port of tests/test_metrics.py's test: deterministic under a
    seed, each nuisance alone perturbs the frames, uint8 frames of the
    input's shape, the input untouched."""
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (48, 64), np.uint8) for _ in range(3)]
    orig = [f.copy() for f in frames]
    a = synthetic.apply_photometric_nuisances(frames, seed=7)
    b = synthetic.apply_photometric_nuisances(frames, seed=7)
    c = synthetic.apply_photometric_nuisances(frames, seed=8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any((x != y).any() for x, y in zip(a, c)), "seed has no effect"
    for f, o in zip(frames, orig):
        np.testing.assert_array_equal(f, o)
    for which in (("noise",), ("exposure",), ("blur",), ("jpeg",)):
        d = synthetic.apply_photometric_nuisances(frames, seed=1, which=which)
        assert d[1].shape == frames[1].shape and d[1].dtype == np.uint8
        diff = np.abs(d[1].astype(np.int32) - frames[1].astype(np.int32))
        assert 0.1 < diff.mean() < 60, which


def test_pan_legs_hold_the_degraded_frames_sha256():
    legs = reference_band.load()
    scene, T, W, H, seed = reference_band.LEGS["config6_pan_clean"]
    assert (scene, T, W, H, seed) == ("pan", 32, 320, 240, 0)
    frames = synthetic.render(scene, T, W, H, seed)[0]
    for level in synthetic.NUISANCE_LEVELS:
        rec = legs[f"config6_pan_{level}"]
        assert rec.get("nuisance", "clean") == level
        assert synthetic.frames_sha256(synthetic.nuisance_level(frames, level)) == \
            rec["frames_sha256"], level


def test_write_dataset_matches_tpu_vos(tmp_path):
    frames = _frames(3, 21, 30, 1)
    bgr = [np.stack([f, 255 - f, f // 2], -1) for f in frames[:2]]
    for name, fs in (("gray", frames), ("bgr", bgr)):
        ours, theirs = tmp_path / f"ours_{name}", tmp_path / f"theirs_{name}"
        synthetic.write_dataset(str(ours), fs)
        jsynthetic.write_dataset(str(theirs), fs)
        a, b = dataset.list_image_paths(str(ours)), jdataset.list_image_paths(str(theirs))
        assert [p.rsplit("/", 1)[1] for p in a] == [p.rsplit("/", 1)[1] for p in b]
        for pa, pb in zip(a, b):
            for gray in (True, False):
                want = jdataset.load_frame(pb, gray)
                np.testing.assert_array_equal(dataset.load_frame(pa, gray), want)
                np.testing.assert_array_equal(jdataset.load_frame(pa, gray), want)


def test_run_config_6_cut_returns_the_jax_fields(monkeypatch):
    """Config 6 at 4 frames of 96x72 (the pan 8 frames of 64x48): one line
    per scene and level with the JAX harness's fields; the reference's
    from a fake leg that is the ground truth itself."""
    from tpu_vo_torch.utils.metrics import scale_matched_gt

    monkeypatch.setitem(run_benchmarks.CONFIGS, 6, (4, 96, 72, 200, 2, "config6"))
    monkeypatch.setattr(run_benchmarks, "REPS", 1)
    monkeypatch.setattr(run_benchmarks, "C6_SCENES", {"corridor": (96, 72), "pan": (64, 48)})
    specs = [run_benchmarks.scene_spec(6, b) for b in range(2)]
    assert specs == [("corridor", 4, 96, 72, 0), ("pan", 8, 64, 48, 0)]
    seqs = [synthetic.render(*s) for s in specs]
    legs = {}
    for scene, (frames, Rs, ts, _) in zip(run_benchmarks.C6_SCENES, seqs):
        for level in synthetic.NUISANCE_LEVELS:
            legs[f"config6_{scene}_{level}"] = {
                "frames_sha256": synthetic.frames_sha256(synthetic.nuisance_level(frames, level)),
                "t": scale_matched_gt(np.stack(ts)).tolist(), "R": np.stack(Rs).tolist(),
                "band": 0.01}
    res = run_benchmarks.run_config(6, seqs, torch.device("cpu"), legs, "cpu")
    assert res["config"] == "6_photometric_nuisance"
    want = {"tpu_vo_ate_vs_gt_rel", "ref_ate_vs_gt_rel", "pose_ok_frac", "frames_per_sec",
            "ate_vs_reference_aligned_rel", "parity_within_ref_band",
            *(p + k for p in ("tpu_vo_", "ref_") for k in
              ("rpe_rot_mean_deg", "rpe_rot_rmse_deg", "rpe_trans_rmse", "rpe_trans_rel_step"))}
    assert list(res["levels"]) == ["corridor", "pan"]
    for scene, levels in res["levels"].items():
        assert list(levels) == list(synthetic.NUISANCE_LEVELS)
        for level, e in levels.items():
            assert want <= set(e), (scene, level, want - set(e))
            assert e["poses_finite"] and e["ref_ate_vs_gt_rel"] == 0.0
            assert (e["frame_chunk"], e["pair_chunk"]) == (8, 3 if scene == "corridor" else 7)


def test_config_6_chunks_and_scenes():
    assert run_benchmarks.config_chunks(6, 48) == (8, 47)
    assert run_benchmarks.config_chunks(6, 32) == (8, 31)
    assert [run_benchmarks.scene_spec(6, b) for b in range(2)] == [
        ("corridor", 48, 640, 480, 0), ("pan", 32, 320, 240, 0)]
    assert run_benchmarks.NUISANCE_LEVELS == {
        "clean": None,
        "mild": dict(read_noise_std=1.0, exposure_amp=0.10, blur_len_px=2.0, jpeg_quality=85),
        "full": dict(read_noise_std=2.0, exposure_amp=0.25, blur_len_px=3.0, jpeg_quality=70),
        "harsh": dict(read_noise_std=4.0, exposure_amp=0.40, blur_len_px=5.0, jpeg_quality=50)}
