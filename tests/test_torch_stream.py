"""The port's streaming path (pipeline/step.vo_step, runner.run_sequence_scan,
api.VisualOdometry) on the CPU.

  - against tpu_vo's run_sequence_scan on make_sequence(4, 160x120),
    2 levels, 150 features: the same pose_ok, num_matches and
    num_keypoints per frame, and each world rotation within 0.5 deg of
    tpu_vo's (the RANSAC draws differ: tpu_vo's PRNG keys, the port's
    per-pair generators);
  - run_sequence_scan against the port's run_sequence_batched, for the
    default config and each option (ratio test, count scoring, 8-point
    samples, the min_valid_fraction gates): every per-pair output bit for
    bit; the world poses within 1e-6, because the batched runner composes
    them by prefix doubling and the streaming one frame after frame;
  - a checkpoint saved after frame 2 and resumed: the uninterrupted run
    bit for bit;
  - the facade: the scan's trajectory and records, the getters, a BGR
    frame, its checkpoints, and the keypoint overlay with the frame's
    keypoints and descriptors.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_vo.configs import ORBConfig as JORBConfig, VOConfig as JVOConfig
from tpu_vo.pipeline import runner as jrunner
from tpu_vo_torch import api
from tpu_vo_torch.configs import MatchConfig, ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.io.trajectory_io import load_checkpoint, save_checkpoint
from tpu_vo_torch.pipeline import runner, step
from tpu_vo_torch.utils.records import sequence_records
from tpu_vo_torch.utils.synthetic import make_sequence
from tpu_vo_torch.viz.overlay import draw_keypoints_overlay
from _torch_threads import _one_thread  # noqa: F401

W, H, T = 160, 120, 4
ORB = dict(n_features=150, n_levels=2)
MAX_ROT_DIFF_DEG = 0.5


@pytest.fixture(scope="module")
def frames():
    return np.stack(make_sequence(n_frames=T, width=W, height=H, seed=1)[0])


def _cfg(**kw):
    return VOConfig(image_width=W, image_height=H, orb=ORBConfig(**ORB), **kw)


@pytest.fixture(scope="module")
def scan(frames):
    return runner.run_sequence_scan(torch.from_numpy(frames), _cfg(), device="cpu")


def _rot_deg(a, b):
    c = (np.trace(np.swapaxes(a, -1, -2) @ b, axis1=-2, axis2=-1) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def test_scan_matches_tpu_vo(frames, scan):
    cfg = JVOConfig(image_width=W, image_height=H, orb=JORBConfig(**ORB))
    j = jax.jit(lambda f: jrunner.run_sequence_scan(f, cfg))(jnp.asarray(frames))
    assert scan.pose.R.shape == (T, 3, 3) and scan.num_matches.shape == (T,)
    for name in ("pose_ok", "num_matches", "num_keypoints", "has_F"):
        np.testing.assert_array_equal(getattr(scan, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert scan.pose_ok[1:].any()
    rot = _rot_deg(scan.pose.R.double().numpy(), np.asarray(j.pose.R, np.float64))
    assert rot.max() < MAX_ROT_DIFF_DEG, rot


def test_first_frame_is_identity_and_masked(scan):
    assert torch.equal(scan.pose.R[0], torch.eye(3)) and not scan.pose.t[0].any()
    for name in ("num_matches", "num_inliers", "num_valid_points", "pose_ok", "scale",
                 "epipolar_residual", "has_F"):
        assert not getattr(scan, name)[0], name
    assert scan.num_keypoints[0] == ORB["n_features"]
    assert torch.isfinite(scan.F).all()


@pytest.mark.parametrize("option", [
    {},
    {"match": MatchConfig(use_ratio_test=True)},
    {"ransac": RansacConfig(score_method="count")},
    {"ransac": RansacConfig(use_five_point=False)},
    {"ransac": RansacConfig(min_valid_fraction=0.5)},
], ids=["default", "ratio_test", "count", "eight_point", "min_valid_fraction"])
def test_scan_equals_batched(frames, option):
    cfg = _cfg(**option)
    out = runner.run_sequence_scan(torch.from_numpy(frames), cfg, seed=7, device="cpu")
    poses, diags = runner.run_sequence_batched(torch.from_numpy(frames), cfg, seed=7,
                                               device="cpu")
    for name, v in diags.items():
        assert torch.equal(getattr(out, name)[1:], v), name
    assert out.pose_ok[1:].any()
    torch.testing.assert_close(out.pose.R, poses.R, rtol=0, atol=1e-6)
    torch.testing.assert_close(out.pose.t, poses.t, rtol=0, atol=1e-6)


def test_checkpoint_resume_is_exact(frames, scan, tmp_path):
    cfg = _cfg()
    f = torch.from_numpy(frames)
    state = step.initial_state(cfg)
    for i in range(2):
        state, _ = step.vo_step(state, f[i], cfg)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state)
    resumed = load_checkpoint(path)
    assert resumed.frame_idx == 2 and resumed.initialized
    for i in range(2, T):
        resumed, out = step.vo_step(resumed, f[i], cfg)
        assert torch.equal(out.pose.R, scan.pose.R[i]) and torch.equal(out.pose.t, scan.pose.t[i])
        assert torch.equal(out.num_inliers, scan.num_inliers[i])


def test_visual_odometry_facade(frames, scan, tmp_path):
    vo = api.VisualOdometry(W, H, config=_cfg(), device="cpu")
    assert not vo.has_last_F()
    with pytest.raises(RuntimeError, match="no fundamental"):
        vo.last_F()
    for i in range(T):
        image = frames[i] if i % 2 else np.repeat(frames[i][..., None], 3, -1)  # BGR too
        frame = api.Frame.from_image(i, image)
        vo.process_frame(frame)
        assert frame.processed and torch.equal(frame.pose.R, scan.pose.R[i])
        if i == 1:
            vo.save_checkpoint(str(tmp_path / "vo.npz"))
    centers = np.stack(vo.get_trajectory())
    np.testing.assert_array_equal(centers, scan.pose.t.numpy())
    assert len(vo.get_trajectory_poses()) == T
    assert vo.get_records() == sequence_records(scan)
    last = int(np.flatnonzero(scan.has_F.numpy())[-1])
    np.testing.assert_array_equal(vo.last_F(), scan.F[last].numpy())
    np.testing.assert_array_equal(vo.camera_matrix, [[W, 0, W / 2], [0, W, H / 2], [0, 0, 1]])
    for image in (frames[0], np.repeat(frames[0][..., None], 3, -1)):
        frame = api.Frame.from_image(T, image)
        overlay = vo.process_frame(frame, render_overlay=True)
        prev = vo._state.prev
        valid = prev.valid.numpy()
        assert valid.any() and frame.keypoints.shape == (valid.sum(), 2)
        np.testing.assert_array_equal(frame.keypoints, prev.xy.numpy()[valid])
        np.testing.assert_array_equal(frame.descriptors, prev.desc.numpy()[valid])
        np.testing.assert_array_equal(overlay, draw_keypoints_overlay(frames[0], prev))
        assert overlay.shape == (H, W, 3) and (overlay != frames[0][..., None]).any()
    vo.restore_checkpoint(str(tmp_path / "vo.npz"))
    frame = api.Frame.from_image(2, frames[2])
    vo.process_frame(frame)
    assert torch.equal(frame.pose.t, scan.pose.t[2])
    with pytest.raises(ValueError, match="config is for"):
        api.VisualOdometry(W + 1, H, config=_cfg(), device="cpu")


def test_streaming_entry_points_need_the_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_sequence_scan(torch.zeros((2, H, W), dtype=torch.uint8), _cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.VisualOdometry(W, H)
