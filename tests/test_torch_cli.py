"""The port's KITTI ingestion (io/kitti, against tpu_vo's) and its CLI
(`python -m tpu_vo_torch.cli`) end to end on the CPU, on a
sequences/00 tree of 4 PNG frames, calib.txt, times.txt and
poses/00.txt that the test writes: calibrated K, times.txt stamps, the
three trajectory files, the ATE report, checkpoints and --resume; the
default run (the trajectory viewer rendering every frame, the 7
screenshots, the same positions as --no-viewer); --show without a
display; and what it refuses (a missing dataset, no card without
--device)."""

import os

import numpy as np
import pytest
import torch

from tpu_vo.io import kitti as jkitti
from tpu_vo_torch import api, cli
from tpu_vo_torch.io import kitti, trajectory_io
from tpu_vo_torch.io.dataset import write_png
from tpu_vo_torch.utils.synthetic import make_sequence
from _torch_threads import _one_thread  # noqa: F401

N, W, H = 4, 192, 144
INTRINSICS = (180.0, 178.5, 95.0, 71.25)
ARGS = ["--levels", "2", "--features", "200", "--ransac-iters", "32", "--no-viewer",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """dataset_root/{sequences/00/{image_0, calib.txt, times.txt}, poses/00.txt}."""
    root = str(tmp_path_factory.mktemp("kitti"))
    seq = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq, "image_0"))
    frames, Rs, ts, _ = make_sequence(n_frames=N, width=W, height=H, seed=3)
    for i, f in enumerate(frames):
        write_png(os.path.join(seq, "image_0", f"{i:06d}.png"), f, filter_type=i % 5)
    fx, fy, cx, cy = INTRINSICS
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        for c in range(4):
            P = np.hstack([K, [[-386.1 * (c % 2)], [0.0], [0.0]]])
            f.write(f"P{c}: " + " ".join(f"{v:.12e}" for v in P.ravel()) + "\n")
        f.write("Tr: " + " ".join(["0"] * 12) + "\n")
    np.savetxt(os.path.join(seq, "times.txt"), 0.1 * np.arange(N), fmt="%.6f")
    os.makedirs(os.path.join(root, "poses"))
    T = np.concatenate([np.asarray(Rs), np.asarray(ts)[..., None]], -1)
    np.savetxt(os.path.join(root, "poses", "00.txt"), T.reshape(N, 12), fmt="%.9e")
    return seq


def test_kitti_parsing_matches_tpu_vo(tree):
    assert kitti.is_kitti_sequence(tree) and not kitti.is_kitti_sequence(os.path.dirname(tree))
    calib = kitti.parse_calib(os.path.join(tree, "calib.txt"))
    ref = jkitti.parse_calib(os.path.join(tree, "calib.txt"))
    assert calib.keys() == ref.keys() == {"P0", "P1", "P2", "P3", "Tr"}
    for k in calib:
        np.testing.assert_array_equal(calib[k], ref[k])
    assert kitti.intrinsics_from_projection(calib["P1"]) == INTRINSICS
    seq, jseq = kitti.open_kitti_sequence(tree), jkitti.open_kitti_sequence(tree)
    for name in ("root", "camera", "image_dir", "image_paths", "intrinsics", "gt_poses_path"):
        assert getattr(seq, name) == getattr(jseq, name), name
    np.testing.assert_array_equal(seq.times, jseq.times)
    for a, b in zip(kitti.load_kitti_poses(seq.gt_poses_path),
                    jkitti.load_kitti_poses(seq.gt_poses_path)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="image_1"):
        kitti.open_kitti_sequence(tree, camera=1)


def test_cli_end_to_end(tree, tmp_path, capsys):
    out = str(tmp_path / "out")
    assert cli.main([tree, *ARGS, "--out-dir", out, "--checkpoint-every", "2"]) == 0
    text = capsys.readouterr().out
    assert "KITTI odometry sequence detected (camera 0" in text
    assert "(calibrated)" in text and "178.5" in text
    assert "Processing complete!" in text and "Frame 3: Detected 200 keypoints" in text
    assert "Ground-truth evaluation" in text and "ate_rmse=" in text
    R, t = kitti.load_kitti_poses(os.path.join(out, "trajectory_kitti.txt"))
    assert R.shape == (N, 3, 3) and np.isfinite(t).all()
    stamps, _ = trajectory_io.load_trajectory_tum(os.path.join(out, "trajectory_tum.txt"))
    np.testing.assert_allclose(stamps, 0.1 * np.arange(N))
    with np.load(os.path.join(out, "trajectory.npz")) as z:
        np.testing.assert_allclose(z["t"], t, atol=1e-8)

    # the checkpoint after frame 4 holds the run's last pose; resuming from
    # the one after frame 2 (written again here) gives frames 3 and 4 as before
    state = trajectory_io.load_checkpoint(os.path.join(out, "vo_checkpoint.npz"))
    assert state.frame_idx == N
    np.testing.assert_allclose(state.pose.t.numpy(), t[-1], rtol=0, atol=1e-8)
    out2 = str(tmp_path / "out2")
    assert cli.main([tree, *ARGS, "--out-dir", out2, "--checkpoint-every", "2",
                     "--max-frames", "2", "--quiet"]) == 0
    assert cli.main([tree, *ARGS, "--out-dir", out2, "--quiet",
                     "--resume", os.path.join(out2, "vo_checkpoint.npz")]) == 0
    assert "Resumed from" in capsys.readouterr().out
    R2, t2 = kitti.load_kitti_poses(os.path.join(out2, "trajectory_kitti.txt"))
    np.testing.assert_array_equal(t2, t[2:])
    np.testing.assert_array_equal(R2, R[2:])


VIEWS = ["posX", "negX", "posY", "negY", "posZ", "negZ", "iso"]


@pytest.fixture(scope="module")
def default_run(tree, tmp_path_factory):
    """The CLI without --no-viewer, render_step counted, and the same run
    with --no-viewer: (out dir, trajectory lengths render_step saw,
    no-viewer out dir)."""
    out = str(tmp_path_factory.mktemp("default"))
    plain = str(tmp_path_factory.mktemp("plain"))
    calls = []
    orig = api.TrajectoryViewer.render_step

    def counting(self, poses):
        calls.append(len(poses))
        return orig(self, poses)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(api.TrajectoryViewer, "render_step", counting)
        viewer = [a for a in ARGS if a != "--no-viewer"]
        assert cli.main([tree, *viewer, "--quiet", "--out-dir", out]) == 0
    assert cli.main([tree, *ARGS, "--quiet", "--out-dir", plain]) == 0
    return out, calls, plain


def test_cli_default_run_writes_the_7_screenshots(default_run):
    out, _, _ = default_run
    shots = os.path.join(out, "trajectory_screenshots")
    assert sorted(os.listdir(shots)) == sorted(f"trajectory_view_from_{v}.jpg" for v in VIEWS)
    from tpu_vo_torch.io import jpeg

    for name in os.listdir(shots):
        with open(os.path.join(shots, name), "rb") as f:
            assert jpeg.decode(f.read()).shape == (768, 1024, 3)


def test_cli_renders_the_trajectory_every_frame(default_run):
    _, calls, _ = default_run
    assert calls == [1, 2, 3, 4]  # each over the whole trajectory so far


def test_cli_default_run_positions_equal_no_viewer(default_run):
    out, _, plain = default_run
    a, b = (kitti.load_kitti_poses(os.path.join(d, "trajectory_kitti.txt")) for d in (out, plain))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_cli_show_without_a_display_runs_headless(tree, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    assert cli.main([tree, *ARGS, "--show", "--quiet", "--max-frames", "2",
                     "--out-dir", str(tmp_path)]) == 0
    captured = capsys.readouterr()
    assert "--show disabled: " in captured.err and "Continuing headless" in captured.err
    assert "Saved trajectory screenshots to: " in captured.out


def test_cli_without_a_card_refuses(tree, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    no_device = [a for a in ARGS if a not in ("--device", "cpu")]
    assert cli.main([tree, *no_device]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_missing_dataset_exits_nonzero(capsys):
    assert cli.main(["/nonexistent_dir_xyz"]) != 0
    assert "Dataset directory not found" in capsys.readouterr().err
    assert cli.main(["/nonexistent_dir_xyz", "--no-viewer"]) != 0
