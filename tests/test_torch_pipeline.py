"""The port's run_sequence_batched against tpu_vo's runner and ground
truth on the tests/test_pipeline.py scene (make_sequence(480x360, T=8,
seed=3), default VOConfig): pose_ok on >= 70% of pairs, ATE against
tpu_vo's trajectory under 0.3 of its extent, rotation error against
ground truth at most tpu_vo's + 1 deg, keypoint counts within 2%.
Also: tpu_vo's features fed through interop into the port's
estimate_pair, and the port's numpy-only make_sequence tracked by
tpu_vo's runner. And the runner at 64 and 128 keypoints (RANSAC without
its prescreen) and chunked by frames and by pairs (bit for bit the
unchunked run)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_vo.configs import VOConfig as JVOConfig
from tpu_vo.pipeline import runner as jrunner
from tpu_vo.utils.cv_reference import absolute_trajectory_error, relative_pose_error
from tpu_vo.utils.synthetic import make_sequence as jax_make_sequence
from tpu_vo_torch import interop
from tpu_vo_torch.configs import VOConfig
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.pipeline import runner, step
from tpu_vo_torch.utils.synthetic import make_sequence

W, H, T = 480, 360, 8


@pytest.fixture(scope="module")
def jax_run():
    return jax.jit(lambda f: jrunner.run_sequence_batched(f, JVOConfig(image_width=W,
                                                                       image_height=H)))


@pytest.fixture(scope="module")
def scene():
    return jax_make_sequence(n_frames=T, width=W, height=H, seed=3)


@pytest.fixture(scope="module")
def jax_out(scene, jax_run):
    poses, diags = jax_run(jnp.asarray(np.stack(scene[0])))
    return (np.asarray(poses.R, np.float64), np.asarray(poses.t, np.float64),
            {k: np.asarray(v) for k, v in diags.items()})


@pytest.fixture(scope="module")
def port_out(scene):
    poses, diags = runner.run_sequence_batched(torch.from_numpy(np.stack(scene[0])),
                                               VOConfig(image_width=W, image_height=H),
                                               device="cpu")
    return (poses.R.double().numpy(), poses.t.double().numpy(), interop.to_numpy(diags))


def test_runner_tracks_scene_like_tpu_vo(scene, jax_out, port_out):
    _, Rs_gt, _, _ = scene
    Rj, tj, dj = jax_out
    Rt, tt, dt = port_out
    assert Rt.shape == (T, 3, 3) and tt.shape == (T, 3)
    assert np.isfinite(Rt).all() and np.isfinite(tt).all()
    assert dt["pose_ok"].mean() >= 0.7, dt["pose_ok"]
    extent = max(np.linalg.norm(tj[-1]), 1e-9)
    assert absolute_trajectory_error(tt, tj) / extent < 0.3
    assert relative_pose_error(Rt, Rs_gt) <= relative_pose_error(Rj, Rs_gt) + 1.0
    np.testing.assert_allclose(dt["num_keypoints"], dj["num_keypoints"], rtol=0.02)


def test_chain_relative_poses_matches():
    rng = np.random.default_rng(0)
    P = 9
    ang = rng.normal(0, 0.05, (P, 3))
    R = np.stack([np.linalg.qr(np.eye(3) + np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]],
                                                      [-a[1], a[0], 0]]))[0] for a in ang])
    R = (R * np.sign(np.diagonal(R, axis1=1, axis2=2))[:, None, :]).astype(np.float32)
    t = rng.normal(size=(P, 3)).astype(np.float32)
    have = rng.random(P) > 0.2
    ok = have & (rng.random(P) > 0.2)
    cfg = VOConfig()
    j = jrunner.chain_relative_poses(jnp.asarray(R), jnp.asarray(t), jnp.asarray(have),
                                     jnp.asarray(ok), JVOConfig())
    c = runner.chain_relative_poses(torch.from_numpy(R), torch.from_numpy(t),
                                    torch.from_numpy(have), torch.from_numpy(ok), cfg)
    np.testing.assert_allclose(np.asarray(j.R), c.R.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(j.t), c.t.numpy(), rtol=1e-5, atol=1e-5)


def test_tpu_vo_features_through_port_estimate_pair(scene, jax_out):
    """tpu_vo's stage-1 features, carried over by interop, give the port's
    stage 2 the same matches as tpu_vo's own stage 2."""
    from tpu_vo.features.orb import detect_and_compute as jax_detect

    cfg = VOConfig(image_width=W, image_height=H)
    feats = jax.jit(jax.vmap(lambda f: jax_detect(f, JVOConfig().orb)))(
        jnp.asarray(np.stack(scene[0])))
    f = interop.features_from_numpy({k: np.asarray(v) for k, v in feats._asdict().items()})
    prev = ORBFeatures(*(a[:-1] for a in f))
    cur = ORBFeatures(*(a[1:] for a in f))
    est = step.estimate_pair(prev, cur, cfg, generators=runner.pair_generators(0, range(1, T)))
    np.testing.assert_array_equal(est["n_good"].numpy(), jax_out[2]["num_matches"])
    assert est["pose_ok"].float().mean() >= 0.7
    back = interop.to_numpy(f)
    np.testing.assert_array_equal(back["desc32"], np.asarray(feats.desc32))


def test_numpy_make_sequence_tracked_by_tpu_vo(scene, jax_run, jax_out):
    frames, Rs_gt, _, _ = make_sequence(n_frames=T, width=W, height=H, seed=3)
    assert frames[0].dtype == np.uint8 and frames[0].shape == (H, W)
    poses, diags = jax_run(jnp.asarray(np.stack(frames)))
    assert np.asarray(diags["pose_ok"]).mean() >= 0.7
    rot = relative_pose_error(np.asarray(poses.R, np.float64), Rs_gt)
    assert rot <= relative_pose_error(jax_out[0], scene[1]) + 1.0


def test_unported_options_raise():
    from tpu_vo_torch.configs import MatchConfig, RansacConfig

    for cfg in (VOConfig(match=MatchConfig(use_ratio_test=True)),
                VOConfig(ransac=RansacConfig(score_method="count"))):
        with pytest.raises(NotImplementedError):
            step.check_supported(cfg)


def test_runner_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """device=None means the card: without one it raises instead of
    running on the CPU; device="cpu" runs there."""
    frames = torch.zeros((2, 48, 64), dtype=torch.uint8)
    cfg = VOConfig(image_width=64, image_height=48)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_sequence_batched(frames, cfg)
    assert runner.entry_device("cpu") == torch.device("cpu")
    poses, _ = runner.run_sequence_batched(frames, cfg, device="cpu")
    assert poses.R.device.type == "cpu" and poses.R.shape == (2, 3, 3)


@pytest.mark.parametrize("n_features", [64, 128])
def test_runner_runs_at_few_keypoints(n_features):
    """N <= 128 matches: RANSAC scores every hypothesis on the full set,
    as tpu_vo does (these configs are tpu_vo's own test configs)."""
    from tpu_vo_torch.configs import ORBConfig

    frames = torch.from_numpy(np.stack(make_sequence(n_frames=3, width=320, height=240,
                                                     seed=1)[0]))
    cfg = VOConfig(image_width=320, image_height=240,
                   orb=ORBConfig(n_features=n_features, n_levels=2))
    poses, diags = runner.run_sequence_batched(frames, cfg, device="cpu")
    assert poses.R.shape == (3, 3, 3) and torch.isfinite(poses.R).all()
    assert (diags["num_keypoints"] == n_features).all()
    assert (diags["num_inliers"] > 0).all()


@pytest.fixture(scope="module")
def nine_frames():
    from tpu_vo_torch.configs import ORBConfig

    frames = torch.from_numpy(np.stack(make_sequence(n_frames=9, width=240, height=180,
                                                     seed=2)[0]))
    cfg = VOConfig(image_width=240, image_height=180,
                   orb=ORBConfig(n_features=200, n_levels=3))
    return frames, cfg, runner.run_sequence_batched(frames, cfg, device="cpu")


def _assert_same_run(a, b):
    (pa, da), (pb, db) = a, b
    assert torch.equal(pa.R, pb.R) and torch.equal(pa.t, pb.t)
    assert da.keys() == db.keys()
    for k in da:
        assert torch.equal(da[k], db[k]), k


@pytest.mark.parametrize("frame_chunk, pair_chunk", [(3, 4), (3, None), (None, 4), (9, 8)])
def test_runner_chunks_equal_the_unchunked_run(nine_frames, frame_chunk, pair_chunk):
    frames, cfg, whole = nine_frames
    assert whole[1]["pose_ok"].float().mean() >= 0.5
    _assert_same_run(runner.run_sequence_batched(frames, cfg, device="cpu",
                                                 frame_chunk=frame_chunk,
                                                 pair_chunk=pair_chunk), whole)


def test_runner_rejects_bad_chunks(nine_frames):
    frames, cfg, whole = nine_frames
    for kw in ({"frame_chunk": 0}, {"pair_chunk": -1}):
        with pytest.raises(ValueError, match="positive int"):
            runner.run_sequence_batched(frames, cfg, device="cpu", **kw)
    for kw in ({"frame_chunk": 2}, {"pair_chunk": 3}):
        with pytest.raises(ValueError, match="not divisible"):
            runner.run_sequence_batched(frames, cfg, device="cpu", **kw)
    _assert_same_run(runner.run_sequence_batched(frames, cfg, device="cpu", frame_chunk=20,
                                                 pair_chunk=21), whole)
