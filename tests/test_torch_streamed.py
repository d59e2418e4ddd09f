"""The port's streamed runner (pipeline/runner.run_sequence_streamed) and
its uploader (pipeline/upload.upload_ahead) on the CPU:

  - bit for bit the port's run_sequence_batched on 9 frames of 240x180
    (200 keypoints, 3 levels) however they are split into chunks: [9],
    [4, 5], [3, 3, 3] and nine of 1 (each pair keeps its generator, the
    first chunk's pair against the empty features is dropped);
  - against tpu_vo's run_sequence_streamed on make_sequence(8, 160x120)
    in chunks [4, 4], with the bars of test_torch_stream's
    test_scan_matches_tpu_vo: pose_ok, num_matches and num_keypoints
    equal, the world rotations within MAX_ROT_DIFF_DEG (the RANSAC draws
    differ: tpu_vo's PRNG keys, the port's per-pair generators); the
    matches on tpu_vo's features (see the test);
  - an error of the chunk iterator reaches the caller, an empty iterator
    raises, and with no card and no device the runner raises;
  - upload_ahead on the CPU: order, plain tensors that own their memory,
    None passed through, and the thread stopped when the caller leaves.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vo.configs import ORBConfig as JORBConfig, VOConfig as JVOConfig
from tpu_vo.features import orb as jorb
from tpu_vo.pipeline import runner as jrunner
from tpu_vo_torch import interop
from tpu_vo_torch.configs import ORBConfig, VOConfig
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.pipeline.upload import upload_ahead
from tpu_vo_torch.utils.synthetic import make_sequence
from _torch_threads import _one_thread  # noqa: F401

MAX_ROT_DIFF_DEG = 0.5


@pytest.fixture(scope="module")
def nine_frames():
    frames = np.stack(make_sequence(n_frames=9, width=240, height=180, seed=2)[0])
    cfg = VOConfig(image_width=240, image_height=180,
                   orb=ORBConfig(n_features=200, n_levels=3))
    return frames, cfg, runner.run_sequence_batched(torch.from_numpy(frames), cfg, seed=5,
                                                    device="cpu")


def _split(frames, sizes):
    ends = np.cumsum([0] + list(sizes))
    return (frames[a:e] for a, e in zip(ends, ends[1:]))


@pytest.mark.parametrize("sizes", [[9], [4, 5], [3, 3, 3], [1] * 9],
                         ids=["9", "4+5", "3+3+3", "9x1"])
def test_streamed_equals_batched(nine_frames, sizes):
    frames, cfg, (poses, diags) = nine_frames
    assert diags["pose_ok"].float().mean() >= 0.5
    p, d = runner.run_sequence_streamed(_split(frames, sizes), cfg, seed=5, device="cpu")
    assert torch.equal(p.R, poses.R) and torch.equal(p.t, poses.t)
    assert d.keys() == diags.keys()
    for k in d:
        assert torch.equal(d[k], diags[k]), k


def _rot_deg(a, b):
    c = (np.trace(np.swapaxes(a, -1, -2) @ b, axis1=-2, axis2=-1) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def test_streamed_matches_tpu_vo(monkeypatch):
    """Once with the port's own features: pose_ok and num_keypoints equal,
    the rotations within the bar. XLA:CPU's jitted pyramid rounds a few
    level-1 pixels of these frames differently from the port (ROADMAP,
    Known and accepted), which moves one match of pair 3 (24 against 23).
    Then with tpu_vo's features carried into the port's stage 1 by
    interop, so that the rest of the streamed runner is held to every bar,
    num_matches equal included."""
    W, H, orb = 160, 120, dict(n_features=150, n_levels=2)
    frames = np.stack(make_sequence(n_frames=8, width=W, height=H, seed=1)[0])
    jcfg = JVOConfig(image_width=W, image_height=H, orb=JORBConfig(**orb))
    cfg = VOConfig(image_width=W, image_height=H, orb=ORBConfig(**orb))
    jp, jd = jrunner.run_sequence_streamed(iter([frames[:4], frames[4:]]), jcfg)
    jdetect = jax.jit(jax.vmap(lambda f: jorb.detect_and_compute(f, jcfg.orb)))

    def tpu_vo_features(chunk, cfg, frame_chunk=None):
        f = jdetect(jnp.asarray(chunk.numpy()))
        return interop.features_from_numpy({k: np.asarray(v) for k, v in f._asdict().items()})

    for names, patch in ((("pose_ok", "num_keypoints"), False),
                         (("pose_ok", "num_matches", "num_keypoints"), True)):
        if patch:
            monkeypatch.setattr(runner, "detect_frames", tpu_vo_features)
        p, d = runner.run_sequence_streamed(iter([frames[:4], frames[4:]]), cfg, device="cpu")
        assert p.R.shape == (8, 3, 3) and d["pose_ok"].shape == (7,)
        for name in names:
            np.testing.assert_array_equal(d[name].numpy(), np.asarray(jd[name]),
                                          err_msg=name)
        assert d["pose_ok"].any()
        rot = _rot_deg(p.R.double().numpy(), np.asarray(jp.R, np.float64))
        assert rot.max() < MAX_ROT_DIFF_DEG, rot


def test_errors_reach_the_caller(nine_frames, monkeypatch):
    frames, cfg, _ = nine_frames

    def failing():
        yield frames[:3]
        raise OSError("frame 3 unreadable")

    with pytest.raises(OSError, match="frame 3 unreadable"):
        runner.run_sequence_streamed(failing(), cfg, device="cpu")
    with pytest.raises(ValueError, match="empty chunk iterator"):
        runner.run_sequence_streamed(iter([]), cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_sequence_streamed(iter([frames]), cfg)


def test_upload_ahead_on_the_cpu():
    arrays = [np.full((2, 3), i, np.uint8) for i in range(5)]
    items = [(i, None if i == 2 else a) for i, a in enumerate(arrays)]
    got = list(upload_ahead(iter(items), torch.device("cpu"), depth=2))
    assert [k for k, _ in got] == list(range(5)) and got[2][1] is None
    for i, t in got:
        if t is not None:
            assert t.device.type == "cpu" and torch.equal(t, torch.from_numpy(arrays[i]))
            assert t.numpy().ctypes.data != arrays[i].ctypes.data  # its own memory

    started, closed = threading.Event(), threading.Event()

    def endless():
        started.set()
        try:
            while True:
                yield None, arrays[0]
        finally:
            closed.set()

    it = upload_ahead(endless(), torch.device("cpu"), depth=2)
    next(it)
    it.close()
    assert started.is_set() and closed.wait(timeout=10), "the uploader kept running"
