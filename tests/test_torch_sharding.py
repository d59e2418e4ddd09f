"""The port's batch of sequences on one card (parallel/sharding
.run_batch_of_sequences) on the CPU: each sequence equals
run_sequence_batched(frames[b], cfg, seed + b) bit for bit, chunked and
unchunked; chunks that do not divide B*T or B*(T-1) raise before stage 1
runs. And config
5's pipeline (tools/run_benchmarks.window_refined): with no LM iteration
it is run_sequence_batched bit for bit, with 6 its poses are finite and
its refined pairs' Sampson cost no higher."""

import functools

import numpy as np
import pytest
import torch

from tpu_vo_torch.configs import ORBConfig, VOConfig
from tpu_vo_torch.parallel import sharding
from tpu_vo_torch.parallel.sharding import run_batch_of_sequences
from tpu_vo_torch.pipeline.runner import run_sequence_batched
from tpu_vo_torch.tools import run_benchmarks
from tpu_vo_torch.utils.synthetic import make_sequence
from _torch_threads import _one_thread  # noqa: F401

W, H, T, B, SEED = 160, 120, 4, 3, 7
CFG = VOConfig(image_width=W, image_height=H, orb=ORBConfig(n_features=150, n_levels=3))


@functools.lru_cache(maxsize=None)
def _frames():
    return torch.from_numpy(np.stack([np.stack(make_sequence(n_frames=T, width=W, height=H,
                                                             seed=b)[0]) for b in range(B)]))


@functools.lru_cache(maxsize=None)
def _singles():
    return [run_sequence_batched(_frames()[b], CFG, seed=SEED + b, device="cpu")
            for b in range(B)]


@pytest.mark.parametrize("frame_chunk, pair_chunk", [(None, None), (3, 3), (4, 1), (12, 9)])
def test_batch_equals_each_sequence(frame_chunk, pair_chunk):
    poses, diags = run_batch_of_sequences(_frames(), CFG, seed=SEED, frame_chunk=frame_chunk,
                                          pair_chunk=pair_chunk, device="cpu")
    assert poses.R.shape == (B, T, 3, 3) and poses.t.shape == (B, T, 3)
    for b, (p, d) in enumerate(_singles()):
        assert torch.equal(poses.R[b], p.R) and torch.equal(poses.t[b], p.t)
        assert set(diags) == set(d)
        for k in d:
            assert diags[k].shape[:2] == (B, T - 1) and torch.equal(diags[k][b], d[k]), k
    assert bool(diags["pose_ok"].any())


@pytest.mark.parametrize("frame_chunk, pair_chunk", [(5, None), (None, 4), (0, None), (None, -1)])
def test_bad_chunks_raise(frame_chunk, pair_chunk, monkeypatch):
    def stage1(*args, **kwargs):
        raise AssertionError("stage 1 ran before the chunks were checked")

    monkeypatch.setattr(sharding, "detect_frames", stage1)
    with pytest.raises(ValueError):
        run_batch_of_sequences(_frames(), CFG, frame_chunk=frame_chunk, pair_chunk=pair_chunk,
                               device="cpu")


def test_config4_chunk_ladder():
    assert run_benchmarks.chunks(8 * 64, 8 * 63) == (8, 56)
    assert run_benchmarks.chunks(4 * 16, 4 * 15) == (8, 3)
    assert run_benchmarks.chunks(3 * 5, 3 * 4) == (1, 3)


def test_window_refined_pipeline():
    frames = _frames()[0]
    want, _ = _singles()[0]
    p0 = run_benchmarks.window_refined(frames, CFG, seed=SEED, iters=0, frame_chunk=2)
    assert torch.equal(p0.R, want.R) and torch.equal(p0.t, want.t)
    p6, diags, args = run_benchmarks.window_refined(frames, CFG, seed=SEED, frame_chunk=None,
                                                    with_parts=True)
    assert p6.R.shape == (T, 3, 3) and bool(torch.isfinite(p6.t).all())
    from tpu_vo_torch.models.refinement import refine_window

    ref = refine_window(*args, iters=6)
    start = refine_window(*args, iters=0)
    assert bool((ref.cost <= start.cost).all())
