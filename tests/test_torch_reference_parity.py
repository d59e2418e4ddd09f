"""Parity of the port with the OpenCV reference, against the committed
data/reference_trajectories.json (tools/reference_band).

  - the file holds every leg, with a trajectory of T poses and a band of
    five reruns; regenerating the 320x240 legs (rendering, hashing and
    running the reference) gives the committed records exactly (the
    larger legs are `slow`);
  - VOConfig.reference_parity() through the port, 5 RANSAC seeds, on
    the 320x240 corridor and pan (T 16, seed 3): every seed's
    Umeyama-aligned ATE over the extent lies within max(1.15 band,
    0.01), as tests/test_reference_parity.py holds tpu_vo.

The 5 seeds share stage 1 (the features do not depend on the seed); each
seed runs stages 2 and 3 as run_sequence_batched does.
"""

import functools
import os

import numpy as np
import pytest
import torch

from tpu_vo_torch.configs import VOConfig
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.pipeline.step import pair_generators
from tpu_vo_torch.tools import reference_band
from tpu_vo_torch.utils import synthetic
from tpu_vo_torch.utils.metrics import ate_rmse_aligned
from _torch_threads import _one_thread  # noqa: F401

SEEDS = 5
LEGS = reference_band.load()


@functools.lru_cache(maxsize=None)
def _frames(name):
    scene, T, W, H, seed = reference_band.LEGS[name]
    return synthetic.render(scene, T, W, H, seed)[0]


def test_committed_file_holds_every_leg():
    assert os.path.getsize(reference_band.PATH) < 300_000
    assert list(LEGS) == list(reference_band.LEGS)
    for name, rec in LEGS.items():
        scene, T, W, H, seed = reference_band.LEGS[name]
        assert (rec["scene"], rec["T"], rec["W"], rec["H"], rec["seed"]) == (scene, T, W, H, seed)
        t, R = reference_band.leg_arrays(rec)
        assert t.shape == (T, 3) and R.shape == (T, 3, 3)
        np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                                   atol=1e-9)
        assert len(rec["rels"]) == SEEDS and rec["band"] == max(rec["rels"]) >= 0
        assert rec["extent"] > 0 and len(rec["frames_sha256"]) == 64 and rec["cv2"]


@pytest.mark.parametrize("name", reference_band.CPU_LEGS)
def test_cpu_legs_regenerate_exactly(name):
    assert reference_band.make_leg(name, _frames(name)) == LEGS[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", [n for n in reference_band.LEGS
                                  if n not in reference_band.CPU_LEGS])
def test_larger_legs_regenerate_exactly(name):
    assert reference_band.make_leg(name) == LEGS[name]


@pytest.mark.parametrize("name", reference_band.CPU_LEGS)
def test_reference_parity_five_seeds(name):
    rec = LEGS[name]
    W, H, T = rec["W"], rec["H"], rec["T"]
    frames = torch.from_numpy(np.stack(_frames(name)))
    cfg = VOConfig.reference_parity(image_width=W, image_height=H)
    feats = runner.detect_frames(frames, cfg)
    prev = ORBFeatures(*(f[:-1] for f in feats))
    cur = ORBFeatures(*(f[1:] for f in feats))
    traj_ref, _ = reference_band.leg_arrays(rec)
    tol = reference_band.parity_tolerance(rec["band"])
    rels = []
    for s in range(SEEDS):
        est = runner.estimate_pairs(prev, cur, cfg, pair_generators(s, range(1, T)))
        poses = runner.chain_relative_poses(est["R"], est["t"], est["have_rt"], est["pose_ok"],
                                            cfg)
        assert bool(torch.isfinite(poses.t).all())
        rels.append(ate_rmse_aligned(poses.t.double().numpy(), traj_ref) / rec["extent"])
    bad = [r for r in rels if r > tol]
    assert not bad, (f"{len(bad)}/{SEEDS} seeds outside the reference's band: "
                     f"rels={[round(r, 4) for r in rels]} band={rec['band']:.4f} tol={tol:.4f}")
