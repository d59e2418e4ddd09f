"""The port's dynamic corridor (utils/synthetic.make_dynamic_corridor_sequence,
config 7's scenes) against tpu_vo's, and the port's RANSAC on it, as
tests/test_dynamic_scenes.py holds tpu_vo:

  - the port's scene against tpu_vo's at 160x120, T 4, with the moving
    object, two occluders and a low-texture span: poses and K equal bit
    for bit, frames within one grey level on at most 0.2% of the pixels
    (the corridor's own bound, tests/test_torch_synthetic.py), object
    masks equal on at least 99.5% of the pixels;
  - the generator's determinism, mask coverage, static baseline and
    low-texture span (tests/test_dynamic_scenes.py, the generator tests);
  - render_range: any frame range of a scene equals that range of the
    whole sequence, bit for bit, and submit_render's ranges join to it;
  - RANSAC excludes the moving object (320x240, 900 keypoints, 192
    hypotheses, pair (4, 5)) at tpu_vo's bars on at least as many of 24
    draws as tpu_vo does, and the occluder scene keeps its pose chain
    (320x240, T 8, 600 keypoints, 128 hypotheses) at tpu_vo's bars;
  - the committed reference file keeps every earlier leg byte for byte.
"""

import concurrent.futures
import functools
import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vo.utils import synthetic as js
from tpu_vo_torch.configs import ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.features.orb import ORBFeatures, detect_and_compute
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.pipeline.step import estimate_pair, pair_generators
from tpu_vo_torch.tools import reference_band
from tpu_vo_torch.utils import synthetic as ts
from tpu_vo_torch.utils.metrics import ate_rmse, extent, scale_matched_gt

W, H, T = 160, 120, 4
MAX_DIFF_SHARE = 0.002   # tests/test_torch_synthetic.py
MIN_MASK_AGREE = 0.995
NUISANCES = dict(obj_size=1.6, n_occluders=2, low_texture_span=(2.0, 6.0))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (see
    tests/test_torch_reference_parity.py: xdist workers' thread pools
    collide otherwise); nothing here depends on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _port(seed=0, **kw):
    return ts.make_dynamic_corridor_sequence(n_frames=T, width=W, height=H, seed=seed, **kw)


def test_dynamic_corridor_matches_tpu_vo():
    fj, Rj, tj, Kj, mj = js.make_dynamic_corridor_sequence(n_frames=T, width=W, height=H,
                                                           **NUISANCES)
    ft, Rt, tt, Kt, mt = _port(**NUISANCES)
    assert len(Rt) == len(tt) == len(ft) == len(mt) == T
    for a, b in zip(Rj + tj + [Kj], Rt + tt + [Kt]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    a, b = np.stack(fj).astype(np.int32), np.stack(ft).astype(np.int32)
    assert b.shape == (T, H, W) and np.stack(ft).dtype == np.uint8
    d = np.abs(a - b)
    assert d.max() <= 1 and (d > 0).mean() <= MAX_DIFF_SHARE, (d.max(), (d > 0).mean())
    ma, mb = np.stack(mj), np.stack(mt)
    assert mb.dtype == bool and mb.shape == (T, H, W) and ma.any()
    assert (ma == mb).mean() >= MIN_MASK_AGREE, (ma == mb).mean()


def test_generator_deterministic_and_composable():
    a = _port(**NUISANCES)
    ts._corridor_textures.cache_clear()  # the second render builds its own textures
    b = ts.make_dynamic_corridor_sequence(n_frames=T, width=W, height=H, **NUISANCES)
    np.testing.assert_array_equal(np.stack(a[0]), np.stack(b[0]))
    np.testing.assert_array_equal(np.stack(a[4]), np.stack(b[4]))


def test_moving_object_mask_tracks_size():
    """Pixel coverage grows with obj_size and the mask marks the object."""
    covs = [np.mean([mi.mean() for mi in _port(obj_size=s)[4]]) for s in (1.2, 2.4)]
    assert 0.01 < covs[0] < covs[1] < 0.6
    f0, _, _, _, m0 = _port(obj_size=2.4)
    fb, _, _, _, mb = _port(obj_size=0.0)
    assert not any(mi.any() for mi in mb)
    on = m0[2]
    assert (f0[2][on] != fb[2][on]).mean() > 0.5


def test_no_object_matches_plain_corridor():
    """With every nuisance off the generator renders the plain corridor."""
    fd, Rd, td, Kd, _ = _port(seed=3)
    fc, Rc, tc, Kc = ts.make_corridor_sequence(n_frames=T, width=W, height=H, seed=3)
    np.testing.assert_array_equal(np.stack(fd), np.stack(fc))
    np.testing.assert_allclose(np.stack(td), np.stack(tc))


def test_low_texture_span_blanks_walls():
    f = _port(low_texture_span=(1.0, 14.0))[0]
    fb = _port(obj_size=0.0)[0]
    assert f[2].std() < 0.7 * fb[2].std()
    # the span edits a copy: the cached walls, and so the plain scene, keep their texture
    np.testing.assert_array_equal(np.stack(_port()[0]), np.stack(fb))


@pytest.mark.parametrize("scene,seed", [("corridor", 3), ("dynamic_obj_light", 0)])
def test_render_range_equals_the_whole_sequence(scene, seed, monkeypatch):
    whole = ts.render(scene, T, W, H, seed)
    part = ts.render_range(scene, T, W, H, seed, 1, 3)
    assert len(part[0]) == 2 and len(part) == len(whole)
    np.testing.assert_array_equal(np.stack(part[0]), np.stack(whole[0][1:3]))
    for a, b in zip(part[1] + part[2] + [part[3]], whole[1] + whole[2] + [whole[3]]):
        assert np.array_equal(a, b)
    if len(whole) == 5:
        np.testing.assert_array_equal(np.stack(part[4]), np.stack(whole[4][1:3]))
    monkeypatch.setattr(ts, "RANGE_PIXELS", 3 * W * H)  # ranges of 3 frames: [0, 3), [3, 4)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = ts.submit_render(pool, scene, T, W, H, seed)
        joined = ts.join_ranges([f.result() for f in futures])
    assert len(futures) == 2
    assert ts.frames_sha256(joined[0]) == ts.frames_sha256(whole[0])
    if len(whole) == 5:
        np.testing.assert_array_equal(np.stack(joined[4]), np.stack(whole[4]))


def _gt_relative(R1, t1, R2, t2):
    """x_c2 = R x_c1 + t from camera->world poses."""
    return R2.T @ R1, R2.T @ (t1 - t2)


def _rot_angle_deg(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


DRAWS = 24  # RANSAC draws of pair (4, 5) in each package


def _exclusion_bars(obj_match, valid, inliers, R, R_gt, pose_ok):
    """tests/test_dynamic_scenes.py::test_ransac_excludes_moving_object's
    bars on one draw: at least 30 inliers, at least 100 keypoints on the
    object, at most 15% of the inliers on it, pose_ok and a rotation
    within 1 degree of the truth."""
    n_inl = int(inliers.sum())
    return (n_inl >= 30 and int((obj_match & valid).sum()) >= 100
            and int((inliers & obj_match).sum()) / max(n_inl, 1) <= 0.15
            and bool(pose_ok) and _rot_angle_deg(np.asarray(R, np.float64), R_gt) < 1.0)


def _on_object(xy, mask, Wx, Hx):
    x = np.clip(np.round(xy[:, 0]).astype(int), 0, Wx - 1)
    y = np.clip(np.round(xy[:, 1]).astype(int), 0, Hx - 1)
    return mask[y, x]


def test_ransac_excludes_moving_object():
    """The exclusion test of tests/test_dynamic_scenes.py (320x240, 900
    keypoints, 192 hypotheses, pair (4, 5), where the object swings
    fastest) at its bars, on DRAWS RANSAC draws in each package: tpu_vo
    with PRNGKey(k) on its own frames, the port with pair_generators(k,
    [5]) on its own. One draw is not a test of either: tpu_vo meets the
    bars with keys 0, 9, 15 and 18 of 24 (its own test passes on key 0),
    and on the other 20 keeps 14-15 object matches among 70-75 inliers
    with a rotation 2.3-5.8 degrees off; the port behaves alike. So the
    port must meet every bar on at least as many draws as tpu_vo, and on
    its runner's draw (seed 0) the bars that every draw meets hold."""
    from tpu_vo.configs import ORBConfig as JORBConfig, RansacConfig as JRansacConfig
    from tpu_vo.configs import VOConfig as JVOConfig
    from tpu_vo.features.orb import detect_and_compute as jdetect
    from tpu_vo.pipeline.step import estimate_pair as jestimate

    Wx, Hx, i, j = 320, 240, 4, 5
    scene = dict(n_frames=6, width=Wx, height=Hx, obj_size=1.2, obj_period=9.0)
    jf, _, _, _, jm = js.make_dynamic_corridor_sequence(**scene)
    frames, Rs, tw, _, masks = ts.make_dynamic_corridor_sequence(**scene)
    R_gt, _ = _gt_relative(Rs[i], tw[i], Rs[j], tw[j])

    with jax.enable_x64(False):
        jcfg = JVOConfig(image_width=Wx, image_height=Hx, orb=JORBConfig(n_features=900),
                         ransac=JRansacConfig(max_iters=192))
        detect = jax.jit(lambda f: jdetect(f, jcfg.orb))
        ja, jb = detect(jnp.asarray(jf[i])), detect(jnp.asarray(jf[j]))
        estimate = jax.jit(lambda a, b, k: jestimate(a, b, k, jcfg))
        jax_ok = []
        for k in range(DRAWS):
            e = estimate(ja, jb, jax.random.PRNGKey(k))
            obj = (_on_object(np.asarray(ja.xy), jm[i], Wx, Hx)
                   | _on_object(np.asarray(jb.xy)[np.asarray(e["match_train_idx"])], jm[j], Wx, Hx))
            jax_ok.append(_exclusion_bars(obj, np.asarray(ja.valid), np.asarray(e["match_mask"]),
                                          e["R"], R_gt, e["pose_ok"]))

    cfg = VOConfig(image_width=Wx, image_height=Hx, orb=ORBConfig(n_features=900),
                   ransac=RansacConfig(max_iters=192))
    feats = detect_and_compute(torch.from_numpy(np.stack([frames[i], frames[j]])), cfg.orb)
    fa, fb = (ORBFeatures(*(f[k:k + 1] for f in feats)) for k in (0, 1))
    xy_a, xy_b, valid = fa.xy[0].double().numpy(), fb.xy[0].double().numpy(), fa.valid[0].numpy()
    port_ok = []
    for k in range(DRAWS):
        e = estimate_pair(fa, fb, cfg, generators=pair_generators(k, [j]))
        obj = (_on_object(xy_a, masks[i], Wx, Hx)
               | _on_object(xy_b[e["match_train_idx"][0].numpy()], masks[j], Wx, Hx))
        inliers = e["match_mask"][0].numpy()
        port_ok.append(_exclusion_bars(obj, valid, inliers, e["R"][0].double().numpy(), R_gt,
                                       e["pose_ok"][0]))
        if k == 0:
            assert int(inliers.sum()) >= 30 and bool(e["pose_ok"][0])
            n_obj = int((obj & valid).sum())
            assert n_obj >= 100, f"object owns only {n_obj} keypoints - too easy"
    assert sum(jax_ok) >= 1, "tpu_vo met the bars on no draw"
    assert sum(port_ok) >= sum(jax_ok), (
        f"the port meets the exclusion bars on {sum(port_ok)} of {DRAWS} draws, tpu_vo on "
        f"{sum(jax_ok)}")


def test_occluders_do_not_break_pose():
    """tests/test_dynamic_scenes.py::test_occluders_do_not_break_pose on the
    port: ATE under 5% of the extent and every pair with pose_ok."""
    Wx, Hx = 320, 240
    frames, _, tw, _, _ = ts.make_dynamic_corridor_sequence(n_frames=8, width=Wx, height=Hx,
                                                            n_occluders=3)
    cfg = VOConfig(image_width=Wx, image_height=Hx, orb=ORBConfig(n_features=600),
                   ransac=RansacConfig(max_iters=128))
    poses, diags = runner.run_sequence_batched(torch.from_numpy(np.stack(frames)), cfg,
                                               device="cpu", frame_chunk=4, pair_chunk=7)
    gt = scale_matched_gt(np.stack(tw))
    rel = ate_rmse(poses.t.double().numpy(), gt) / extent(gt)
    assert rel < 0.05, f"occluder-scene ATE {rel:.3f} of extent"
    assert bool(diags["pose_ok"].all())


# sha256 of each earlier leg's record (json, sorted keys, compact), as
# committed before config 6's legs were added (config 3's and config 7's
# since they were made)
EARLIER_LEGS = {
    "cpu_corridor_320x240": "6f8ed672ca18db3dc1e989a53e5366cd165c7b12de072debb85c678520aadf36",
    "cpu_pan_320x240": "51c7bb05f1617014ca313d86393891007af1b6912ce86b57fe556af9d114ca66",
    "card_corridor_640x480": "c2d0d4e603d5dbd09a8138efd6da53fdca43c82a527622733633630f15778ee3",
    "card_corridor_1241x376": "e967a540b569a7f071e4489e7977c9948c8401d61a3c803ce4502af390c1c47e",
    "config1": "cba553284bb3ad4cf792aadaad520bd008a21dfb8bbc16ce4d1ce84c24bf1fef",
    "config2": "63cc7d6dfa3384b07d083d7208ee8831e46531bc056ceaf9a5ebbbbadd6870f9",
    "config4_seq0": "77b10c38d289267fa4858d4b208c65c15f9134d4121f946069248ff1c9e082ed",
    "config5": "446a6308fd58f1e803e68cc3198a8b8f50efeb31f7e7d6f223acb9b6374b1162",
    "config3": "55c653ee6410eac648bc768032fa83d56a1eb81846070a841e85f8f1afa17f6e",
    "config7_obj_light": "87ef3487e53d2d157ec801dd8475a7548e181271ae3b5db1ae77b844c7368509",
    "config7_obj_mid": "0c417e3ef89409876741bdc80e9804f75e8d517824837d9dfa5847a527d19d2a",
    "config7_obj_heavy": "bd4aa4a0f2d5726d81f625078db14dfc239e87e6e7b8256df786292ffbe05a60",
    "config7_occluders": "f6154d1fa1200ab172ab8548b88080a1473d8d0b078e9c709df0fd1aefaac457",
    "config7_low_texture": "718e2780aefe90358166b4f9c29f97cfc0fbe90f92ede6cad4b972598aaf5cd2",
}
NEW_LEGS = {f"config6_{scene}_{level}": spec for scene, spec in (
    ("corridor", ("corridor", 48, 640, 480, 0)), ("pan", ("pan", 32, 320, 240, 0)))
    for level in ts.NUISANCE_LEVELS}
# the accuracy diagnostics' legs, added after config 6's
DIAG_LEGS = {"diag_pan_320x240", "diag_corridor_320x240", "diag_pan_only_noise",
             "diag_pan_only_exposure", "diag_pan_only_blur", "diag_pan_only_jpeg",
             "diag_planes_640x480"}


def test_earlier_legs_unchanged_and_new_legs_present():
    legs = reference_band.load()
    for name, want in EARLIER_LEGS.items():
        rec = json.dumps(legs[name], sort_keys=True, separators=(",", ":")).encode()
        assert hashlib.sha256(rec).hexdigest() == want, name
    assert set(legs) == set(EARLIER_LEGS) | set(NEW_LEGS) | DIAG_LEGS
    for name, spec in NEW_LEGS.items():
        assert reference_band.LEGS[name] == spec
        assert len(legs[name]["t"]) == spec[1] and legs[name]["cv2"]
