"""Config 3 of the benchmark (3840x2160, 8000 keypoints, the ratio test)
on the port, at the sizes the CPU can hold:

  - the 23-bit keys of a 2160x3840 level: a synthetic packed map whose
    keys include the level's last flat index at FAST score 255 (bit 30
    of the int32 key) decodes in the port's _rank_from_maps to the same
    (y, x, response) as tpu_vo's; idx_bits_for(2160, 3840) is 23, and
    both packages refuse a 2160x4096 level (24 + 9 bits);
  - tools/run_benchmarks.run_config for configs 3 and 7 at a cut size,
    through a patched CONFIGS, returns every field of the JAX harness's
    lines (benchmarks/run_benchmarks.py, run_config_3 and run_config_7);
  - kernels B1 and B2 at config 3's own shapes (one 2-frame chunk's
    8-level pyramid from 2160x3840, 8000 keypoints) against their plain
    versions bit for bit, on the card only.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vo.configs import ORBConfig as JORBConfig
from tpu_vo.features import orb as jorb
from tpu_vo.ops import select_pallas
from tpu_vo_torch.configs import ORBConfig
from tpu_vo_torch.features import orb
from tpu_vo_torch.image.pyramid import build_pyramid
from tpu_vo_torch.ops.patch import extract_patches_levels, extract_patches_reference
from tpu_vo_torch.ops.select import idx_bits_for, select_maps_levels, select_maps_reference
from tpu_vo_torch.tools import run_benchmarks
from tpu_vo_torch.utils import synthetic
from tpu_vo_torch.utils.metrics import scale_matched_gt
from _torch_threads import _one_thread  # noqa: F401

H4K, W4K = 2160, 3840
BITS = 23


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B1 and B2 have no CPU mode")
    return torch.device("cuda")


def _bitrev(v: int, bits: int) -> int:
    return int(format(v, f"0{bits}b")[::-1], 2)


def _packed_4k(seed: int = 0, n_keys: int = 3000):
    """(1, 1080, 3840) int32 packed map of a 2160x3840 level and its
    (1, 2160, 3840) float32 Harris map: n_keys survivors at distinct
    random pixels with random scores 11..255, plus the last flat index
    and the first pixel of the last row at score 255, each key
    (score << 23) | (mask - bitrev23(flat)) held at (y // 2, x) under
    the 2-row max."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(H4K * W4K - 1, n_keys, replace=False).tolist()
    flat += [H4K * W4K - 1, (H4K - 1) * W4K]
    score = rng.integers(11, 256, len(flat)).tolist()
    score[-2:] = [255, 255]
    mask = (1 << BITS) - 1
    packed = np.zeros((H4K // 2, W4K), np.int64)
    for f, s in zip(flat, score):
        key = (s << BITS) | (mask - _bitrev(f, BITS))
        y, x = divmod(f, W4K)
        packed[y // 2, x] = max(packed[y // 2, x], key)
    assert packed.max() < 2**31 and packed.max() >> 30 == 1  # bit 30 set, bit 31 clear
    harris = rng.standard_normal((1, H4K, W4K)).astype(np.float32)
    harris[0, -1, [0, -1]] = 100.0  # the two score-255 keys lead the Harris cut
    return packed.astype(np.int32)[None], harris


def test_idx_bits_at_4k_and_the_limit():
    assert idx_bits_for(H4K, W4K) == BITS
    with pytest.raises(ValueError):
        idx_bits_for(H4K, 4096)
    with pytest.raises(AssertionError):
        select_pallas.fused_select_maps(jax.ShapeDtypeStruct((H4K, 4096), jnp.float32), 10, 31)


@pytest.mark.parametrize("n_level", [1, 1858])
def test_23_bit_keys_decode_like_tpu_vo(n_level):
    """n_level 1858 is config 3's level-0 budget at 8000 keypoints."""
    packed, harris = _packed_4k()
    cfg = ORBConfig(n_features=8000, stage1_exact_topk=True)
    jcfg = JORBConfig(n_features=8000, stage1_exact_topk=True)
    ys, xs, resp, valid = orb._rank_from_maps(torch.from_numpy(packed), torch.from_numpy(harris),
                                              BITS, W4K, n_level, cfg, H4K * W4K)
    jys, jxs, jresp, jvalid = jorb._rank_from_maps(jnp.asarray(packed[0]), jnp.asarray(harris[0]),
                                                   BITS, W4K, n_level, jcfg, H4K * W4K)
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(jvalid))
    assert bool(valid.all())
    np.testing.assert_array_equal(ys[0].numpy(), np.asarray(jys))
    np.testing.assert_array_equal(xs[0].numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(resp[0].numpy(), np.asarray(jresp))
    # the decoded pixels are the keys' own: each response is the Harris
    # value there, and the score-255 keys, the Harris cut's best, lead it
    np.testing.assert_array_equal(resp[0].numpy(), harris[0, ys[0].numpy(), xs[0].numpy()])
    lead = set(zip(ys[0, :2].tolist(), xs[0, :2].tolist()))
    assert lead <= {(H4K - 1, W4K - 1), (H4K - 1, 0)} and len(lead) == min(n_level, 2)


def _cut(monkeypatch, n, T, W, H, kps):
    B = run_benchmarks.CONFIGS[n][4]
    monkeypatch.setitem(run_benchmarks.CONFIGS, n, (T, W, H, kps, B, run_benchmarks.CONFIGS[n][5]))
    return [synthetic.render(*run_benchmarks.scene_spec(n, b)) for b in range(B)]


def _fake_leg(frames, Rs, ts, band=0.01):
    """A leg of the cut frames with the scale-matched ground truth as its
    reference: the reference's fields come out as exact agreement."""
    t = scale_matched_gt(np.stack(ts))
    return {"frames_sha256": synthetic.frames_sha256(frames), "t": t.tolist(),
            "R": np.stack(Rs).tolist(), "band": band}


# benchmarks/run_benchmarks.py: the fields of run_config_3's line, and of
# each scene of run_config_7 (its RPE fields from utils/metrics.rpe with
# rotations)
JAX_C3 = {"config", "frames_per_sec_chip", "one_shot_wall_fps", "ref_seconds_per_frame",
          "short_sequence_caveat", "ate_vs_reference", "ate_rel_extent",
          "ate_vs_reference_aligned_rel", "ate_vs_gt", "ate_vs_gt_rel", "ref_self_ate_band",
          "parity_within_ref_band"}
RPE = ("rpe_rot_mean_deg", "rpe_rot_rmse_deg", "rpe_trans_rmse", "rpe_trans_rel_step")
JAX_C7 = {"tpu_vo_ate_vs_gt_rel", "ref_ate_vs_gt_rel", *("tpu_vo_" + k for k in RPE),
          *("ref_" + k for k in RPE)}
JAX_C7_OBJ = {"obj_kp_share_median", "obj_inlier_frac_median"}


def test_run_config_3_cut_returns_the_jax_fields(monkeypatch):
    seqs = _cut(monkeypatch, 3, 4, 320, 240, 600)
    frames, Rs, ts, _ = seqs[0]
    res = run_benchmarks.run_config(3, seqs, torch.device("cpu"),
                                    {"config3": _fake_leg(frames, Rs, ts)}, "cpu")
    assert JAX_C3 <= set(res), JAX_C3 - set(res)
    assert res["config"] == "3_highdensity_4k_8k_ratio"
    assert (res["frame_chunk"], res["pair_chunk"]) == (2, 3)
    assert res["frames_per_sec_chip"] > 0 and res["peak_mem_gib"] is None
    assert np.isfinite(res["ate_vs_gt_rel"]) and isinstance(res["parity_within_ref_band"], bool)
    assert run_benchmarks.config_cfg(3).match.use_ratio_test


def test_run_config_7_cut_returns_the_jax_fields(monkeypatch):
    seqs = _cut(monkeypatch, 7, 4, 160, 120, 300)
    legs = {f"config7_{name}": _fake_leg(s[0], s[1], s[2])
            for name, s in zip(synthetic.DYNAMIC_SCENES, seqs)}
    res = run_benchmarks.run_config(7, seqs, torch.device("cpu"), legs, "cpu")
    assert res["config"] == "7_dynamic_scene_robustness"
    assert list(res["scenes"]) == list(synthetic.DYNAMIC_SCENES)
    for name, entry in res["scenes"].items():
        want = JAX_C7 | (JAX_C7_OBJ if name.startswith("obj") else set())
        assert want <= set(entry), (name, want - set(entry))
        assert (entry["frame_chunk"], entry["pair_chunk"]) == (8, 3)
        assert entry["poses_finite"] and np.isfinite(entry["tpu_vo_ate_vs_gt_rel"])
        assert entry["ref_ate_vs_gt_rel"] == entry["ref_rpe_rot_mean_deg"] == 0.0
        if name.startswith("obj"):
            assert 0.0 <= entry["obj_inlier_frac_median"] <= 1.0
            assert 0.0 < entry["obj_kp_share_median"] <= 1.0


def test_config_7_pair_chunk_ladder():
    assert run_benchmarks.config_chunks(7, 48) == (8, 47)
    assert run_benchmarks.config_chunks(7, 64) == (8, 9)
    assert run_benchmarks.config_chunks(7, 8) == (8, 7)
    assert run_benchmarks.config_chunks(3, 8) == (2, 7)


@functools.lru_cache(maxsize=None)
def _chunk_4k():
    """One 2-frame chunk of config 3's shape: smooth blobs plus noise on
    the integer grid, so that FAST finds its 8000 keypoints."""
    rng = np.random.default_rng(3)
    small = rng.uniform(0, 255, (2, H4K // 8, W4K // 8))
    up = np.repeat(np.repeat(small, 8, 1), 8, 2)
    return np.clip(np.rint(up + rng.normal(0, 12, up.shape)), 0, 255).astype(np.uint8)


@pytest.mark.cuda
def test_b1_b2_at_config_3_shapes(cuda):
    cfg = ORBConfig(n_features=8000)
    frames = torch.from_numpy(_chunk_4k()).to(cuda)
    budgets = orb.features_per_level(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    levels = [lv.contiguous() for lv in build_pyramid(frames, cfg.n_levels, cfg.scale_factor)]
    maps = select_maps_levels(levels, cfg.fast_threshold, cfg.edge_threshold)
    assert maps[0][2] == BITS
    ys_all, xs_all, starts = [], [], [0]
    for lvl, n, (pk, hk, bk) in zip(levels, budgets, maps):
        pr, hr, br = select_maps_reference(lvl, cfg.fast_threshold, cfg.edge_threshold)
        assert bk == br and torch.equal(pk, pr) and torch.equal(hk, hr)
        ys, xs, _, _ = orb._rank_from_maps(pk, hk, bk, lvl.shape[-1], n, cfg,
                                           lvl.shape[-2] * lvl.shape[-1])
        ys_all.append(ys)
        xs_all.append(xs)
        starts.append(starts[-1] + ys.shape[1])
    assert starts[-1] == 8000
    ys, xs = torch.cat(ys_all, 1).contiguous(), torch.cat(xs_all, 1).contiguous()
    a = extract_patches_levels(levels, ys, xs, starts[:-1])
    b = torch.cat([extract_patches_reference(lv, ys[:, o:e], xs[:, o:e])
                   for lv, o, e in zip(levels, starts, starts[1:])], 1)
    assert a.shape == (2, 8000, 43, 43) and torch.equal(a, b)
