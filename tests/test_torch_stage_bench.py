"""The port's frontend stage benchmark (tpu_vo_torch.tools.stage_bench)
on the CPU at B=2, 120x160: its candidates agree with the current
implementations, the ablation's stages run, and main() needs a card
unless it is given device="cpu"."""

import pytest
import torch

from tpu_vo_torch.features import orientation
from tpu_vo_torch.image.filters import gaussian_blur
from tpu_vo_torch.tools import stage_bench as sb


@pytest.fixture(scope="module")
def frames():
    return sb.make_frames(2, 120, 160, "cpu")


@pytest.fixture(scope="module")
def levels(frames):
    return sb.make_levels(frames)


def test_topk_variants_agree(levels):
    scores = sb.scores_per_level(levels)
    out = {name: fn(scores) for name, fn in sb.topk_variants(sb._budgets(sb.CFG)).items()}
    ref = out.pop("current")
    assert sum(int((v > 0).sum()) for v, _ in ref) > 100
    for name, res in out.items():
        for (v, i), (rv, _), s in zip(res, ref, scores):
            assert torch.equal(v, rv), name
            assert torch.equal(torch.gather(s.view(s.shape[0], -1), 1, i.to(torch.int64)),
                               v), name


def test_orientation_flat_equals_prefix(levels):
    kps = sb.select_keypoints(levels)
    assert sum(int(valid.sum()) for _, _, valid in kps) > 100
    per_level = torch.cat([orientation.ic_angles_prefix(lv, ys, xs)
                           for lv, (ys, xs, _) in zip(levels, kps)], 1)
    assert torch.equal(sb.orientation_flat(levels, kps), per_level)
    assert torch.equal(sb.orientation_per_level(levels, kps), per_level)


def test_blur_matmul_within_one_level_of_shift_add(levels):
    """The two blurs sum the same taps in another order, so a value on a
    .5 boundary may round the other way: at most 1 apart."""
    for lv in levels:
        assert float((sb.gaussian_blur_matmul(lv) - gaussian_blur(lv)).abs().max()) <= 1.0


def test_ablation_stages_run(frames):
    names = []
    for name, fn in sb.ablation_stages():
        out = fn(frames)
        names.append(name)
        if name == "full":
            assert out.valid.shape == (2, sb.CFG.n_features) and out.valid.any()
        elif name == "+orientation":
            assert out.shape[0] == 2 and torch.isfinite(out).all()
    assert names == ["pyramid", "+fast", "+topk", "+harris", "+orientation", "full"]


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sb.main(["topk"])
    with pytest.raises(SystemExit):
        sb.main(["nonesuch"], device="cpu")


def test_fence_waits_only_for_cuda_tensors(monkeypatch):
    """fence walks lists, tuples, dicts and NamedTuples; CPU tensors are
    ready, so it never synchronizes for them."""
    from tpu_vo_torch.features.orb import ORBFeatures
    from tpu_vo_torch.utils import profiling

    def no_sync(device=None):
        raise AssertionError("synchronized for CPU tensors")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    t = torch.zeros(3)
    profiling.fence([t, (t, {"a": t, "b": [t, 1.0]}), ORBFeatures(*([t] * 8))])
    assert list(profiling._leaves({"a": [t, (t, "x")], "b": t})) == [t, t, t]
