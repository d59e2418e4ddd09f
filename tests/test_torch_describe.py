"""The describe kernel (tpu_vo_torch.ops.describe, csrc/describe.cu)
against its plain version, features/patches' eager angles, blur and
steered rBRIEF bits.

On the CPU: the wrapper, and so orb.describe, runs the plain version with
no launch, and it refuses what the kernel does not take. On the card: the kernel equals the eager
ops bit for bit (the angles as raw float32 bits, all 256 bits) on windows
from detect_and_compute at each configuration's sizes and on crafted
windows, and launches once a detect_and_compute call. This file imports
no JAX, so its card cases run where JAX is missing:

    python3 -m pytest --noconftest tests/test_torch_describe.py -p no:cacheprovider
"""

import pytest
import torch
import torch.nn.functional as F

from tpu_vo_torch.configs import ORBConfig
from tpu_vo_torch.features import orb
from tpu_vo_torch.ops import describe as tdesc
from _torch_threads import _one_thread  # noqa: F401


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the describe kernel has no CPU mode")
    return torch.device("cuda")


def _random_windows(n, seed=0, device="cpu"):
    """(n, 43, 43) float32 windows of integer pixels 0..255."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (n, 43, 43), generator=g, dtype=torch.float32,
                         device=device)


def _crafted_windows():
    """All zero (m01 = m10 = 0), all 255, and one bright pixel on a dark
    or grey ground in each quadrant (on the diagonals m01 = +-m10) and on
    each axis, at several radii."""
    out = [torch.zeros(43, 43), torch.full((43, 43), 255.0)]
    spots = [(dy, dx) for r in (1, 5, 10) for dy, dx in
             ((r, r), (r, -r), (-r, r), (-r, -r), (0, r), (0, -r), (r, 0), (-r, 0))]
    spots += [(3, 11), (-11, 3), (14, -4), (-2, -15)]
    for ground in (0.0, 100.0):
        for dy, dx in spots:
            w = torch.full((43, 43), ground)
            w[21 + dy, 21 + dx] = 255.0
            out.append(w)
    return torch.stack(out)


def _frames(b, h, w, seed):
    """(b, h, w) uint8 frames: smooth shading plus fine noise, so that
    FAST finds corners at every level."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand(b, 1, h // 16 + 2, w // 16 + 2, generator=g)
    img = (F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False) * 200
           + torch.rand(b, 1, h, w, generator=g) * 55)
    return img[:, 0].round().clamp(0, 255).to(torch.uint8)


def _assert_same(got, want):
    ang, bits = got
    ang_ref, bits_ref = want
    assert ang.shape == ang_ref.shape and bits.shape == bits_ref.shape
    assert torch.equal(ang.view(torch.int32), ang_ref.view(torch.int32))
    assert torch.equal(bits, bits_ref)


def test_orb_describe_on_cpu_is_the_plain_version():
    raw = _random_windows(300).view(3, 100, 43, 43)
    before = tdesc.describe_windows.launches
    _assert_same(orb.describe(raw), tdesc.describe_windows_reference(raw))
    assert tdesc.describe_windows.launches == before


@pytest.mark.parametrize("shape", [(5, 43, 43), (2, 3, 43, 43), (43, 43), (2, 0, 43, 43)],
                         ids=["flat", "batched", "one", "empty"])
def test_wrapper_on_cpu_is_the_plain_version_with_no_launch(shape):
    raw = _random_windows(torch.Size(shape[:-2]).numel(), seed=3).reshape(shape)
    before = tdesc.describe_windows.launches
    got = tdesc.describe_windows(raw)
    assert tdesc.describe_windows.launches == before
    assert got[0].shape == shape[:-2] and got[1].shape == shape[:-2] + (256,)
    _assert_same(got, tdesc.describe_windows_reference(raw))


@pytest.mark.parametrize("raw, match", [
    (torch.zeros(2, 43, 43, dtype=torch.float64), "float32"),
    (torch.zeros(2, 43, 43, dtype=torch.uint8), "float32"),
    (torch.zeros(2, 43, 42), r"\(\.\.\., 43, 43\)"),
    (torch.zeros(2, 37, 37), r"\(\.\.\., 43, 43\)"),
    (torch.zeros(43), r"\(\.\.\., 43, 43\)"),
    (torch.zeros(2, 43, 43).transpose(-1, -2), "contiguous"),
    (torch.zeros(4, 43, 43)[::2], "contiguous"),
], ids=["float64", "uint8", "43x42", "37x37", "1-d", "transposed", "strided"])
def test_wrapper_refuses_what_the_kernel_does_not_take(raw, match):
    with pytest.raises(ValueError, match=match):
        tdesc.describe_windows(raw)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_one_launch_a_detect_and_compute_call_on_the_card_none_on_the_cpu(request, device):
    dev = request.getfixturevalue("cuda") if device == "cuda" else torch.device("cpu")
    frames = _frames(2, 120, 160, seed=1).to(dev)
    cfg = ORBConfig(n_features=100, n_levels=2)
    before = tdesc.describe_windows.launches
    orb.detect_and_compute(frames, cfg)
    orb.detect_and_compute(frames[0], cfg)
    assert tdesc.describe_windows.launches == before + (2 if device == "cuda" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b, h, w, n", [(2, 376, 1241, 1200), (2, 2160, 3840, 8000),
                                        (4, 480, 640, 1000)],
                         ids=["kitti_1200", "uhd_8000", "vga_1000"])
def test_kernel_equals_eager_on_detect_and_compute_windows(cuda, b, h, w, n):
    cfg = ORBConfig(n_features=n)
    used = orb.pyramid_levels(_frames(b, h, w, seed=n).to(cuda), cfg)
    kps, starts = orb.select_keypoints(used, cfg)
    ys, xs = orb.keypoint_coords(kps)
    raw = orb.keypoint_windows(used, ys, xs, starts)
    assert raw.shape == (b, n, 43, 43)
    got = tdesc.describe_windows(raw)
    torch.cuda.synchronize()
    _assert_same(got, tdesc.describe_windows_reference(raw))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 5, 4097])
def test_kernel_equals_eager_on_crafted_windows_at_every_group_tail(cuda, n):
    crafted = _crafted_windows()
    raw = torch.cat([crafted, _random_windows(max(0, n - len(crafted)), seed=n)])[:n]
    raw = raw.to(cuda)
    before = tdesc.describe_windows.launches
    got = tdesc.describe_windows(raw)
    torch.cuda.synchronize()
    assert tdesc.describe_windows.launches == before + 1
    _assert_same(got, tdesc.describe_windows_reference(raw))


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
def test_kernel_equals_eager_over_1e5_angles(cuda, aligned):
    """100,003 random windows (a tail of 3); unaligned, a view one window
    into its buffer (7,396 B, not a multiple of 16), which the kernel
    loads element by element."""
    buf = _random_windows(100_004, seed=7, device=cuda)
    raw = buf[:-1] if aligned else buf[1:]
    assert raw.is_contiguous() and (raw.data_ptr() % 16 == 0) == aligned
    got = tdesc.describe_windows(raw)
    torch.cuda.synchronize()
    _assert_same(got, tdesc.describe_windows_reference(raw))
    assert got[0].unique().numel() > 50_000  # the angles are spread


@pytest.mark.cuda
def test_empty_input_launches_nothing(cuda):
    before = tdesc.describe_windows.launches
    ang, bits = tdesc.describe_windows(torch.zeros(2, 0, 43, 43, device=cuda))
    assert ang.shape == (2, 0) and bits.shape == (2, 0, 256)
    assert tdesc.describe_windows.launches == before
