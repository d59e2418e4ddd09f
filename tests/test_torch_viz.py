"""The port's viz/ (numpy rasteriser, io/jpeg.encode_rgb) against tpu_vo's
PIL-drawn viz/ on the same numpy inputs made from a seed:

  - exact: look_at; build_scene's segments and points (float64,
    atol 1e-12), colors and widths, in tpu_vo's order; clip_line_to_image
    and epipolar_line_for_click;
  - bytes equal to PIL's Image.save(format="JPEG", quality=95): encode_rgb
    on 13x17 and 48x64 images and on one 768x1024 trajectory render;
  - within one pixel (defined in `_assert_within_one_pixel`): the keypoint
    overlay, each of the 7 screenshot views of a 30-pose scene, the
    epipolar pair; and each primitive kind of viz/raster on its own
    (lines of width 1 to 3, ellipse outlines and fills);
  - save_trajectory_screenshots' file names, their decode through
    io/jpeg.decode, and False on an empty trajectory.
"""

import io
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from tpu_vo.geometry.se3 import Pose as JPose
from tpu_vo.viz import epipolar as jepi, overlay as joverlay, trajectory as jtraj
from tpu_vo_torch.api import TrajectoryViewer
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.io import jpeg
from tpu_vo_torch.viz import epipolar, overlay, raster, trajectory
from _torch_threads import _one_thread  # noqa: F401

CLEAR = (26, 26, 26)
TAGS = ["posX", "negX", "posY", "negY", "posZ", "negZ", "iso"]


def _assert_within_one_pixel(got, want, base):
    """Rasterised outputs agree within one pixel: (1) for each drawn color,
    every pixel of that color in one image lies within Chebyshev distance
    1 of a pixel of that color in the other; (2) each color's pixel count
    is within 10% of PIL's; (3) every pixel that neither image draws
    equals the input `base`."""
    got, want, base = (np.asarray(x).astype(np.int64) for x in (got, want, base))
    assert got.shape == want.shape == base.shape
    drawn_g = (got != base).any(-1)
    drawn_w = (want != base).any(-1)
    neither = ~drawn_g & ~drawn_w
    np.testing.assert_array_equal(got[neither], base[neither])
    colors = np.unique(np.concatenate([got[drawn_g], want[drawn_w]]), axis=0)
    for c in colors:
        mg = (got == c).all(-1) & drawn_g
        mw = (want == c).all(-1) & drawn_w
        for a, b in ((mg, mw), (mw, mg)):
            near = np.zeros_like(b)
            p = np.pad(b, 1)
            for dy in (0, 1, 2):
                for dx in (0, 1, 2):
                    near |= p[dy:dy + b.shape[0], dx:dx + b.shape[1]]
            assert not (a & ~near).any(), f"color {c}: {(a & ~near).sum()} pixels stray"
        assert abs(int(mg.sum()) - int(mw.sum())) <= 0.1 * mw.sum(), (c, mg.sum(), mw.sum())


def _pil_jpeg(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def _scene(n, seed=0):
    """n camera poses (R, t) in float64: a noisy forward walk, random
    rotations."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.normal(0.0, 0.1, (n, 3)) + [0.05, 0.0, 0.3], 0)
    R = np.array([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(n)]).reshape(n, 3, 3)
    R *= np.sign(np.linalg.det(R))[:, None, None]
    return R, t


@pytest.fixture(scope="module")
def scene30():
    R, t = _scene(30)
    ref = jtraj.TrajectoryRenderer()
    ref.build_scene(JPose(jnp.asarray(R), jnp.asarray(t)))
    port = trajectory.TrajectoryRenderer()
    port.build_scene(Pose(torch.from_numpy(R), torch.from_numpy(t)))
    return R, t, ref, port


def test_look_at_equals_tpu_vo():
    rng = np.random.default_rng(1)
    for _ in range(20):
        eye, center, up = rng.normal(size=(3, 3))
        R, e = trajectory.look_at(eye, center, up)
        Rj, ej = jtraj.look_at(eye, center, up)
        np.testing.assert_array_equal(R, Rj)
        np.testing.assert_array_equal(e, ej)


@pytest.mark.parametrize("n", [0, 1, 11, 30])
def test_build_scene_equals_tpu_vo(n):
    R, t = _scene(n, seed=n)
    ref = jtraj.TrajectoryRenderer()
    ref.build_scene(JPose(jnp.asarray(R.reshape(n, 3, 3)), jnp.asarray(t.reshape(n, 3))))
    port = trajectory.TrajectoryRenderer()
    port.build_scene(Pose(torch.from_numpy(R.reshape(n, 3, 3)), torch.from_numpy(t.reshape(n, 3))))
    a, b, colors, widths = port.segments
    assert a.dtype == b.dtype == np.float64 and len(a) == len(ref._segments)
    np.testing.assert_allclose(a, np.stack([s[0] for s in ref._segments]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b, np.stack([s[1] for s in ref._segments]), rtol=0, atol=1e-12)
    assert [tuple(map(int, c)) for c in colors] == [s[2] for s in ref._segments]
    assert list(widths) == [s[3] for s in ref._segments]
    p, pcolors, sizes = port.points
    assert len(p) == len(ref._points)
    if n:
        np.testing.assert_allclose(p, np.stack([q[0] for q in ref._points]), rtol=0, atol=1e-12)
    assert [tuple(map(int, c)) for c in pcolors] == [q[1] for q in ref._points]
    assert list(sizes) == [q[2] for q in ref._points]


@pytest.mark.parametrize("tag", TAGS)
def test_screenshot_views_within_one_pixel(scene30, tag):
    _, t, ref, port = scene30
    (_, eye, center, up), = [v for v in trajectory.view_eyes(t) if v[0] == tag]
    got = port.render(eye, center, up)
    assert got.shape == (768, 1024, 3) and got.dtype == np.uint8
    base = np.empty_like(got)
    base[:] = CLEAR
    _assert_within_one_pixel(got, ref.render(eye, center, up), base)


@pytest.mark.parametrize("shape", [(13, 17), (48, 64)])
def test_encode_rgb_writes_pil_bytes(shape):
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    img[2:9, 3:11] = (0, 255, 0)  # a flat patch: long zero runs
    assert jpeg.encode_rgb(img, 95) == _pil_jpeg(img)


def test_encode_rgb_of_a_render_writes_pil_bytes(scene30):
    _, t, _, port = scene30
    img = port.render(*trajectory.view_eyes(t)[-1][1:])
    data = jpeg.encode_rgb(img, 95)
    assert data == _pil_jpeg(img)
    assert jpeg.decode(data).shape == (768, 1024, 3)


def test_save_trajectory_screenshots(tmp_path):
    n = 25
    ts = np.cumsum(np.tile([[0.1, 0.0, 0.05]], (n, 1)), axis=0)
    poses = Pose(torch.eye(3, dtype=torch.float64).expand(n, 3, 3), torch.from_numpy(ts))
    out = str(tmp_path / "shots")
    assert trajectory.save_trajectory_screenshots(poses, out)
    files = sorted(os.listdir(out))
    assert files == sorted(f"trajectory_view_from_{t}.jpg" for t in TAGS)
    renderer = trajectory.TrajectoryRenderer()
    renderer.build_scene(poses)
    for tag, eye, center, up in trajectory.view_eyes(ts)[::3]:  # posX, negY, iso
        with open(os.path.join(out, f"trajectory_view_from_{tag}.jpg"), "rb") as f:
            data = f.read()
        img = renderer.render(eye, center, up)
        assert data == jpeg.encode_rgb(img, 95)
        assert (np.abs(img.astype(int) - 26).max(axis=-1) > 30).mean() > 0.001
    assert jpeg.decode(data).shape == (768, 1024, 3)
    empty = Pose(torch.zeros((0, 3, 3)), torch.zeros((0, 3)))
    assert not trajectory.save_trajectory_screenshots(empty, str(tmp_path / "s"))
    assert not TrajectoryViewer().save_trajectory_screenshots([], str(tmp_path / "s"))


def test_viewer_render_step_equals_tpu_vo_renderer():
    """TrajectoryViewer.render_step: tpu_vo's eye and center (the float32
    mean of the centers) over the trajectory so far."""
    R, t = _scene(12, seed=5)
    poses = [Pose(torch.from_numpy(r.astype(np.float32)), torch.from_numpy(c.astype(np.float32)))
             for r, c in zip(R, t)]
    viewer = TrajectoryViewer()
    assert viewer.render_step([]) is None
    got = viewer.render_step(poses)
    assert got is viewer.last_frame and not viewer.should_quit()
    ref = jtraj.TrajectoryRenderer()
    ref.build_scene(JPose(jnp.asarray(R.astype(np.float32)), jnp.asarray(t.astype(np.float32))))
    center = t.astype(np.float32).mean(axis=0)
    eye = center + np.array([0.2, -0.5, -1.0]) * 10
    base = np.empty_like(got)
    base[:] = CLEAR
    _assert_within_one_pixel(got, ref.render(eye, center, np.array([0.0, -1.0, 0.0])), base)


def _features(n, seed, h, w):
    rng = np.random.default_rng(seed)
    return SimpleNamespace(
        xy=np.stack([rng.uniform(-5, w + 5, n), rng.uniform(-5, h + 5, n)], 1).astype(np.float32),
        size=(31.0 * 1.2 ** rng.integers(0, 8, n)).astype(np.float32),
        angle=rng.uniform(0, 360, n).astype(np.float32),
        valid=rng.uniform(size=n) < 0.8)


@pytest.mark.parametrize("rgb", [False, True])
def test_overlay_within_one_pixel(rgb):
    h, w = 120, 160
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (h, w, 3) if rgb else (h, w), dtype=np.uint8)
    before = img.copy()
    feats = _features(150, 7, h, w)
    got = overlay.draw_keypoints_overlay(img, feats)
    want = joverlay.draw_keypoints_overlay(img, feats)
    base = img if rgb else np.stack([img] * 3, -1)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    _assert_within_one_pixel(got, want, base)
    # tensors are accepted as they are, the image untouched
    tfeats = SimpleNamespace(**{k: torch.from_numpy(np.asarray(v)) for k, v in vars(feats).items()})
    np.testing.assert_array_equal(overlay.draw_keypoints_overlay(torch.from_numpy(img), tfeats),
                                  got)
    np.testing.assert_array_equal(img, before)


def test_clip_line_and_click_line_equal_tpu_vo():
    rng = np.random.default_rng(3)
    lines = list(rng.normal(size=(200, 3)) * [1, 1, 50])
    lines += [[0.0, 1.0, -5.0], [0.0, 1.0, -100.0], [1.0, 1.0, -2.0], [1.0, 1.0, -6.0],
              [1.0, 0.0, -1.0], [1e-13, 1.0, -3.0]]
    for line in lines:
        for one_based in (True, False):
            assert (epipolar.clip_line_to_image(line, 10, 8, one_based=one_based)
                    == jepi.clip_line_to_image(line, 10, 8, one_based=one_based))
    F = rng.normal(size=(3, 3))
    for side in ("left", "right"):
        x, y = rng.uniform(0, 100, 2)
        np.testing.assert_array_equal(epipolar.epipolar_line_for_click(F, side, x, y),
                                      jepi.epipolar_line_for_click(F, side, x, y))


@pytest.mark.parametrize("convention,thickness", [("opencv_0based", 2), ("matlab_1based", 1),
                                                  ("opencv_0based", 3)])
def test_epipolar_pair_within_one_pixel(convention, thickness):
    from test_geometry import make_two_view_scene
    from tpu_vo.geometry import epipolar as jgeo

    rng = np.random.default_rng(11)
    K, R, t, X, x1, x2 = make_two_view_scene(rng, n=10, w=200, h=150)
    F = np.asarray(jgeo.fundamental_from_essential(
        jgeo.essential_from_Rt(jnp.asarray(R), jnp.asarray(t)), jnp.asarray(K)))
    left = rng.integers(0, 256, (150, 200), dtype=np.uint8)
    right = rng.integers(0, 256, (140, 190, 3), dtype=np.uint8)
    clicks = [("left", float(x1[k, 0]), float(x1[k, 1])) for k in range(3)]
    clicks += [("right", float(x2[k, 0]), float(x2[k, 1])) for k in range(3, 6)]
    got = epipolar.render_epipolar_pair(left, right, F, clicks, convention,
                                        color=(255, 0, 0), thickness=thickness)
    want = jepi.render_epipolar_pair(left, right, F, clicks, convention,
                                     color=(255, 0, 0), thickness=thickness)
    base = np.zeros_like(want)
    base[:150, :200] = left[..., None]
    base[:140, 200:] = right
    _assert_within_one_pixel(got, want, base)
    with pytest.raises(ValueError, match="convention"):
        epipolar.render_epipolar_pair(left, right, F, clicks, "pixels")


def test_epipolar_viewer_without_gui_returns_1(monkeypatch, capsys):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    img = np.zeros((8, 8), np.uint8)
    assert epipolar.run_epipolar_viewer(img, img, np.eye(3)) == 1
    assert "no GUI" in capsys.readouterr().out


def _pil_draw(h, w, fn):
    im = Image.new("RGB", (w, h), CLEAR)
    fn(ImageDraw.Draw(im))
    return np.asarray(im)


@pytest.mark.parametrize("width", [1, 2, 3])
def test_raster_lines_within_one_pixel(width):
    """Lines from inside and far outside the image, short and long, each
    color its own primitive, drawn in order over each other."""
    h, w = 60, 80
    rng = np.random.default_rng(width)
    start = rng.uniform(0, 80, (20, 2))
    short = np.concatenate([start, start + rng.integers(-4, 5, (20, 2))], 1)
    xy = np.concatenate([rng.uniform(-40, 120, (40, 4)), rng.integers(-3, 83, (40, 4)), short])
    colors = rng.integers(0, 256, (len(xy), 3), dtype=np.uint8)

    def draw(d):
        for line, c in zip(xy, colors):
            d.line(list(line), fill=tuple(int(v) for v in c), width=width)

    got = np.empty((h, w, 3), np.uint8)
    got[:] = CLEAR
    p, r, c = raster.line_pixels(xy, width, h, w)
    raster.paint(got, p, r, c, colors[p])
    base = np.empty_like(got)
    base[:] = CLEAR
    _assert_within_one_pixel(got, _pil_draw(h, w, draw), base)


@pytest.mark.parametrize("fill", [False, True])
def test_raster_ellipses_within_one_pixel(fill):
    h, w = 70, 90
    rng = np.random.default_rng(int(fill))
    c = rng.uniform(-10, 100, (60, 2))
    r = np.concatenate([rng.uniform(0, 30, 40), np.full(20, 2.5)])
    boxes = np.stack([c[:, 0] - r, c[:, 1] - r / 2, c[:, 0] + r, c[:, 1] + r / 2], 1)
    boxes[::3, 1], boxes[::3, 3] = c[::3, 1] - r[::3], c[::3, 1] + r[::3]
    colors = rng.integers(0, 256, (len(boxes), 3), dtype=np.uint8)

    def draw(d):
        for box, col in zip(boxes, colors):
            col = tuple(int(v) for v in col)
            if fill:
                d.ellipse(list(box), fill=col)
            else:
                d.ellipse(list(box), outline=col, width=1)

    got = np.empty((h, w, 3), np.uint8)
    got[:] = CLEAR
    p, rr, cc = raster.ellipse_pixels(boxes, fill, h, w)
    raster.paint(got, p, rr, cc, colors[p])
    base = np.empty_like(got)
    base[:] = CLEAR
    _assert_within_one_pixel(got, _pil_draw(h, w, draw), base)
