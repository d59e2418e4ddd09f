"""The port's IO and host-side utilities against tpu_vo's, on files and
inputs the tests make themselves:

  - io/dataset: the PNG decoder against PIL and tpu_vo's PIL-based
    load_frame, bit for bit: gray, RGB and RGBA, each row filter forced,
    and a file PIL writes with its own filters; a progressive JPEG and a
    baseline one whose frame header says arithmetic-coded (SOF9) equal
    tpu_vo's load_frame; what the reader refuses (12-bit, lossless,
    hierarchical and CMYK JPEG, a corrupt PNG) raises naming the file and
    the reason; listing and timestamps;
  - io/trajectory_io: the TUM and KITTI files equal tpu_vo's text, and
    read back;
  - image/color, utils/records, utils/metrics: equal to tpu_vo's.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from tpu_vo.geometry.se3 import Pose as JPose
from tpu_vo.image import color as jcolor
from tpu_vo.io import dataset as jdataset, trajectory_io as jtraj
from tpu_vo.pipeline.step import VOStepOutput as JVOStepOutput
from tpu_vo.utils import metrics as jmetrics, records as jrecords
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.image import color
from tpu_vo_torch.io import dataset, trajectory_io
from tpu_vo_torch.pipeline.step import VOStepOutput
from tpu_vo_torch.utils import metrics, records

CHANNELS = {"gray": 1, "rgb": 3, "rgba": 4}


def _image(channels, seed=0, h=13, w=17):
    """Random pixels with flat runs, so that every filter meets equal and
    unequal neighbours."""
    rng = np.random.default_rng(seed)
    shape = (h, w) if channels == 1 else (h, w, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[3:6, 2:9] = img[3, 2]
    return img


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("kind", CHANNELS)
def test_png_decoder_matches_pil(tmp_path, kind, filter_type):
    img = _image(CHANNELS[kind], seed=filter_type)
    path = str(tmp_path / f"{kind}.png")
    dataset.write_png(path, img, filter_type)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(dataset.decode_png(path), img)
    for gray in (True, False):
        np.testing.assert_array_equal(dataset.load_frame(path, gray),
                                      jdataset.load_frame(path, gray))


def test_png_written_by_pil(tmp_path):
    """PIL picks each row's filter itself (and writes RGBA unpremultiplied)."""
    from tpu_vo_torch.utils.synthetic import make_sequence

    frame = make_sequence(n_frames=1, width=97, height=61, seed=0)[0][0]
    for name, img in (("gray", frame), ("rgb", _image(3, 5, 61, 97)),
                      ("rgba", _image(4, 6, 61, 97))):
        path = str(tmp_path / f"{name}.png")
        Image.fromarray(img).save(path)
        np.testing.assert_array_equal(dataset.decode_png(path), img)
        np.testing.assert_array_equal(dataset.load_frame(path), jdataset.load_frame(path))


def _with_sof(data: bytes, marker: int, precision: int = 8) -> bytes:
    """A JPEG's bytes with its frame header's marker and precision replaced."""
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([marker]) + data[i + 2:i + 4] + bytes([precision]) + data[i + 5:]


@pytest.mark.parametrize("name", ["a.jpg", "b.jpg"])
def test_progressive_and_arithmetic_jpeg_match_tpu_vo(tmp_path, name):
    """a.jpg is PIL's progressive file; b.jpg is a baseline file whose
    frame header says SOF9, so its Huffman-coded data decodes as
    arithmetic-coded data: equal to tpu_vo's load_frame where PIL reads
    it, a ValueError naming the file where PIL raises."""
    rgb = _image(3, h=21, w=19)
    path = str(tmp_path / name)
    if name == "a.jpg":
        Image.fromarray(rgb).save(path, progressive=True)
    else:
        Image.fromarray(rgb).save(tmp_path / "base.jpg")
        open(path, "wb").write(_with_sof(open(tmp_path / "base.jpg", "rb").read(), 0xC9))
    for gray in (True, False):
        try:
            want = jdataset.load_frame(path, gray)
        except OSError:
            with pytest.raises(ValueError, match=name):
                dataset.load_frame(path, gray)
            continue
        np.testing.assert_array_equal(dataset.load_frame(path, gray), want)


def test_unsupported_images_raise_naming_the_file(tmp_path):
    rgb = _image(3, h=21, w=19)
    Image.fromarray(rgb).save(tmp_path / "base.jpg")
    base = open(tmp_path / "base.jpg", "rb").read()
    cases = {"c.jpg": ("12-bit", lambda p: open(p, "wb").write(_with_sof(base, 0xC1, 12))),
             "e.jpg": ("lossless", lambda p: open(p, "wb").write(_with_sof(base, 0xC3))),
             "f.jpg": ("CMYK", lambda p: Image.fromarray(_image(4), "CMYK").save(p)),
             "g.jpg": ("hierarchical", lambda p: open(p, "wb").write(_with_sof(base, 0xC5))),
             "h.jpg": ("lossless arithmetic", lambda p: open(p, "wb").write(_with_sof(base, 0xCB))),
             "i.jpg": ("hierarchical", lambda p: open(p, "wb").write(_with_sof(base, 0xCD)))}
    for name, (why, write) in cases.items():
        path = str(tmp_path / name)
        write(path)
        with pytest.raises(ValueError, match=f"{name}.*{why}"):
            dataset.load_frame(path)
    path = str(tmp_path / "d.png")
    dataset.write_png(path, _image(1))
    data = bytearray(open(path, "rb").read())
    data[40] ^= 1  # inside the IDAT chunk
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="d.png.*CRC"):
        dataset.load_frame(path)


def test_listing_and_timestamps_match_tpu_vo(tmp_path):
    for n in ["b.PNG", "a.jpg", "c.jpeg", "d.txt", "e.png.bak", "0010.png", "0002.png",
              "1.5e3x.png", "-.5.png", "abc.png"]:
        (tmp_path / n).write_text("x")
    os.makedirs(tmp_path / "sub.png")
    paths = dataset.list_image_paths(str(tmp_path))
    assert paths == jdataset.list_image_paths(str(tmp_path))
    assert [dataset.parse_timestamp(p, i) for i, p in enumerate(paths)] == \
        [jdataset.parse_timestamp(p, i) for i, p in enumerate(paths)]
    assert dataset.autodetect_dataset("x") == "x"


def _poses(n=6, seed=0):
    rng = np.random.default_rng(seed)
    Rs = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        Rs.append(q * np.sign(np.linalg.det(q)))
    Rs = np.stack(Rs)
    Rs[0] = np.diag([1.0, -1.0, -1.0])  # a rotation by pi: the x-largest quaternion branch
    return Rs, rng.normal(size=(n, 3))


def test_trajectory_files_match_tpu_vo(tmp_path):
    R, t = _poses()
    stamps = 0.1 * np.arange(len(t))
    for name, save in (("tum", lambda p, pose, sv: sv.save_trajectory_tum(p, pose, stamps)),
                       ("kitti", lambda p, pose, sv: sv.save_trajectory_kitti(p, pose))):
        mine, ref = str(tmp_path / f"{name}.txt"), str(tmp_path / f"{name}_ref.txt")
        save(mine, Pose(torch.from_numpy(R), torch.from_numpy(t)), trajectory_io)
        save(ref, JPose(jnp.asarray(R), jnp.asarray(t)), jtraj)
        assert open(mine).read() == open(ref).read()
    ts, back = trajectory_io.load_trajectory_tum(str(tmp_path / "tum.txt"))
    np.testing.assert_allclose(ts, stamps)
    np.testing.assert_allclose(back.R.numpy(), R, atol=1e-6)
    np.testing.assert_allclose(back.t.numpy(), t, atol=1e-6)
    back = trajectory_io.load_trajectory_kitti(str(tmp_path / "kitti.txt"))
    np.testing.assert_allclose(back.R.numpy(), R, atol=1e-6)
    path = str(tmp_path / "t.npz")
    trajectory_io.save_trajectory_npz(path, Pose(torch.from_numpy(R), torch.from_numpy(t)),
                                      {"pose_ok": torch.ones(len(t), dtype=torch.bool)})
    with np.load(path) as z:
        np.testing.assert_array_equal(z["R"], R)
        assert z["diag_pose_ok"].all()


def test_color_matches_tpu_vo():
    img = np.random.default_rng(0).integers(0, 256, (2, 9, 11, 3), dtype=np.uint8)
    t = torch.from_numpy(img)
    for name in ("bgr_to_gray", "rgb_to_gray", "ensure_gray"):
        np.testing.assert_array_equal(getattr(color, name)(t).numpy(),
                                      np.asarray(getattr(jcolor, name)(jnp.asarray(img))))
    np.testing.assert_array_equal(color.ensure_gray(t[0, ..., 0]).numpy(), img[0, ..., 0])


def _outputs(seed=0, T=5):
    """The same random stacked step outputs for both packages."""
    rng = np.random.default_rng(seed)
    R, t = _poses(T, seed)
    a = dict(num_keypoints=rng.integers(0, 1200, T).astype(np.int32),
             num_matches=rng.integers(0, 500, T).astype(np.int32),
             num_inliers=rng.integers(0, 400, T).astype(np.int32),
             num_valid_points=rng.integers(0, 400, T).astype(np.int32),
             pose_ok=rng.random(T) > 0.5, scale=rng.choice([0.0, 0.3], T).astype(np.float32),
             epipolar_residual=rng.random(T).astype(np.float32),
             F=rng.normal(size=(T, 3, 3)).astype(np.float32), has_F=rng.random(T) > 0.3)
    port = VOStepOutput(pose=Pose(torch.from_numpy(R).float(), torch.from_numpy(t).float()),
                        **{k: torch.from_numpy(v) for k, v in a.items()})
    ref = JVOStepOutput(pose=JPose(jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32)),
                        **{k: jnp.asarray(v) for k, v in a.items()})
    return port, ref


def test_records_match_tpu_vo(tmp_path):
    port, ref = _outputs()
    mine, theirs = records.sequence_records(port), jrecords.sequence_records(ref)
    assert mine == theirs
    assert [records.format_reference_style(r) for r in mine] == \
        [jrecords.format_reference_style(r) for r in theirs]
    for name in ("write_jsonl", "write_csv"):
        getattr(records, name)(str(tmp_path / "a"), mine)
        getattr(jrecords, name)(str(tmp_path / "b"), theirs)
        assert open(tmp_path / "a").read() == open(tmp_path / "b").read()


def test_metrics_match_tpu_vo(tmp_path):
    R, t = _poses(8, 1)
    R2, t2 = _poses(8, 2)
    for name, args in (("ate_rmse", (t, t2)), ("extent", (t,)), ("scale_matched_gt", (t,)),
                       ("umeyama_alignment", (t, t2)), ("ate_rmse_aligned", (t, t2)),
                       ("rpe", (t, t2)), ("rpe", (t, t2, R, R2)),
                       ("trajectory_report", (t, t2, 3 * t2, R, R2, R))):
        a, b = getattr(metrics, name)(*args), getattr(jmetrics, name)(*args)
        if name == "umeyama_alignment":
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, name
    kitti, tum = str(tmp_path / "gt.txt"), str(tmp_path / "gt_tum.txt")
    jtraj.save_trajectory_kitti(kitti, JPose(jnp.asarray(R2), jnp.asarray(t2)))
    jtraj.save_trajectory_tum(tum, JPose(jnp.asarray(R2), jnp.asarray(t2)))
    est = Pose(torch.from_numpy(R), torch.from_numpy(t))
    for gt in (kitti, tum):
        for align in ("scale", "rigid", "none"):
            got = metrics.evaluate_against_file(est, gt, align)
            want = jmetrics.evaluate_against_file(JPose(jnp.asarray(R), jnp.asarray(t)), gt,
                                                  align)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k] == pytest.approx(want[k], abs=2e-6), (gt, align, k)
