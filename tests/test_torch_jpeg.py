"""The port's baseline JPEG codec (io/jpeg) against libjpeg-turbo as PIL
and cv2 run it on the CPU, bit for bit:

  - quant_table is jpeg_set_quality's table (cv2's DQT);
  - encode_gray writes cv2.imencode's bytes; roundtrip_gray equals
    cv2.imdecode(cv2.imencode(...)) and decode(encode_gray(...)), at
    config 6's qualities (50, 70, 85) and at 10 and 95, on random and
    smooth frames at odd sizes;
  - quantize (libjpeg-turbo's reciprocal multiply) equals rounding
    |coef| / (8 q) half up, sign restored, on every 16-bit coefficient at
    every table entry and on 10^5 random blocks' FDCT outputs;
  - load_frame equals tpu_vo's (PIL) on JPEGs written by PIL and by cv2
    in gray, 4:4:4, 4:2:2, 4:2:0 and 4:4:0, with and without restart
    intervals, at qualities 10, 50 and 95 and odd sizes.
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image
from scipy import ndimage

from tpu_vo.io import dataset as jdataset
from tpu_vo_torch.io import dataset, jpeg

QUALITIES = (10, 50, 70, 85, 95)
SIZES = ((37, 23), (48, 64), (1, 1), (9, 17))
# cv2's IMWRITE_JPEG_SAMPLING_FACTOR values: 4:4:4, 4:2:2, 4:2:0, 4:4:0
CV2_SAMPLING = (0x111111, 0x211111, 0x221111, 0x121111)


def _frames(seed, channels=1):
    """Random and smooth uint8 frames at each size."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in SIZES:
        shape = (h, w) if channels == 1 else (h, w, channels)
        r = rng.integers(0, 256, shape).astype(np.float64)
        sigma = (1.5, 1.5) if channels == 1 else (1.5, 1.5, 0)
        out += [r.astype(np.uint8), ndimage.gaussian_filter(r, sigma).clip(0, 255).astype(np.uint8)]
    return out


def _dqt(data: bytes) -> np.ndarray:
    """The first 8-bit quantisation table of a JPEG, natural order."""
    i = data.index(b"\xff\xdb")
    table = np.zeros(64, np.int64)
    table[jpeg.ZIGZAG] = np.frombuffer(data[i + 5:i + 69], np.uint8)
    return table.reshape(8, 8)


@pytest.mark.parametrize("quality", (1, 10, 25, 50, 70, 85, 95, 100))
def test_quant_table_is_cv2s(quality):
    ok, enc = cv2.imencode(".jpg", np.zeros((8, 8), np.uint8), [cv2.IMWRITE_JPEG_QUALITY, quality])
    np.testing.assert_array_equal(jpeg.quant_table(quality), _dqt(enc.tobytes()))


@pytest.mark.parametrize("quality", QUALITIES)
def test_gray_round_trip_equals_cv2(quality):
    for x in _frames(quality):
        ok, enc = cv2.imencode(".jpg", x, [cv2.IMWRITE_JPEG_QUALITY, quality])
        want = cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE)
        rt = jpeg.roundtrip_gray(x, quality)
        np.testing.assert_array_equal(rt, want, err_msg=f"roundtrip_gray {x.shape}")
        data = jpeg.encode_gray(x, quality)
        assert data == enc.tobytes(), f"encode_gray's bytes differ from cv2's at {x.shape}"
        np.testing.assert_array_equal(jpeg.decode(data), rt)
        np.testing.assert_array_equal(
            cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE), rt)


def test_round_trip_on_a_frame_of_config_6s_pan_width():
    x = ndimage.gaussian_filter(np.random.default_rng(3).uniform(0, 255, (240, 320)), 1.0)
    x = x.astype(np.uint8)
    for quality in (50, 70, 85):
        ok, enc = cv2.imencode(".jpg", x, [cv2.IMWRITE_JPEG_QUALITY, quality])
        np.testing.assert_array_equal(jpeg.roundtrip_gray(x, quality),
                                      cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE))


def test_quantize_equals_rounding_half_up():
    def closed_form(c, q):
        return np.sign(c) * ((np.abs(c) + 4 * q) // (8 * q))

    # every 16-bit coefficient at every table entry
    c = np.arange(-(1 << 15), 1 << 15, dtype=np.int64).reshape(-1, 8, 8)
    for q in range(1, 256):
        np.testing.assert_array_equal(jpeg.quantize(c, np.full((8, 8), q)), closed_form(c, q))
    # 10^5 random and 10^5 smooth blocks through the FDCT, each block with
    # its own random table
    rng = np.random.default_rng(0)
    n = 100_000
    noise = rng.integers(0, 256, (n, 8, 8)) - 128
    smooth = np.cumsum(rng.integers(-9, 10, (n, 8, 8)), -1).clip(-128, 127)
    for blocks in (noise, smooth):
        coefs = jpeg.fdct_islow(blocks)
        tables = rng.integers(1, 256, (n, 8, 8))
        np.testing.assert_array_equal(jpeg.quantize(coefs, tables), closed_form(coefs, tables))


def _jpeg_bytes_pil(img, quality, subsampling, restart):
    buf = io.BytesIO()
    kw = {"quality": quality}
    if img.ndim == 3:
        kw["subsampling"] = subsampling
    if restart:
        kw["restart_marker_blocks"] = restart
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _jpeg_bytes_cv2(img, quality, sampling, restart):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    return cv2.imencode(".jpg", img, params)[1].tobytes()


@pytest.mark.parametrize("quality", (10, 50, 95))
@pytest.mark.parametrize("writer", ["pil", "cv2"])
def test_load_frame_equals_tpu_vo_on_baseline_jpegs(tmp_path, writer, quality):
    """Gray and color JPEGs at every sampling of the writer, with and
    without restart intervals: the port's load_frame (gray and RGB)
    equals tpu_vo's, and decode equals PIL's own pixels."""
    if writer == "pil":
        write, samplings, restarts = _jpeg_bytes_pil, ("4:4:4", "4:2:2", "4:2:0"), (0, 1, 3)
    else:
        write, samplings, restarts = _jpeg_bytes_cv2, CV2_SAMPLING, (0, 2)
    images = _frames(quality + 1) + _frames(quality + 2, channels=3)
    n = 0
    for img in images:
        for sampling in (samplings if img.ndim == 3 else samplings[:1]):
            for restart in restarts:
                data = write(img, quality, sampling, restart)
                path = str(tmp_path / f"{n}.jpg")
                n += 1
                with open(path, "wb") as f:
                    f.write(data)
                with Image.open(path) as im:
                    want = np.asarray(im)
                np.testing.assert_array_equal(jpeg.decode(data, path), want, err_msg=path)
                for gray in (True, False):
                    np.testing.assert_array_equal(dataset.load_frame(path, gray),
                                                  jdataset.load_frame(path, gray),
                                                  err_msg=f"{path} {img.shape} {sampling}")


def test_color_jpeg_at_config_6s_sizes(tmp_path):
    """A smooth 4:2:0 frame of the pan's size, where the fancy upsampler's
    interior and edges both count."""
    rng = np.random.default_rng(9)
    img = ndimage.gaussian_filter(rng.uniform(0, 255, (240, 320, 3)), (2, 2, 0)).astype(np.uint8)
    path = str(tmp_path / "pan.jpg")
    Image.fromarray(img).save(path, quality=90)
    np.testing.assert_array_equal(dataset.load_frame(path), jdataset.load_frame(path))


def test_adobe_rgb_and_component_ids(tmp_path):
    """A 3-component JPEG without JFIF whose ids are 'R', 'G', 'B' is RGB
    to libjpeg; with ids 1, 2, 3 it is YCbCr."""
    img = _frames(5, channels=3)[3]
    data = _jpeg_bytes_cv2(img, 90, 0x111111, 0)
    a, b = data.index(b"\xff\xe0"), data.index(b"\xff\xdb")
    no_jfif = data[:a] + data[b:]
    sof = no_jfif.index(b"\xff\xc0")
    for ids in (b"RGB", bytes([1, 2, 3])):
        body = bytearray(no_jfif)
        for k in range(3):
            body[sof + 10 + 3 * k] = ids[k]
        sos = bytes(body).index(b"\xff\xda")
        for k in range(3):
            body[sos + 5 + 2 * k] = ids[k]
        path = str(tmp_path / f"{ids.hex()}.jpg")
        with open(path, "wb") as f:
            f.write(bytes(body))
        for gray in (True, False):
            np.testing.assert_array_equal(dataset.load_frame(path, gray),
                                          jdataset.load_frame(path, gray))


def test_corrupt_jpegs_raise_naming_the_file(tmp_path):
    data = _jpeg_bytes_cv2(_frames(4)[1], 80, 0, 2)
    sos = data.index(b"\xff\xda")
    for name, bad in (("cut_header.jpg", data[:sos - 30]), ("cut_scan.jpg", data[:sos + 40]),
                      ("no_frame.jpg", b"\xff\xd8\xff\xd9")):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(bad)
        with pytest.raises(ValueError, match=name):
            dataset.load_frame(path)


_NO_IMAGING = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpu_vo", "tools", "cv2", "PIL"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
from tpu_vo_torch.io import dataset, jpeg
from tpu_vo_torch.utils import synthetic
frame = dataset.load_frame(sys.argv[1])
assert frame.shape == (37, 23)
assert np.array_equal(jpeg.decode(jpeg.encode_gray(frame, 70)), jpeg.roundtrip_gray(frame, 70))
out = synthetic.apply_photometric_nuisances([frame] * 2, seed=1)
assert out[1].shape == frame.shape
print("ok")
"""


def test_codecs_and_nuisances_run_without_cv2_pil_or_jax(tmp_path):
    """The card host has neither cv2 nor PIL: the reader, the codec and
    the degradation run with both blocked (and jax)."""
    import subprocess
    import sys

    path = str(tmp_path / "f.jpg")
    Image.fromarray(_frames(11, channels=3)[1]).save(path, quality=80)
    out = subprocess.run([sys.executable, "-c", _NO_IMAGING, path], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
