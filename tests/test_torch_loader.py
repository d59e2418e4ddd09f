"""The port's ingest path on the CPU: the native loader's binding
(io/native_loader), PrefetchLoader and load_sequence_array (io/loader)
and the CLI reading through them, against tpu_vo's PIL decoder and
loader:

  - native decode equals tpu_vo's load_frame (PIL) and the port's own
    load_frame bit for bit: gray, RGB and RGBA PNGs with each row filter,
    gray and RGB JPEGs; gray 8, RGB 8, palette, gray-alpha and 16-bit RGB
    PNGs, Adam7-interlaced and not, and a PrefetchLoader over a directory
    of interlaced files (the port's copy of the loader reads Adam7 whole;
    the JAX package's native/vo_loader.cpp does not);
  - prefetch order, an unreadable frame skipped, the pack round trip, a
    missing directory;
  - six processes' first uses build the library once into one fresh
    directory, and all of them load it; a failed build raises with the
    compiler's output and PrefetchLoader falls back to the Python decoder;
  - PrefetchLoader(device="cpu"), native or not, yields what tpu_vo's
    PrefetchLoader(use_native=False) yields;
  - the CLI runs a JPEG directory through the native loader;
  - tools/io_bench gives every row at a small size.

The native loader needs g++ and nothing else: its tests never skip, and
a build that fails is a failure. The build command names no library but
pthread, and no source in csrc/ includes png.h, jpeglib.h or zlib.h.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from tpu_vo.io import dataset as jdataset, loader as jloader
from tpu_vo_torch import cli
from tpu_vo_torch.configs import ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.io import dataset, loader, native_loader
from tpu_vo_torch.io.kitti import load_kitti_poses
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.tools import io_bench
from tpu_vo_torch.utils.synthetic import make_sequence

from test_torch_png_variants import write_png_any

CHANNELS = {"gray": 1, "rgb": 3, "rgba": 4}
N, W, H = 6, 64, 48
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: under xdist every worker
    would otherwise start a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def native():
    """The native library, built here if need be."""
    return native_loader.get_lib()


def test_build_needs_no_image_or_compression_library():
    """g++ links pthread alone, every file the build reads is hashed into
    the library's name, and no source includes a codec library's header."""
    cmd = native_loader.build_command("out.so")
    assert [a for a in cmd if a.startswith("-l")] == ["-lpthread"]
    compiled = {a for a in cmd if a.endswith(".cpp")}
    assert compiled == {p for p in native_loader.sources() if p.endswith(".cpp")}
    csrc = native_loader.CSRC
    assert set(native_loader.sources()) >= {os.path.join(csrc, n) for n in os.listdir(csrc)
                                            if n.endswith((".cpp", ".h"))}
    for name in os.listdir(csrc):
        with open(os.path.join(csrc, name)) as f:
            includes = [ln for ln in f if ln.lstrip().startswith("#include")]
        for header in ("png.h", "jpeglib.h", "zlib.h"):
            assert not any(header in ln for ln in includes), (name, header)


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """N frames of a synthetic sequence as PNG files, the row filters in turn."""
    d = str(tmp_path_factory.mktemp("frames"))
    frames = make_sequence(n_frames=N, width=W, height=H, seed=4)[0]
    for i, f in enumerate(frames):
        dataset.write_png(os.path.join(d, f"{i:06d}.png"), f, filter_type=i % 5)
    return d, np.stack(frames)


def _image(channels, seed=0, h=29, w=37):
    """Random pixels with a flat run, so that every filter meets equal and
    unequal neighbours."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w) if channels == 1 else (h, w, channels), dtype=np.uint8)
    img[3:9, 2:20] = img[3, 2]
    return img


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("kind", CHANNELS)
def test_native_png_decode_matches_pil_and_port(native, tmp_path, kind, filter_type):
    path = str(tmp_path / f"{kind}.png")
    dataset.write_png(path, _image(CHANNELS[kind], seed=filter_type), filter_type)
    ds = native_loader.NativeDataset(str(tmp_path))
    got = ds.read(0)
    ds.close()
    np.testing.assert_array_equal(got, jdataset.load_frame(path))
    np.testing.assert_array_equal(got, dataset.load_frame(path))


@pytest.mark.parametrize("kind", ["gray", "rgb"])
def test_native_jpeg_decode_matches_pil(native, tmp_path, kind):
    smooth = np.cumsum(_image(CHANNELS[kind], seed=7, h=240, w=320).astype(np.int64), 1)
    img = (smooth * 255 // max(int(smooth.max()), 1)).astype(np.uint8)
    path = str(tmp_path / f"{kind}.jpg")
    Image.fromarray(img).save(path, quality=85)
    with native_loader.NativeDataset(str(tmp_path)) as ds:
        (i, got), = list(ds)
    assert i == 0 and got.shape == (240, 320)
    np.testing.assert_array_equal(got, jdataset.load_frame(path))
    np.testing.assert_array_equal(got, dataset.load_frame(path))


# (color type, bit depth) of each kind; 16-bit RGB since PIL keeps its high
# byte as libpng's strip does (16-bit gray PIL clips to 255 instead)
ADAM7_KINDS = {"gray8": (0, 8), "rgb8": (2, 8), "palette": (3, 8), "gray_alpha": (4, 8),
               "rgb16": (2, 16)}


def _write_kind(path, kind, seed, interlace, h=29, w=37):
    ctype, depth = ADAM7_KINDS[kind]
    rng = np.random.default_rng(seed)
    channels = {0: 1, 2: 3, 3: 1, 4: 2}[ctype]
    samples = rng.integers(0, 1 << depth, (h, w) if channels == 1 else (h, w, channels))
    samples[3:9, 2:20] = samples[3, 2]
    palette = rng.integers(0, 256, (256, 3)) if ctype == 3 else None
    write_png_any(path, samples, ctype, depth, palette, interlace=interlace, ftype=seed % 5)


@pytest.mark.parametrize("interlace", [True, False])
@pytest.mark.parametrize("kind", ADAM7_KINDS)
def test_native_adam7_png_matches_pil(native, tmp_path, kind, interlace):
    path = str(tmp_path / f"{kind}.png")
    _write_kind(path, kind, seed=len(kind), interlace=interlace)
    with native_loader.NativeDataset(str(tmp_path)) as ds:
        got = ds.read(0)
    assert got is not None, f"the native loader did not decode {kind} (interlace={interlace})"
    np.testing.assert_array_equal(got, jdataset.load_frame(path))
    np.testing.assert_array_equal(got, dataset.load_frame(path))


def test_prefetch_loader_reads_an_adam7_directory_natively(native, tmp_path):
    for i, kind in enumerate([*ADAM7_KINDS, "gray8"]):
        _write_kind(str(tmp_path / f"{i:06d}.png"), kind, seed=i, interlace=True)
    paths = dataset.list_image_paths(str(tmp_path))
    pl = loader.PrefetchLoader(paths, device="cpu")
    got = [(i, t.numpy()) for i, _, t in pl]
    assert pl.decoder == "native"
    assert [i for i, _ in got] == list(range(len(paths)))
    for (_, frame), path in zip(got, paths):
        np.testing.assert_array_equal(frame, jdataset.load_frame(path))


def test_prefetch_streams_in_order(native, frames_dir):
    path, frames = frames_dir
    with native_loader.NativeDataset(path, n_threads=3, depth=4) as ds:
        assert (ds.num_frames, ds.width, ds.height) == (N, W, H)
        seen = list(ds)
    assert [i for i, _ in seen] == list(range(N))
    np.testing.assert_array_equal(np.stack([f for _, f in seen]), frames)


@pytest.mark.parametrize("use_native", [True, False])
def test_unreadable_frame_is_skipped(native, frames_dir, tmp_path, use_native):
    src, frames = frames_dir
    for i, f in enumerate(frames):
        dataset.write_png(str(tmp_path / f"{i:06d}.png"), f)
    with open(tmp_path / "000002.png", "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n not an image")
    with native_loader.NativeDataset(str(tmp_path)) as ds:
        assert ds.read(2) is None
        assert [i for i, _ in ds] == [0, 1, 3, 4, 5]
    paths = dataset.list_image_paths(str(tmp_path))
    pl = loader.PrefetchLoader(paths, device="cpu", use_native=use_native)
    assert pl.decoder == ("native" if use_native else "python")
    got = list(pl)
    assert [(i, p) for i, p, _ in got] == [(i, paths[i]) for i in (0, 1, 3, 4, 5)]
    for i, _, t in got:
        assert t.device.type == "cpu" and t.dtype == torch.uint8
        np.testing.assert_array_equal(t.numpy(), frames[i])


def test_pack_round_trip(native, frames_dir, tmp_path):
    path, frames = frames_dir
    pack = str(tmp_path / "seq.vobin")
    assert native_loader.pack_dataset(path, pack) == N
    with native_loader.PackedSequence(pack) as ps:
        assert (ps.num_frames, ps.height, ps.width) == (N, H, W)
        np.testing.assert_array_equal(ps.read(), frames)
        np.testing.assert_array_equal(ps.read(2, 3), frames[2:5])
        with pytest.raises(RuntimeError, match="pack read"):
            ps.read(4, 3)


def test_missing_paths_raise(native, tmp_path):
    with pytest.raises(FileNotFoundError):
        native_loader.NativeDataset(str(tmp_path / "nonexistent_dir"))
    with pytest.raises(FileNotFoundError):
        native_loader.PackedSequence(str(tmp_path / "nonexistent.vobin"))


_FIRST_USE = r"""
import sys
from tpu_vo_torch.io import native_loader
native_loader.BUILD_DIR = sys.argv[1]
ok = native_loader.available()
print(ok, native_loader.library_path(), native_loader.unavailable_reason())
"""


def test_concurrent_first_builds_load(native, tmp_path):
    """Six processes whose first use finds no library build it into one
    fresh directory at once: each loads it, one file results, no partial
    file is left."""
    build = str(tmp_path / "build")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_USE, build], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    lines = [o.split() for o, _ in outs]
    assert all(line[0] == "True" for line in lines), outs
    assert len({line[1] for line in lines}) == 1
    so = os.path.basename(lines[0][1])
    assert sorted(os.listdir(build)) == [so, so + ".lock"]


def test_failed_build_raises_and_loader_falls_back(native, frames_dir, tmp_path, monkeypatch,
                                                    capsys):
    broken = tmp_path / "vo_loader.cpp"
    broken.write_text("int vl_open_dataset( {\n")
    monkeypatch.setattr(native_loader, "SRC", str(broken))
    monkeypatch.setattr(native_loader, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="error"):
        native_loader.get_lib()
    assert not native_loader.available()
    assert "vo_loader.cpp" in native_loader.unavailable_reason()
    assert "error" in native_loader.unavailable_reason()
    assert not any(n.endswith((".so", ".tmp")) for n in os.listdir(tmp_path / "build"))
    path, frames = frames_dir
    pl = loader.PrefetchLoader(dataset.list_image_paths(path), device="cpu")
    assert pl.decoder == "python"
    np.testing.assert_array_equal(np.stack([t.numpy() for _, _, t in pl]), frames)
    assert cli.main([path, "--levels", "1", "--features", "50", "--ransac-iters", "8",
                     "--no-viewer", "--device", "cpu", "--quiet",
                     "--out-dir", str(tmp_path / "out")]) == 0
    assert "Decoder: python (native loader unavailable: " in capsys.readouterr().out


@pytest.mark.parametrize("use_native", [True, False])
def test_prefetch_loader_matches_tpu_vo(frames_dir, use_native):
    """tpu_vo's loader runs on PIL (use_native=False), so that this test
    never starts the JAX package's own build of the library."""
    path, _ = frames_dir
    paths = dataset.list_image_paths(path)
    ref = [(i, p, np.asarray(f)) for i, p, f in jloader.PrefetchLoader(paths, use_native=False)]
    pl = loader.PrefetchLoader(paths, depth=3, device="cpu", use_native=use_native)
    got = [(i, p, t.numpy()) for i, p, t in pl]
    assert pl.decoder == ("native" if use_native else "python")
    assert [(i, p) for i, p, _ in got] == [(i, p) for i, p, _ in ref]
    for (_, _, a), (_, _, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    # a cut list is not the directory: the Python decoder, as in tpu_vo
    assert loader.PrefetchLoader(paths[1:], device="cpu").decoder == "python"
    seq = loader.load_sequence_array(paths, device="cpu")
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jloader.load_sequence_array(paths)))


def test_cli_runs_a_jpeg_directory_through_the_native_loader(native, tmp_path, capsys):
    d = tmp_path / "jpeg"
    d.mkdir()
    frames = make_sequence(n_frames=4, width=192, height=144, seed=3)[0]
    for i, f in enumerate(frames):
        Image.fromarray(f).save(d / f"{i:06d}.jpg", quality=95)
    out = str(tmp_path / "out")
    assert cli.main([str(d), "--levels", "2", "--features", "200", "--ransac-iters", "32",
                     "--no-viewer", "--device", "cpu", "--quiet", "--out-dir", out]) == 0
    text = capsys.readouterr().out
    assert "Decoder: native" in text and "Image dimensions: 192 x 144" in text
    R, t = load_kitti_poses(os.path.join(out, "trajectory_kitti.txt"))
    assert R.shape == (4, 3, 3) and np.isfinite(t).all()


def test_io_bench_rows_on_the_cpu(native):
    """tools/io_bench end to end at a small size: every row a rate."""
    rows = io_bench.main(["--frames", "8", "--chunk", "4", "--width", "160", "--height", "120",
                          "--features", "100", "--levels", "2", "--compute-frames", "8",
                          "--reps", "1", "--device", "cpu"])
    assert rows["native"] == "built" and rows["device"] == "cpu"
    for k in ("upload_only_mbps", "upload_only_fps", "compute_only_fps",
              "streamed_host_chunks_fps", "decode_only_fps", "decode_only_python_fps",
              "decode_only_1thread_fps", "native_paeth_ms", "native_jpeg_ms",
              "e2e_png_fps", "e2e_packed_fps", "e2e_decode_fps", "e2e_png_python_fps"):
        assert np.isfinite(rows[k]) and rows[k] > 0, k


@pytest.mark.parametrize("T", [16, 12])
def test_e2e_decode_launches_counts_each_stage_1_call(native, tmp_path, monkeypatch, T):
    """e2e_decode_fps makes e2e_decode_launches(T) stage-1 calls, each one
    launch of B1 and of B2 on the card: 8 frames a call where 8 divides
    the chunk (T 16), else the whole chunk (T 12)."""
    for i, f in enumerate(make_sequence(n_frames=T, width=96, height=72, seed=2)[0]):
        dataset.write_png(str(tmp_path / f"{i:06d}.png"), f)
    calls = []
    detect = runner.detect_and_compute

    def counted(frames, ocfg):
        calls.append(frames.shape[0])
        return detect(frames, ocfg)

    monkeypatch.setattr(runner, "detect_and_compute", counted)
    cfg = VOConfig(image_width=96, image_height=72, orb=ORBConfig(n_features=50, n_levels=1),
                   ransac=RansacConfig(max_iters=8))
    assert io_bench.e2e_decode_fps(str(tmp_path), T, cfg, torch.device("cpu")) > 0
    assert len(calls) == io_bench.e2e_decode_launches(T)
    assert set(calls) == ({8} if T % 8 == 0 else {T})
