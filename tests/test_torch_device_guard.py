"""Every kernel wrapper of tpu_vo_torch.ops launches on the device of the
tensors it is given: it enters torch.cuda.device(tensor.device) around
the launch and takes that device's current stream. Checked on the CPU
with the launcher library and torch.cuda's device guard and stream
mocked: each wrapper's CUDA path runs on CPU tensors, and the mock
records which device was current when the launcher was called."""

import contextlib

import pytest
import torch

from tpu_vo_torch.ops import _build, describe, fast, patch, patch_probe, select
from _torch_threads import _one_thread  # noqa: F401


class _Recorder:
    """Stands in for the kernel library: every C entry point records the
    device that torch.cuda.device made current and returns 0."""

    def __init__(self):
        self.current = None
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("tvo_"):
            raise AttributeError(name)

        def launch(*args):
            self.calls.append((name, self.current, args[-1]))
            return 0
        return launch


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    streams = []

    @contextlib.contextmanager
    def device(d):
        before, rec.current = rec.current, d
        try:
            yield
        finally:
            rec.current = before

    class _Stream:
        def __init__(self, d):
            streams.append(d)
            self.cuda_stream = 1000 + len(streams)

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    monkeypatch.setattr(_build, "library", lambda: rec)
    rec.streams = streams
    return rec


def _levels():
    return [torch.zeros(2, 64, 300), torch.zeros(2, 53, 250)]


def _keypoints(n=6):
    return torch.zeros((2, n), dtype=torch.int32), torch.zeros((2, n), dtype=torch.int32)


_WRAPPERS = {
    "select_maps_levels (B1)": lambda: select._select_maps_cuda(_levels(), 10, 31),
    "extract_patches_levels (B2)": lambda: patch._extract_patches_cuda(
        _levels(), *_keypoints(), [0, 3]),
    "fast_margin_levels (B3)": lambda: fast._fast_margin_cuda(_levels(), 10),
    "band_windows (P1)": lambda: patch_probe._launch(
        patch_probe.band_windows, "tvo_band_windows", _levels()[0], *_keypoints(), 2, 64,
        300, 6, 8, 2, 2, 1, 256),
    "describe_windows": lambda: describe._describe_cuda(torch.zeros(2, 6, 43, 43)),
    "phase_windows (P2, P3)": lambda: patch_probe._launch(
        patch_probe.phase_windows_roll, "tvo_phase_windows", _levels()[0], *_keypoints(), 2,
        64, 300, 6, 8, 2, 2, 1),
}


@pytest.mark.parametrize("name", list(_WRAPPERS))
def test_each_wrapper_launches_inside_the_tensors_device_guard(recorder, name):
    _WRAPPERS[name]()
    assert len(recorder.calls) == 1
    entry, current, stream = recorder.calls[0]
    assert entry.startswith("tvo_")
    assert current == torch.device("cpu")  # the tensors' device, entered for the launch
    assert recorder.streams == [torch.device("cpu")]  # the stream of that device
    assert stream == 1001
    assert recorder.current is None  # and left after it
