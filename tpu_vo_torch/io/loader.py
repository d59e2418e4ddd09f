"""Decode ahead and upload ahead (port of tpu_vo/io/loader.py).

The reference loads and processes frames strictly one after the other
(main.cpp:128-193: imread, process, render). Here the decode of frame
i + k and its upload overlap the work on frame i: PrefetchLoader decodes
on the native loader's threads (io/native_loader, its codecs in csrc/)
when it can, else on one Python thread (io/dataset.load_frame), and
uploads through pipeline/upload.upload_ahead (pinned ring, side stream).
load_sequence_array stages a whole sequence on the device at once.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_vo_torch.io import native_loader
from tpu_vo_torch.io.dataset import load_frame
from tpu_vo_torch.pipeline.runner import entry_device
from tpu_vo_torch.pipeline.upload import upload_ahead

NATIVE_THREADS = 4


class PrefetchLoader:
    """Iterate (i, path, frame) with the frame already on the device.

    The native loader decodes when the paths form one directory and its
    frame count equals len(paths) (so a cut or resumed list falls back to
    the Python decoder, as in tpu_vo); `decoder` says which runs. An
    unreadable frame is skipped (main.cpp:137). The device comes from
    entry_device(device): the card unless the caller names another.
    Iterate it once.
    """

    def __init__(self, paths: Sequence[str], depth: int = 2, device=None,
                 use_native: bool = True):
        self.paths = list(paths)
        self.depth = max(1, depth)
        self.device = entry_device(device)
        self._native: Optional[native_loader.NativeDataset] = None
        dirs = {os.path.dirname(p) for p in self.paths}
        if use_native and len(dirs) == 1 and native_loader.available():
            try:
                ds = native_loader.NativeDataset(dirs.pop(), n_threads=NATIVE_THREADS,
                                                 depth=2 * self.depth)
            except FileNotFoundError:  # no decodable image in the directory
                ds = None
            if ds is not None and ds.num_frames != len(self.paths):
                ds.close()
                ds = None
            self._native = ds
        self.decoder = "native" if self._native is not None else "python"

    def _decoded(self) -> Iterator[Tuple[Tuple[int, str], Optional[np.ndarray]]]:
        """((i, path), frame or None where it does not decode), in order."""
        if self._native is not None:
            try:
                for i, frame in self._native:
                    yield (i, self.paths[i]), frame
            finally:
                self._native.close()
            return
        for i, p in enumerate(self.paths):
            try:
                frame = load_frame(p)
            except Exception:  # an unreadable image is skipped, as the native route does
                frame = None
            yield (i, p), frame

    def __iter__(self) -> Iterator[Tuple[int, str, torch.Tensor]]:
        for (i, p), frame in upload_ahead(self._decoded(), self.device, self.depth):
            if frame is not None:
                yield i, p, frame


def load_sequence_array(paths: Sequence[str], device=None) -> torch.Tensor:
    """Decode every frame and stage one (T, H, W) uint8 tensor on the
    device (entry_device(device))."""
    frames = [load_frame(p) for p in paths]
    h, w = frames[0].shape
    for p, f in zip(paths, frames):
        if f.shape != (h, w):
            raise ValueError(f"{p}: frame of {f.shape} in a sequence of {(h, w)}")
    return torch.from_numpy(np.stack(frames)).to(entry_device(device))
