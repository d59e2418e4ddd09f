"""One CUDA graph per call signature of an eager function
(estimation/five_point's solver, models/refinement's LM loop).

GraphCache(prefix, body)(*args) is body(*args). Where the first
tensor argument is not on a CUDA device it runs body eagerly. On CUDA it
replays the graph of the call's signature: captured on the signature's
first call (span f"{prefix}.capture"), replayed on every call (span
f"{prefix}.replay"). A replay launches body's kernels with the same
launch parameters, so its outputs are body's bit for bit. A capture that
raises RuntimeError warns and leaves its signature to body. The graphs of
the GRAPHS_KEPT signatures used last are kept, the least recently used
evicted.
"""

from __future__ import annotations

import collections
import threading
import warnings
from typing import Callable, NamedTuple

import torch

from tpu_vo_torch.utils.profiling import span

GRAPHS_KEPT = 8


class _Graph(NamedTuple):
    """One captured call: the static arguments it reads, the outputs it
    writes, the stream its inputs were allocated on, and the event after
    its last use."""

    args: tuple
    out: tuple
    graph: "torch.cuda.CUDAGraph"
    home: "torch.cuda.Stream"
    done: "torch.cuda.Event"


class GraphCache:
    """body's CUDA graphs by signature. Each cache has its own lock and
    its own side stream per device, so that two threads never capture on
    one stream."""

    def __init__(self, prefix: str, body: Callable[..., tuple]):
        self.prefix, self.body, self.kept = prefix, body, GRAPHS_KEPT
        # signature -> _Graph, or None where the capture failed and the
        # signature runs eagerly; the most recently used last
        self.graphs: "collections.OrderedDict[tuple, _Graph | None]" = collections.OrderedDict()
        self._lock = threading.Lock()
        self._side_streams: dict = {}

    @staticmethod
    def signature(*args) -> tuple:
        """Everything the captured work depends on: each tensor's shape,
        strides (the layouts of the intermediates follow them), dtype and
        device, the value of every other argument, and the TF32 flag of
        cuBLAS, which the capture fixes."""
        return (*((tuple(a.shape), a.stride(), a.dtype, a.device)
                  if isinstance(a, torch.Tensor) else a for a in args),
                torch.backends.cuda.matmul.allow_tf32)

    def __call__(self, *args) -> tuple:
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
        if device.type != "cuda":
            return self.body(*args)
        return self._graphed(device, args)

    def _graphed(self, device: torch.device, args: tuple) -> tuple:
        """The call on the device: the signature's graph, captured on its
        first call and replayed on every call; body where the capture
        raised."""
        key = self.signature(*args)
        with self._lock:
            if key in self.graphs:
                self.graphs.move_to_end(key)
                g = self.graphs[key]
            else:
                with span(f"{self.prefix}.capture"):
                    try:
                        g = self._capture(device, args)
                    except RuntimeError as e:
                        warnings.warn(f"{self.prefix}: CUDA graph capture failed, running "
                                      f"{self.body.__name__} eagerly for this signature: {e}")
                        g = None
                self.graphs[key] = g
                while len(self.graphs) > self.kept:
                    old = self.graphs.popitem(last=False)[1]
                    if old is not None:
                        old.home.wait_event(old.done)   # its inputs are freed on home
            if g is not None:
                with span(f"{self.prefix}.replay"):
                    return self._replay(device, g, args)
        return self.body(*args)

    def _capture(self, device: torch.device, args: tuple) -> _Graph:
        """Run body once on a side stream of the device, which fills the
        constants' caches and cuBLAS's workspace for that stream, then
        capture it there into static inputs shaped and strided as the
        caller's. Only this thread's calls are checked during the capture
        (capture_error_mode="thread_local"), so an upload thread may go on."""
        home = torch.cuda.current_stream(device)
        if device not in self._side_streams:
            self._side_streams[device] = torch.cuda.Stream(device)
        side = self._side_streams[device]
        static = tuple(torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device=a.device)
                       if isinstance(a, torch.Tensor) else a for a in args)
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(home)
        try:
            with torch.cuda.stream(side):
                self.body(*args)
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = self.body(*static)
                finally:
                    graph.capture_end()
        finally:
            home.wait_stream(side)      # the inputs are freed on home, after the side's reads
        return _Graph(static, out, graph, home, torch.cuda.Event())

    def _replay(self, device: torch.device, g: _Graph, args: tuple) -> tuple:
        """Copy the inputs in, replay, and clone the outputs, on the
        caller's current stream and without waiting for the device: the
        clones are the caller's, and the next replay writes only the
        graph's own."""
        stream = torch.cuda.current_stream(device)
        stream.wait_event(g.done)       # the last replay, on whatever stream, has read its inputs
        for static, a in zip(g.args, args):
            if isinstance(a, torch.Tensor):
                static.copy_(a)
        g.graph.replay()
        out = tuple(t.clone() for t in g.out)
        g.done.record(stream)
        return out
